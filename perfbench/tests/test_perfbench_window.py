"""Window arithmetic and the closed loop's counts."""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.harness import manifest, window
from perfbench.harness.closed_loop import ClosedLoop, Record


@pytest.mark.parametrize("t0,t1,expect", [
    (0.0, 10.0, 50.0),      # half of [0, 10] lies in [5, 15]
    (6.0, 8.0, 100.0),      # wholly inside
    (20.0, 30.0, 0.0),      # after the window
    (0.0, 4.0, 0.0),        # before it
    (4.0, 16.0, 100 * 10 / 12),
])
def test_prorated(t0, t1, expect):
    assert window.prorated(100, t0, t1, 5.0, 15.0) == pytest.approx(expect)


def test_prorated_instant():
    assert window.prorated(7, 6.0, 6.0, 5.0, 15.0) == 7
    assert window.prorated(7, 15.0, 15.0, 5.0, 15.0) == 0


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = rng.exponential(size=n).tolist()
        for q in (50, 90, 95):
            assert window.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert window.percentile([], 90) is None


def _reader(name):
    return manifest.reader(name)


def _run(records, w0=10.0, w1=20.0):
    return SimpleNamespace(records=records, w0=w0, w1=w1, seconds=w1 - w0)


def test_tokens_and_ttft_over_all_requests():
    recs = [Record(0, {}, t_send=1.0, t_first=8.0, t_done=12.0, ok=True, n_out=40),
            Record(1, {}, t_send=9.0, t_first=11.0, t_done=19.0, ok=True, n_out=80),
            Record(2, {}, t_send=15.0, t_first=19.5, t_done=29.5, ok=True, n_out=100)]
    run = _run(recs)
    # 40 * 2/4 + 80 + 100 * 0.5/10 over 10 s
    assert _reader("output_tok_per_s")(run) == pytest.approx((20 + 80 + 5) / 10)
    # first tokens at 11.0 and 19.5 fall in the window: ttft 2.0 and 4.5
    assert _reader("ttft_p90_s.rag")(run) == pytest.approx(2.0 + 0.9 * 2.5)


def test_search_counts():
    recs = [Record(i, {}, t_send=9.0 + i, t_first=9.5 + i, t_done=9.5 + i, ok=True)
            for i in range(12)]
    run = _run(recs)
    assert _reader("search_qps")(run) == pytest.approx(10 / 10)
    assert _reader("search_p95_ms.search")(run) == pytest.approx(500.0)


class _Echo:
    """A server that answers each request after ``delay`` on its own thread."""

    def __init__(self, delay):
        self.delay, self.q, self.open, self.most = delay, queue.Queue(), 0, 0
        self.lock = threading.Lock()
        self.t = threading.Thread(target=self._loop, daemon=True)
        self.t.start()

    def submit(self, req):
        f = Future()
        with self.lock:
            self.open += 1
            self.most = max(self.most, self.open)
        self.q.put((req, f))
        return f

    def _loop(self):
        while True:
            req, f = self.q.get()
            if req is None:
                return
            time.sleep(self.delay)
            with self.lock:
                self.open -= 1
            f.set_result(req["i"])

    def outcome(self, rec, fut, t):
        return {"ok": fut.result() == rec.req["i"], "t_first": t, "t_done": t}


def test_closed_loop_counts():
    srv = _Echo(0.002)
    pool = [{"i": i} for i in range(10)]
    loop = ClosedLoop(srv.submit, srv.outcome, pool, clients=3, stagger_s=0.0)
    loop.start()
    assert loop.wait_completed(30, timeout=30)
    assert srv.most <= 3                      # never more than one open a client
    assert not loop.drain(timeout=30)
    srv.q.put((None, None))
    recs = loop.records
    assert all(r.ok for r in recs) and len(recs) >= 30
    assert all(r.req is pool[i % 10] for i, r in enumerate(recs))
    for c in range(3):                       # each client's requests one after another
        mine = [r for r in recs if r.client == c]
        assert all(a.t_done <= b.t_send for a, b in zip(mine, mine[1:]))
