"""A closed loop of clients over ``submit(request) -> Future``.

Each client sends its next request only once its previous one has come
back, so the load is the number of clients, not a rate. Completions are
handled in the future's done-callback (on the system's own worker thread),
which records the times and sends that client's next request: no thread a
client, so the harness adds one process and no threads of its own to the
system under test. Client ``i`` sends its first request ``i * stagger_s``
after the start. Requests are taken from the pool in send order, cycling.

While the loop runs, what it keeps of each request is flat: floats, ints
and tuples of ints in a few lists, none of which the cyclic collector has
to walk, so a window of a hundred thousand requests adds nothing to the
collector's work in the process under test. ``records`` builds the
``Record`` objects, once the run is over.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

FIELDS = ("t_first", "t_done", "ok", "n_out", "payload", "error")


@dataclass
class Record:
    client: int
    req: dict
    t_send: float
    t_first: float | None = None  # first output (a search answer: its completion)
    t_done: float | None = None
    ok: bool | None = None       # None while open
    n_out: int = 0               # output tokens (0 for a search)
    payload: tuple = ()          # what the check compares (tokens, ids)
    error: str | None = None


class ClosedLoop:
    """``outcome(record, future, t_callback)`` turns a finished future into
    the fields of its record: ``ok``, ``t_first``, ``t_done``, ``n_out``,
    ``payload`` (a sequence of ints), ``error``."""

    def __init__(self, submit: Callable, outcome: Callable, pool: list[dict], clients: int,
                 stagger_s: float):
        self._submit = submit
        self._outcome = outcome
        self._pool = pool
        self.clients = clients
        self.stagger_s = stagger_s
        self._client: list[int] = []
        self._t_send: list[float] = []
        self._cols = {f: [] for f in FIELDS}
        self._cv = threading.Condition()
        self._open = 0
        self._completed = 0
        self._sending = True

    def start(self) -> None:
        t0 = time.perf_counter()
        for c in range(self.clients):
            delay = t0 + c * self.stagger_s - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self._send(c)

    def _send(self, client: int) -> None:
        with self._cv:
            if not self._sending:
                return
            i = len(self._t_send)
            self._client.append(client)
            self._t_send.append(time.perf_counter())
            for col in self._cols.values():
                col.append(None)
            self._cols["n_out"][i] = 0
            self._open += 1
        try:
            fut = self._submit(self._pool[i % len(self._pool)])
        except Exception as e:             # noqa: BLE001 — a refused send is a failure
            self._finish(i, {"ok": False, "t_done": time.perf_counter(),
                             "error": f"submit: {e!r}"}, resend=False)
            return
        fut.add_done_callback(lambda f, i=i: self._done(i, f))

    def _view(self, i: int) -> Record:
        return Record(self._client[i], self._pool[i % len(self._pool)], self._t_send[i],
                      **{f: col[i] for f, col in self._cols.items()})

    def _done(self, i: int, fut) -> None:
        t = time.perf_counter()
        try:
            fields = self._outcome(self._view(i), fut, t)
        except Exception as e:             # noqa: BLE001 — recorded, never raised into the server
            fields = {"ok": False, "t_done": t, "error": repr(e)}
        self._finish(i, fields, resend=True)

    def _finish(self, i: int, fields: dict, resend: bool) -> None:
        if "payload" in fields:
            fields["payload"] = tuple(int(x) for x in fields["payload"])
        with self._cv:
            for k, v in fields.items():
                self._cols[k][i] = v
            self._open -= 1
            self._completed += 1
            self._cv.notify_all()
            again = self._sending and resend
        if again:
            self._send(self._client[i])

    @property
    def completed(self) -> int:
        with self._cv:
            return self._completed

    def wait_completed(self, n: int, timeout: float) -> bool:
        """Block until ``n`` requests have come back; False on timeout."""
        end = time.perf_counter() + timeout
        with self._cv:
            while self._completed < n:
                left = end - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def drain(self, timeout: float) -> int:
        """Stop sending and wait up to ``timeout`` for what is open; returns
        the number still open then."""
        end = time.perf_counter() + timeout
        with self._cv:
            self._sending = False
            while self._open > 0:
                left = end - time.perf_counter()
                if left <= 0:
                    break
                self._cv.wait(left)
            return self._open

    @property
    def records(self) -> list[Record]:
        """Every request sent, in send order, as it stands now."""
        with self._cv:
            return [self._view(i) for i in range(len(self._t_send))]
