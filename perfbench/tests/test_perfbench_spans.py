"""The readers of the program's spans: each reads a number from a whole CPU
run of its cell (the two timed on the device read nothing without a card),
and none from a window whose spans the ring dropped, or from a program
without the recorder."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from perfbench.harness import manifest, runner
from perfbench.tests import tiny

SEED = 2**31 + 4242
CHAT = ["iteration_s.rag", "queue_wait_s.rag", "prefill_wait_s.rag", "piece_device_ms.rag",
        "step_device_ms.rag", "decode_yield.rag"]
SEARCH = ["tokenize_ms.search", "bert_ms.search", "scan_ms.search", "assemble_ms.search"]
DEVICE = {"piece_device_ms.rag", "step_device_ms.rag"}


def test_entries_name_the_readers():
    bench = manifest.load()
    for cell, names in (("chat7b-rag", CHAT), ("search1m-ivf8", SEARCH)):
        entries = {m["name"]: m for m in manifest.metrics(bench, cell, True)}
        for name in names:
            assert entries[name]["source"] == "program_span" and manifest.reader(name)


@pytest.mark.parametrize("make,names", [(tiny.chat, CHAT), (tiny.search, SEARCH)],
                         ids=["chat", "search"])
def test_readers_read_a_cpu_run(make, names):
    cell, cfg, traffic = make()
    _, run, _ = runner.run_cell(cell, cfg, traffic, SEED, 6.0, False, device="cpu",
                                t_process=time.time())
    got = {name: manifest.reader(name)(run) for name in names}
    for name, v in got.items():
        if name in DEVICE:
            assert v is None, name                  # no card: no stream time
        else:
            assert isinstance(v, float) and v > 0, (name, v)
    if "decode_yield.rag" in got:
        assert got["decode_yield.rag"] <= 100.0
        assert got["iteration_s.rag"] < run.seconds
    else:
        wrapper = (run.c1["batch_s"] - run.c0["batch_s"]) / (
            run.c1["batch_calls"] - run.c0["batch_calls"])
        assert max(got.values()) < wrapper * 1e3    # each stage sits inside the store's call


def test_readers_read_nothing_past_a_drop(monkeypatch):
    from mediquery_rag_tpu_torch.obs import tracing

    w1 = time.perf_counter()
    run = SimpleNamespace(w0=w1 - 1.0, w1=w1, cfg={"slots": 4})
    base = round(run.w0 * 1e9) + time.time_ns() - time.perf_counter_ns()
    read = manifest.reader("iteration_s.rag")

    def ring(capacity):
        rec = tracing.Recorder(capacity=capacity)
        for i in range(6):
            start = base + (i + 1) * 100_000_000
            rec.record("llm.tick", start, start + 50_000_000)
        monkeypatch.setattr(tracing, "window", rec.window)

    ring(16)
    assert read(run) == pytest.approx(0.05)
    ring(4)                                         # two of the window's six dropped
    assert read(run) is None
    monkeypatch.delattr(tracing, "window")          # a program without the recorder
    assert read(run) is None
