"""The port's spans, its profiler trace and its native HNSW index, on the CPU.

``obs.tracing``'s recorder: nesting and parent ids, the ring's bound and
drop count, per-name totals, device timing without CUDA, the clock shared
with ``torch.profiler`` and no profiler call while none runs; the spans
``DocumentStore.batch_search`` records and ``metrics_text`` exports.
``obs.capture_trace`` writes a Chrome trace that holds a span and the
operators run inside it; ``native.HNSWIndex`` (the port's build of
``native/hnsw.cpp``) returns the JAX package's labels and scores (within
``SCORE_TOL``) on the same rows and queries, serially and through the
OpenMP batch path.
"""

import glob
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mediquery_rag_tpu.native import HNSWIndex as JHNSW
from mediquery_rag_tpu.native import hnsw_available as jhnsw_available
from mediquery_rag_tpu_torch.native import HNSWIndex, hnsw_available
from mediquery_rag_tpu_torch.obs import capture_trace, span, tracing
from mediquery_rag_tpu_torch.obs.tracing import Recorder

SCORE_TOL = 1e-6


def test_capture_trace_holds_the_annotation(tmp_path):
    a = torch.randn(64, 64)
    with capture_trace(str(tmp_path)) as prof:
        with span("mediquery.search"):
            (a @ a).sum()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "mediquery.search" in names and "aten::mm" in names
    assert any(e.key == "mediquery.search" for e in prof.key_averages())


def test_span_nesting_and_parent_ids():
    rec = Recorder()
    with rec.span("outer", rid=7) as o:
        with rec.span("inner", n=3) as i:
            pass
        rec.record("later", 10, 20, rid=7, n=2)
    seen = threading.Event()

    def other():
        with rec.span("thread"):
            seen.set()

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert seen.is_set() and not t.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert got["outer"].parent is None and got["outer"].rid == 7
    assert got["inner"].parent == o.sid == got["outer"].sid and got["inner"].n == 3
    assert got["later"].parent == o.sid and got["later"][:3] == ("later", 10, 20)
    assert got["thread"].parent is None          # another thread's stack
    assert i.sid != o.sid and got["inner"].start_ns >= got["outer"].start_ns
    assert got["inner"].end_ns <= got["outer"].end_ns
    assert all(s.device_s is None for s in got.values())


def test_ring_bound_drop_count_and_window():
    rec = Recorder(capacity=8)
    for i in range(12):
        rec.record("s", 100 * i, 100 * i + 50)
    kept = rec.spans()
    assert len(kept) == 8 and rec.dropped == 4
    assert [s.start_ns for s in kept] == [100 * i for i in range(4, 12)]
    assert rec.dropped_end_ns == 350
    assert [s.start_ns for s in rec.window(400, 800)] == [400, 500, 600, 700]
    assert rec.window(300, 800) is None          # a dropped record ended at 350
    assert rec.totals()["s"]["count"] == 12      # totals keep what the ring drops


def test_per_name_totals():
    rec = Recorder()
    for n in (2, 5):
        rec.record("a", 0, 1_000_000, n=n)
    with rec.span("b", n=1):
        time.sleep(0.002)
    t = rec.totals()
    assert t["a"] == {"count": 2, "host_s": 0.002, "device_s": 0.0, "n": 7}
    assert t["b"]["count"] == 1 and t["b"]["n"] == 1 and t["b"]["host_s"] >= 0.002


def test_device_span_without_cuda_reads_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_stream", no_cuda)
    rec = Recorder()
    for dev in (True, "cuda", torch.device("cpu")):
        with rec.span("d", device=dev):
            pass
    assert [s.device_s for s in rec.spans()] == [None] * 3
    assert rec.totals()["d"]["device_s"] == 0.0


def test_no_profiler_call_while_none_runs(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda *a: calls.append("nvtx"))
    rec = Recorder()
    with rec.span("quiet"):
        pass
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("loud"):
            pass
    assert calls == ["loud"]            # without CUDA: no NVTX range


def test_span_shares_the_profilers_clock(tmp_path):
    """A span's ring record and its ``record_function`` event in
    ``prof.events()`` agree within 1 ms (on ``time.time_ns``)."""
    a = torch.randn(128, 128)
    with capture_trace(str(tmp_path)) as prof:
        with span("warm"):              # the profiler's first record_function is slow
            pass
        with span("clock.check"):
            for _ in range(20):
                a = torch.tanh(a @ a)
        time.sleep(0.005)
    rec = [s for s in tracing.spans() if s.name == "clock.check"][-1]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ev = [e for e in prof.events() if e.name == "clock.check"]
    assert len(ev) == 1
    start = t0 + ev[0].time_range.start * 1e3
    end = t0 + ev[0].time_range.end * 1e3
    assert abs(start - rec.start_ns) < 1e6 and abs(end - rec.end_ns) < 1e6


def test_spans_from_many_threads_lose_no_update():
    """Eight threads record into one recorder under a short switch
    interval: every record is counted, kept or dropped."""
    rec = Recorder(capacity=4096)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(1000):
                with rec.span("w", n=1):
                    pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    t = rec.totals()["w"]
    assert t["count"] == t["n"] == 8000
    assert len(rec.spans()) == 4096 and rec.dropped == 8000 - 4096
    assert len({s.sid for s in rec.spans()}) == 4096


def _bert_store(n_docs=40, dim=32):
    """A ``DocumentStore`` over a flat f32 index, embedded by a tiny
    ``BertTextEmbedder`` with random weights, and its texts."""
    from mediquery_rag_tpu_torch.config import BertEmbedderConfig, EngineConfig
    from mediquery_rag_tpu_torch.engine import FlatIndex
    from mediquery_rag_tpu_torch.ingest.parser import Chunk
    from mediquery_rag_tpu_torch.ingest.pipeline import DocumentStore
    from mediquery_rag_tpu_torch.models.hf_import import BertTextEmbedder
    from mediquery_rag_tpu_torch.models.wordpiece_tokenizer import WordPieceTokenizer

    texts = [f"高血压 第{i}条 饮食与运动" for i in range(n_docs)]
    chars = sorted({c for t in texts for c in t if not c.isspace()})
    vocab = {p: i for i, p in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars)}
    cfg = BertEmbedderConfig(vocab_size=len(vocab), hidden=dim, layers=1, heads=2,
                             mlp_dim=2 * dim, max_len=64, dtype="float32")
    g = torch.Generator().manual_seed(5)

    def w(*shape, mean=0.0):
        return mean + 0.05 * torch.randn(*shape, generator=g)

    blocks = {"qkv": w(1, dim, 3 * dim), "qkv_b": w(1, 3 * dim),
              "attn_out": w(1, dim, dim), "attn_out_b": w(1, dim),
              "ln1_scale": w(1, dim, mean=1.0), "ln1_bias": w(1, dim),
              "wi": w(1, dim, 2 * dim), "bi": w(1, 2 * dim), "wo": w(1, 2 * dim, dim),
              "bo": w(1, dim), "ln2_scale": w(1, dim, mean=1.0), "ln2_bias": w(1, dim)}
    params = {"tok_embed": w(len(vocab), dim), "pos_embed": w(64, dim),
              "type_embed": w(2, dim), "emb_ln_scale": w(dim, mean=1.0),
              "emb_ln_bias": w(dim), "blocks": blocks}
    emb = BertTextEmbedder(cfg, params, WordPieceTokenizer(vocab, max_len=64))
    chunks = [Chunk(chunk_id=str(i), title=t, content=t, source="test")
              for i, t in enumerate(texts)]
    index = FlatIndex.build(emb(texts), EngineConfig(dim=dim, dtype="float32"), device="cpu")
    return DocumentStore(chunks, index, emb), texts


STORE_SPANS = ("embed.tokenize", "embed.forward", "store.scan", "store.assemble")


def test_batch_search_records_its_stages():
    store, texts = _bert_store()
    t0 = time.time_ns()
    for b in (1, 5):
        out = store.batch_search(texts[:b], k=3)
        assert len(out) == b and all(len(r) == 3 for r in out)
    got = [s for s in tracing.window(t0, time.time_ns()) if s.name in STORE_SPANS]
    assert [(s.name, s.n) for s in got] == [(name, b) for b in (1, 5) for name in STORE_SPANS]


def test_metrics_text_exports_span_totals():
    from mediquery_rag_tpu_torch.serve.server import SearchServer

    store, texts = _bert_store()
    srv = SearchServer(store, max_batch=8, max_wait_ms=1.0)
    try:
        assert len(srv.service.search(texts[0], k=2)) == 2
        text = srv.metrics_text()
    finally:
        srv.service.shutdown()
    lines = text.splitlines()
    assert "# TYPE mediquery_search_max_batch_seen gauge" in lines
    assert "# TYPE mediquery_search_batches counter" in lines
    totals = tracing.totals()
    for name in ("search.batch",) + STORE_SPANS:
        assert f'mediquery_spans{{span="{name}"}} {totals[name]["count"]}' in lines
        assert any(x.startswith(f'mediquery_span_seconds{{span="{name}"}} ') for x in lines)
    assert "# TYPE mediquery_span_device_seconds counter" in lines
    assert any(x.startswith("mediquery_spans_dropped ") for x in lines)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("threads", [1, 4])
def test_hnsw_matches_jax(threads):
    assert hnsw_available() and jhnsw_available()
    rng = np.random.default_rng(173)
    rows = _unit(rng.standard_normal((2000, 48)))
    q = _unit(rows[:40] + 0.2 * rng.standard_normal((40, 48)))
    mine, theirs = HNSWIndex(48, M=12, ef_construction=80), JHNSW(48, M=12, ef_construction=80)
    for idx in (mine, theirs):
        idx.add(rows[:1500])
        idx.add(rows[1500:], labels=np.arange(5000, 5500))
    assert mine.size == theirs.size == 2000 and mine.nbytes == theirs.nbytes
    s, i = mine.search(q, k=10, ef=48, threads=threads)
    js, ji = theirs.search(q, k=10, ef=48, threads=threads)
    np.testing.assert_array_equal(i, ji)
    # both libraries are -march=native -ffast-math builds, the JAX package's
    # possibly for another CPU: its dot products may fuse or order the
    # multiply-adds otherwise, a few f32 ulps on scores below 1
    np.testing.assert_allclose(s, js, rtol=0, atol=SCORE_TOL)
    exact = np.argsort(-(q @ rows.T), axis=1, kind="stable")[:, :10]
    exact = np.where(exact >= 1500, exact + 3500, exact)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, exact)]) >= 0.9
