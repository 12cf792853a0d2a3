"""Parity of the port's quantized retrieval path with the JAX package, on the CPU.

The quantizers are byte-equal to JAX's; the int8/int4 scans (the plain
versions of B2/B3 here; JAX runs its Pallas kernels in interpret mode, as
its own tests do) give the same ids and scores; ``FlatIndex`` at int8 and
at int4 with rerank builds, searches, adds, deletes, saves and loads like
JAX's, and each package reloads the other's files; ``host_rerank`` equals
JAX's on both its paths; ``search_stream`` is bit-equal to ``search``; and
``DocumentStore.add_documents`` / ``delete_documents`` match JAX's. Inputs
come from ``np.random.default_rng`` or the repo's corpus.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import EngineConfig as JEngineConfig
from mediquery_rag_tpu.engine import flat as jflat
from mediquery_rag_tpu.ingest import build_document_store as jbuild_store
from mediquery_rag_tpu.ingest.parser import Chunk as JChunk, parse_corpus_file as jparse
from mediquery_rag_tpu.models.lexical import IDFHashingEmbedder as JIDF
from mediquery_rag_tpu.ops import quant as jquant
from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine import flat as tflat
from mediquery_rag_tpu_torch.ingest import (
    Chunk, DocumentStore, build_document_store, parse_corpus_file)
from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
from mediquery_rag_tpu_torch.ops import quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
# Scores: the scans' integer sums are exact and their f32 operations are
# JAX's, so they agree to the last bit on equal inputs; FlatIndex rows are
# normalized by each framework (last-ulp differences in the scales), hence 1e-6.
SCORE_TOL = 1e-6


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("n", [37, 40])
def test_quantizers_byte_equal(n):
    """quantize_rows, quantize_rows_int4 (odd N: phantom row, scale 1.0),
    unpack_int4 and dequantize_int4 give JAX's bytes."""
    x = np.random.default_rng(n).standard_normal((n, 64)).astype(np.float32)
    x[3] = 0.0                                   # the 1e-12 floor
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jf, tf in ((jquant.quantize_rows, quant.quantize_rows),
                   (jquant.quantize_rows_int4, quant.quantize_rows_int4)):
        (jc, js), (tc, ts) = jf(jx), tf(tx)
        np.testing.assert_array_equal(_np(jc), tc.numpy())
        np.testing.assert_array_equal(_np(js), ts.numpy())
    jc, js = jquant.quantize_rows_int4(jx)
    tc, ts = quant.quantize_rows_int4(tx)
    assert tc.shape == (-(-n // 2), 64) and ts.shape == (2, -(-n // 2))
    np.testing.assert_array_equal(_np(jquant.unpack_int4(jc)), quant.unpack_int4(tc).numpy())
    np.testing.assert_array_equal(_np(jquant.dequantize_int4(jc, js, n)),
                                  quant.dequantize_int4(tc, ts, n).numpy())


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("n_valid,k", [(2048, 10), (1333, 40), (5, 10)])
def test_flat_search_matches_jax(dtype, n_valid, k):
    """The scans on the same codes: ids exact (no tie crosses the boundary
    with random rows), scores within SCORE_TOL; ``n_valid`` masks the pad
    rows and short results are (-inf, id 0)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2048, 96)).astype(np.float32)
    x[n_valid:] = 0.0
    q = rng.standard_normal((6, 96)).astype(np.float32)
    if dtype == "int8":
        c, s = jquant.quantize_rows(jnp.asarray(x))
        jfn, tfn = jquant.int8_flat_search, quant.int8_flat_search
    else:
        c, s = jquant.quantize_rows_int4(jnp.asarray(x))
        jfn, tfn = jquant.int4_flat_search, quant.int4_flat_search
    js, ji = jfn(jnp.asarray(q), c, s, k, n_valid=n_valid, corpus_tile=2048)
    ts, ti = tfn(torch.from_numpy(q), torch.from_numpy(_np(c).copy()),
                 torch.from_numpy(_np(s).copy()), k, n_valid=n_valid, corpus_tile=2048)
    np.testing.assert_array_equal(_np(ji), ti.numpy())
    np.testing.assert_allclose(_np(js), ts.numpy(), rtol=SCORE_TOL, atol=0)
    if n_valid < k:
        assert np.isinf(ts.numpy()[:, n_valid:]).all() and (ti.numpy()[:, n_valid:] == 0).all()


CASES = {"int8": {"dtype": "int8"}, "int4_rerank": {"dtype": "int4", "rerank_factor": 4}}


def _pair(case, dim=96):
    kw = {"dim": dim, **CASES[case]}
    return JEngineConfig(**kw), EngineConfig(**kw)


def _assert_search_equal(jidx, tidx, q, k=8):
    js, ji = jidx.search(q, k=k)
    ts, ti = tidx.search(q, k=k)
    np.testing.assert_array_equal(_np(ji), ti.numpy())
    np.testing.assert_allclose(_np(js), ts.numpy(), rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_flat_index_lifecycle_matches_jax(case, tmp_path):
    """build -> search -> add -> delete -> save/load, beside JAX at every
    step; each package reloads the other's files."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((301, 96)).astype(np.float32)
    q = rng.standard_normal((5, 96)).astype(np.float32)
    jcfg, tcfg = _pair(case)
    jidx, tidx = jflat.FlatIndex.build(x, jcfg), tflat.FlatIndex.build(x, tcfg, device="cpu")
    assert tidx.cfg.__dict__ == jidx.cfg.__dict__
    assert tuple(tidx.corpus.shape) == jidx.corpus.shape and tidx.nbytes == jidx.nbytes
    np.testing.assert_array_equal(_np(jidx.corpus), tidx.corpus.numpy())
    np.testing.assert_allclose(_np(jidx.corpus_scale), tidx.corpus_scale.numpy(),
                               rtol=SCORE_TOL)
    if jidx.refine is not None:
        np.testing.assert_array_equal(jidx.refine, tidx.refine)
    _assert_search_equal(jidx, tidx, q)

    y = rng.standard_normal((3, 96)).astype(np.float32)
    jidx, tidx = jidx.add(y), tidx.add(y)
    assert (tidx.n, tidx.next_id) == (jidx.n, jidx.next_id) == (304, 304)
    _assert_search_equal(jidx, tidx, np.concatenate([q, y[:1]]))
    gone = [0, 5, 302, 10_000]                    # 10_000: unknown, ignored
    jidx, tidx = jidx.delete(gone), tidx.delete(gone)
    assert (tidx.n, tidx.next_id) == (301, 304)
    np.testing.assert_array_equal(_np(jidx.ids)[:301], tidx.ids.numpy()[:301])
    _assert_search_equal(jidx, tidx, q)
    assert tidx.delete([99_999]) is tidx
    z = rng.standard_normal((1, 96)).astype(np.float32)
    jidx, tidx = jidx.add(z), tidx.add(z)        # ids are never reused
    assert tidx.next_id == jidx.next_id == 305
    _assert_search_equal(jidx, tidx, np.concatenate([q, z]))

    jidx.save(str(tmp_path / "j"))
    tidx.save(str(tmp_path / "t"))
    for saved in ("j", "t"):
        _assert_search_equal(jflat.FlatIndex.load(str(tmp_path / saved)),
                             tflat.FlatIndex.load(str(tmp_path / saved), device="cpu"), q)
    back = tflat.FlatIndex.load(str(tmp_path / "j"), device="cpu")
    assert back.next_id == 305 and back.n == 302
    small = tflat.FlatIndex.build(x[:2], tcfg, device="cpu")
    with pytest.raises(ValueError):
        small.delete([0, 1])                      # would empty the index


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_host_rerank_matches_jax(path, monkeypatch):
    """Both packages' host rerank on the same candidates: the numpy paths
    are bit-equal; the native (OpenMP, built here) equals JAX's native in
    ids and within 1e-5 in scores (f32 sums in the vector units' order)."""
    from mediquery_rag_tpu.native import rerank as jnative
    from mediquery_rag_tpu_torch.native import rerank as tnative
    if path == "numpy":
        monkeypatch.setattr(jnative, "rerank_available", lambda: False)
        monkeypatch.setattr(tnative, "rerank_available", lambda: False)
    elif not (tnative.rerank_available() and jnative.rerank_available()):
        pytest.skip("no C++ toolchain for the native rerank")
    rng = np.random.default_rng(13)
    refine = rng.standard_normal((500, 64)).astype(np.float16)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    cand = rng.integers(0, 500, (4, 20)).astype(np.int32)
    cand[0, :3] = 7                               # duplicated candidates tie
    s = rng.standard_normal((4, 20)).astype(np.float32)
    s[:, -2:] = -np.inf                           # padded slots
    calls = tnative.native_rerank.calls
    js, ji = jflat.host_rerank(refine, q, s, cand, 6, cosine=True)
    ts, ti = tflat.host_rerank(refine, q, s, cand, 6, cosine=True)
    assert tnative.native_rerank.calls == calls + (path == "native")
    np.testing.assert_array_equal(_np(ji), ti)
    if path == "numpy":
        np.testing.assert_array_equal(_np(js), ts)
    else:
        np.testing.assert_allclose(_np(js), ts, rtol=0, atol=1e-5)


def test_native_build_skips_a_broken_cxx(tmp_path, monkeypatch):
    """A ``$CXX`` that cannot build the library (a GCC without libgomp, say)
    does not cost it: the next compiler on PATH builds it."""
    import shutil

    from mediquery_rag_tpu_torch.native import _build
    if not shutil.which("g++") and not shutil.which("c++"):
        pytest.skip("no C++ compiler on PATH")
    monkeypatch.setenv("CXX", shutil.which("false") or "false")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.load("rerank") is not None
    assert os.path.exists(tmp_path / "librerank.so")


@pytest.mark.parametrize("case", ["bfloat16", *CASES])
def test_search_stream_bit_equal(case):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((700, 64)).astype(np.float32)
    cfg = EngineConfig(**({"dtype": case} if case == "bfloat16" else CASES[case]))
    idx = tflat.FlatIndex.build(x, cfg, device="cpu").delete([3, 4])
    batches = [rng.standard_normal((b, 64)).astype(np.float32) for b in (5, 16, 1, 9)]
    for depth in (1, 2, 3):
        streamed = list(idx.search_stream(batches, k=7, depth=depth))
        assert len(streamed) == len(batches)
        for (ss, si), qb in zip(streamed, batches):
            s, i = idx.search(qb, k=7)
            assert torch.equal(ss, s) and torch.equal(si, i)
    with pytest.raises(ValueError):
        list(idx.search_stream(batches, depth=0))


NEW = [("live-1", "深海鱼油与血脂调节",
        "适量摄入深海鱼油可能有助于调节血脂水平，高血脂患者应在医生指导下服用鱼油制剂。",
        ["血脂", "营养"]),
       ("live-2", "儿童高热惊厥的家庭处理",
        "孩子高热惊厥时应让其侧卧，保持呼吸道通畅，抽搐超过五分钟立即就医。", ["儿童"])]


@pytest.fixture(scope="module")
def embedders():
    return JIDF.fit_chunks(jparse(CORPUS)), IDFHashingEmbedder.fit_chunks(parse_corpus_file(CORPUS))


def _ids(rows):
    return [[d.metadata["chunk_id"] for d in row] for row in rows]


@pytest.mark.parametrize("case", list(CASES))
def test_document_store_add_delete_matches_jax(case, embedders, tmp_path):
    """Live add/delete through both stores: the added chunks rank first for
    their own text, the deleted ones are gone, and every result equals JAX's;
    the saved store reloads with its int8/int4 index."""
    jemb, temb = embedders
    jcfg, tcfg = _pair(case, dim=3072)
    jstore = jbuild_store(CORPUS, jemb, jcfg)
    tstore = build_document_store(CORPUS, temb, tcfg, device="cpu")
    queries = [t + "：" + c for _, t, c, _ in NEW] + ["高血压患者饮食注意什么"]
    assert _ids(jstore.batch_search(queries, k=3)) == _ids(tstore.batch_search(queries, k=3))
    jids = jstore.add_documents([JChunk(i, t, c, "http", g) for i, t, c, g in NEW])
    tids = tstore.add_documents([Chunk(i, t, c, "http", g) for i, t, c, g in NEW])
    assert jids == tids == [160, 161]
    got = _ids(tstore.batch_search(queries, k=3))
    assert got == _ids(jstore.batch_search(queries, k=3))
    assert [row[0] for row in got[:2]] == ["live-1", "live-2"]
    assert tstore.delete_documents(["live-1", "live-2", "absent"]) == 2
    assert jstore.delete_documents(["live-1", "live-2", "absent"]) == 2
    got = _ids(tstore.batch_search(queries, k=3))
    assert got == _ids(jstore.batch_search(queries, k=3))
    assert not {"live-1", "live-2"} & {c for row in got for c in row}
    assert tstore.live_count == 160 and tstore.index.next_id == 162
    tstore.save(str(tmp_path / "store"))
    back = DocumentStore.load(str(tmp_path / "store"), temb, device="cpu")
    assert back.index.cfg.dtype == tcfg.dtype and len(back.chunks) == 162
    assert _ids(back.batch_search(queries, k=3)) == got
