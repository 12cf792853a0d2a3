"""Parity of the port's IVF retrieval path with the JAX package, on the CPU.

The bucket layout is bit-equal to JAX's on the same assignment; k-means
(from the same initial centroids), the balanced split and the assignments
agree with JAX's; the int4 codes and the split-half slot packing are
bit-equal to JAX's; the port's plain versions of the six probe kernels
(B8a/B8b/B8c query-major, B9a/B9b/B9c bucket-major) give the JAX kernels'
results on the same probe ids (JAX runs its Pallas kernels in interpret
mode, as its own tests do); indexes saved by either package (bf16, int8
and int4, and a JAX streaming build's int4 index with its dummy tail
bucket) load and search the same in the other, and grow and shrink the
same; the port's own build
reaches the JAX test's recall on clustered data, deterministically, with
both layouts bit-identical; and a ``DocumentStore`` over an IVF index
serves like JAX's. Inputs come from ``np.random.default_rng`` (the recall
data from ``jax.random``, as the JAX test makes it); tolerances are stated
per test. Every port call passes ``device="cpu"``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import EngineConfig as JEngineConfig
from mediquery_rag_tpu.engine import ivf as jivf
from mediquery_rag_tpu.ingest import build_document_store as jbuild_store
from mediquery_rag_tpu.ingest.parser import Chunk as JChunk, parse_corpus_file as jparse
from mediquery_rag_tpu.models.lexical import IDFHashingEmbedder as JIDF
from mediquery_rag_tpu.ops import ivf_kernel as jk, kmeans as jkm, quant as jq
from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine import FlatIndex, IVFIndex, ivf as tivf
from mediquery_rag_tpu_torch.engine.tuning import tune_nprobe
from mediquery_rag_tpu_torch.ingest import (
    Chunk, DocumentStore, build_document_store, parse_corpus_file)
from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
from mediquery_rag_tpu_torch.obs.metrics import recall_at_k
from mediquery_rag_tpu_torch.ops import ivf_kernel as tk, kmeans as tkm, quant as tq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
# f32 sums in another order (JAX: f32 products in the kernel; the port: f64,
# rounded once) on unit rows of D = 64
SCORE_TOL = 1e-5
# int8: exact integer sums; the query is normalized by each framework, so a
# last-ulp difference may reach the query scale
INT8_REL_TOL = 1e-6


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _clustered(rng, n, d, n_centers, noise, sizes=None):
    centers = rng.standard_normal((n_centers, d))
    asg = rng.choice(n_centers, n, p=sizes)
    return _unit(centers[asg] + noise * rng.standard_normal((n, d)))


# -- (a) the bucket layout ------------------------------------------------------------

@pytest.mark.parametrize("cap_limit", [0, 224, 160])
def test_plan_layout_bit_equal(cap_limit):
    """Unbounded, bounded with room (overflow to next-best clusters) and
    bounded below the rows (the least-filled fallback): the same bucket ids,
    positions and cap, and the same rebalance."""
    rng = np.random.default_rng(20)
    n, nlist = 3000, 16
    scores = rng.standard_normal((n, nlist)).astype(np.float32) + np.linspace(0, 2, nlist)
    top_ids = np.argsort(-scores, axis=1)[:, :8].astype(np.int32)
    top_scores = np.take_along_axis(scores, top_ids, axis=1)
    want = jivf._plan_layout(top_ids.copy(), top_scores, nlist, n, cap_limit)
    got = tivf._plan_layout(top_ids.copy(), top_scores, nlist, n, cap_limit)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    if cap_limit:
        assign = top_ids[:, 0].copy()
        counts = np.bincount(assign, minlength=nlist)
        want = jivf._rebalance_overflow(assign.copy(), counts.copy(), top_ids, top_scores,
                                        cap_limit)
        got = tivf._rebalance_overflow(assign.copy(), counts.copy(), top_ids, top_scores,
                                       cap_limit)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


# -- (b, c) k-means ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def skewed():
    """Heavily skewed clusters (the JAX split test's geometry, 6,000 rows)."""
    rng = np.random.default_rng(0)
    sizes = rng.dirichlet(np.ones(40) * 0.4)
    x = _clustered(rng, 6000, 64, 40, 0.35, sizes)
    return x, x[rng.choice(6000, 64, replace=False)]


@pytest.mark.parametrize("balance,iters", [(0.0, 4), (0.05, 2)])
def test_kmeans_from_init_matches_jax(skewed, balance, iters):
    """Lloyd passes from the same initial centroids: centroids within 1e-5
    (f32 sums in another order), assignments equal. (With the penalty, a
    row within 1e-7 of a boundary flips in the third pass on this data.)"""
    x, init = skewed
    want = jkm.kmeans(jnp.asarray(x), jax.random.PRNGKey(0), nlist=64, iters=iters,
                      init=jnp.asarray(init), balance=balance)
    got = tkm.kmeans(_t(x), nlist=64, iters=iters, init=_t(init), balance=balance)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tkm.assign_clusters(_t(x), got).numpy(),
                                  _np(jkm.assign_clusters(jnp.asarray(x), want)))


def test_split_oversized_matches_jax(skewed):
    """The balanced split from the same centroids: within 1e-5, the same
    assignments, and the largest cluster bounded as in JAX."""
    x, init = skewed
    cents = jkm.kmeans(jnp.asarray(x), jax.random.PRNGKey(0), nlist=64, iters=2,
                       init=jnp.asarray(init), balance=0.05)
    want = jkm.split_oversized(jnp.asarray(x), cents, cap_rows=192, n_total=6000)
    got = tkm.split_oversized(_t(x), _t(_np(cents)), cap_rows=192, n_total=6000)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    asg = tkm.assign_clusters(_t(x), got).numpy()
    np.testing.assert_array_equal(asg, _np(jkm.assign_clusters(jnp.asarray(x), want)))
    assert np.bincount(asg, minlength=64).max() < np.bincount(
        tkm.assign_clusters(_t(x), _t(_np(cents))).numpy(), minlength=64).max()


def test_assign_clusters_topr_matches_jax(skewed):
    """bf16 inputs, f32 sums: scores within 1e-5, ids equal on every row
    whose top-(r+1) scores are more than 1e-3 apart."""
    x, init = skewed
    cents = _unit(init + 0.1)
    ji, js = jkm.assign_clusters_topr(jnp.asarray(x), jnp.asarray(cents), r=8, chunk=4096)
    ti, ts = tkm.assign_clusters_topr(_t(x), _t(cents), r=8, chunk=4096)
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=1e-5)
    full = -np.sort(-(_t(x).bfloat16().float() @ _t(cents).bfloat16().float().T).numpy(),
                    axis=1)[:, :9]
    clear = (-np.diff(full, axis=1) > 1e-3).all(axis=1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ti.numpy()[clear], _np(ji)[clear])


def test_int4_helpers_bit_equal():
    """``int4_codes`` (round half to even, clip +-7, a zero row's 1e-12
    floor), ``ivf_pack_slots_int4`` and ``ivf_unpack_slots_int4`` against
    JAX's on one numpy draw: bit-equal, and unpacking inverts packing."""
    rng = np.random.default_rng(43)
    x = rng.standard_normal((4 * 64, 48)).astype(np.float32)
    x[5] = 0.0
    x[7, :4] = np.float32(0.5 / 7) * np.array([1, 3, 5, 7], np.float32)   # exact halves
    jc, js = jq.int4_codes(jnp.asarray(x))
    tc, ts = tq.int4_codes(_t(x))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    jp = jq.ivf_pack_slots_int4(jc, 4, 64)
    tp = tq.ivf_pack_slots_int4(tc, 4, 64)
    assert tp.dtype == torch.int8 and tp.shape == (4 * 32, 48)
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(tq.ivf_unpack_slots_int4(tp, 4, 64).numpy(),
                                  _np(jq.ivf_unpack_slots_int4(jp, 4, 64)))
    assert torch.equal(tq.ivf_unpack_slots_int4(tp, 4, 64), tc)


# -- (d) the six kernels' plain versions against the JAX kernels -------------------------

@pytest.fixture(scope="module")
def jax_indexes():
    """JAX-built bf16, int8 and int4 indexes over clustered rows (heavy
    probe overlap across queries), with deleted slots (-1)."""
    rng = np.random.default_rng(30)
    x = _clustered(rng, 1500, 64, 8, 0.3)
    out = {}
    for dtype in ("bfloat16", "int8", "int4"):
        cfg = JEngineConfig(dim=64, dtype=dtype, ivf_nlist=16, ivf_kmeans_iters=3)
        out[dtype] = jivf.IVFIndex.build(x, cfg).delete(list(range(0, 1500, 7)))
    return x, out


def _port_arrays(idx):
    b = _np(idx.buckets)
    b = (_t(b.view(np.uint16).view(np.int16)).view(torch.bfloat16)
         if b.dtype.name == "bfloat16" else _t(b))
    sc = None if idx.bucket_scales is None else _t(_np(idx.bucket_scales))
    return b, _t(_np(idx.bucket_ids)), sc


@pytest.mark.parametrize("layout", ["probe", "batch"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("b,nprobe", [(33, 4), (3, 16)])
def test_kernel_plain_matches_jax(jax_indexes, layout, dtype, b, nprobe):
    """B8a/B8b/B8c/B9a/B9b/B9c: the port's op (its plain version on CPU
    tensors) against the JAX kernel on the same probe ids, k = 5. B=33 over
    16 clusters makes queries share buckets; nprobe 16 = nlist probes all.
    Ids equal (no duplicated rows); scores within SCORE_TOL (int8:
    INT8_REL_TOL relative; int4 bit-equal: exact integer dots, the same
    query codes and the same f32 epilogue, operation for operation)."""
    x, idxs = jax_indexes
    idx = idxs[dtype]
    rng = np.random.default_rng(31 + b)
    q = _unit(rng.standard_normal((b, 64)))
    pid = _np(jax.lax.top_k(jnp.asarray(q) @ idx.centroids.T, nprobe)[1]).astype(np.int32)
    buckets, bids, scales = _port_arrays(idx)
    quant = {"bfloat16": None, "int8": None, "int4": "int4"}[dtype]
    if layout == "batch":
        js, ji = jk.ivf_batch_search(jnp.asarray(pid), jnp.asarray(q), idx.buckets,
                                     idx.bucket_ids, k=5, bucket_scales=idx.bucket_scales,
                                     quant=quant)
        ts, ti = tk.ivf_batch_search(_t(pid), _t(q), buckets, bids, k=5,
                                     bucket_scales=scales, quant=quant)
    elif dtype == "int4":
        js, ji = jk.ivf_probe_search_int4(jnp.asarray(pid), jnp.asarray(q), idx.buckets,
                                          idx.bucket_ids, idx.bucket_scales, k=5)
        ts, ti = tk.ivf_probe_search_int4(_t(pid), _t(q), buckets, bids, scales, k=5)
    elif dtype == "int8":
        js, ji = jk.ivf_probe_search_int8(jnp.asarray(pid), jnp.asarray(q), idx.buckets,
                                          idx.bucket_ids, idx.bucket_scales, k=5)
        ts, ti = tk.ivf_probe_search_int8(_t(pid), _t(q), buckets, bids, scales, k=5)
    else:
        jq = jnp.asarray(q).astype(jnp.bfloat16)
        js, ji = jk.ivf_probe_search(jnp.asarray(pid), jq, idx.buckets, idx.bucket_ids, k=5)
        ts, ti = tk.ivf_probe_search(_t(pid), _t(q).bfloat16(), buckets, bids, k=5)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    if dtype == "int4":
        np.testing.assert_array_equal(ts.numpy(), _np(js))
    elif dtype == "int8":
        np.testing.assert_allclose(ts.numpy(), _np(js), rtol=INT8_REL_TOL, atol=0)
    else:
        np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=SCORE_TOL)
    gone = set(range(0, 1500, 7))
    assert not gone & set(ti.numpy().reshape(-1).tolist())


def test_gather_oracle_matches_jax(jax_indexes):
    """JAX's gather oracle (every probed row in f32) against the port's
    plain B8a on f32 queries."""
    x, idxs = jax_indexes
    idx = idxs["bfloat16"]
    q = _unit(np.random.default_rng(32).standard_normal((6, 64)))
    pid = _np(jax.lax.top_k(jnp.asarray(q) @ idx.centroids.T, 4)[1]).astype(np.int32)
    buckets, bids, _ = _port_arrays(idx)
    js, ji = jk.ivf_probe_search_xla(jnp.asarray(pid), jnp.asarray(q), idx.buckets,
                                     idx.bucket_ids, k=5)
    ts, ti = tk.ivf_probe_search_plain(_t(pid), _t(q), buckets, bids, 5)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("cap", [32, 96])
def test_plain_layouts_short_results(cap):
    """Few live slots, k past them: both plain layouts equal a brute-force
    reference over the live probed rows, then (-inf, id 0); bit-identical."""
    rng = np.random.default_rng(cap)
    nlist, d = 4, 64
    rows = _unit(rng.standard_normal((nlist * cap, d)))
    ids = np.full((nlist, cap), -1, np.int32)
    live = rng.choice(nlist * cap, 30, replace=False)
    ids.reshape(-1)[live] = rng.permutation(1000)[:30]
    q = _unit(rng.standard_normal((5, d)))
    pid = np.stack([rng.permutation(nlist)[:2] for _ in range(5)]).astype(np.int32)
    buckets, bids = _t(rows).bfloat16(), _t(ids)
    s1, i1 = tk.ivf_probe_search(_t(pid), _t(q).bfloat16(), buckets, bids, k=40)
    s2, i2 = tk.ivf_batch_search(_t(pid), _t(q), buckets, bids, k=40)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    qb, rb = _t(q).bfloat16().double(), buckets.double()
    for r in range(5):
        slots = [p * cap + c for p in pid[r] for c in range(cap) if ids[p, c] >= 0]
        sc = (qb[r] @ rb[slots].T).float().numpy()
        order = sorted(range(len(slots)), key=lambda j: (-sc[j], ids.reshape(-1)[slots[j]]))
        m = len(slots)
        assert m < 40
        np.testing.assert_array_equal(i1[r, :m].numpy(), ids.reshape(-1)[slots][order])
        np.testing.assert_array_equal(s1[r, :m].numpy(), sc[order])
        assert torch.isinf(s1[r, m:]).all() and (i1[r, m:] == 0).all()


def test_unique_probes_fixed_size():
    pid = torch.tensor([[3, 1], [1, 7], [3, 0]], dtype=torch.int32)
    assert tk.unique_probes(pid, 16).tolist() == [0, 1, 3, 7, -1, -1]
    assert tk.unique_probes(pid, 4).tolist() == [0, 1, 3, 7]


# -- (e, f) saved indexes, both ways; live add/delete -------------------------------------

CASES = {"float32": {"dtype": "float32"},
         "bfloat16": {"dtype": "bfloat16"},
         "int8_rerank": {"dtype": "int8", "rerank_factor": 4},
         "int4_rerank": {"dtype": "int4", "rerank_factor": 4}}


def _pair(case):
    kw = {"dim": 64, "ivf_nlist": 16, "ivf_kmeans_iters": 3, **CASES[case]}
    return JEngineConfig(**kw), EngineConfig(**kw)


def _assert_search_equal(jidx, tidx, q, k=5, nprobe=4):
    for batched in (False, True):
        js, ji = jidx.search(q, k=k, nprobe=nprobe, batched=batched)
        ts, ti = tidx.search(q, k=k, nprobe=nprobe, batched=batched)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-5, atol=SCORE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_saved_index_both_ways(case, tmp_path):
    """A JAX-saved index loads in the port and searches the same in both
    layouts; the port's save loads in JAX and searches the same."""
    rng = np.random.default_rng(40)
    x = _clustered(rng, 1200, 64, 8, 0.3)
    q = _unit(rng.standard_normal((9, 64)))
    jcfg, tcfg = _pair(case)
    jidx = jivf.IVFIndex.build(x, jcfg)
    jidx.save(str(tmp_path / "j"))
    tidx = IVFIndex.load(str(tmp_path / "j"), device="cpu")
    assert (tidx.n, tidx.cap, tidx.next_id, tidx.nbytes) == (jidx.n, jidx.cap, jidx.next_id,
                                                             jidx.nbytes)
    assert tidx.cfg.__dict__ == jidx.cfg.__dict__
    assert (tidx.refine is None) == (jidx.refine is None)
    _assert_search_equal(jidx, tidx, q)
    tidx.save(str(tmp_path / "t"))
    back = jivf.IVFIndex.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(_np(back.bucket_ids), tidx.bucket_ids.numpy())
    _assert_search_equal(back, tidx, q)
    s1, i1 = tidx.search(q[0], k=3)              # 1-D query squeezes
    assert s1.shape == (3,) and i1.shape == (3,)


@pytest.mark.parametrize("case", list(CASES))
def test_add_delete_matches_jax(case, tmp_path):
    """From one saved index: ``add`` (enough near-duplicates to grow the
    cap) then ``delete`` give JAX's bucket ids, cap and rows (bf16 rows
    within one bf16 rounding: each framework normalizes; int8 codes and
    int4 packed bytes equal, scales within 1e-6), and search the same."""
    rng = np.random.default_rng(41)
    x = _clustered(rng, 1000, 64, 8, 0.3)
    jcfg, _ = _pair(case)
    jivf.IVFIndex.build(x, jcfg).save(str(tmp_path / "j"))
    jidx = jivf.IVFIndex.load(str(tmp_path / "j"))
    tidx = IVFIndex.load(str(tmp_path / "j"), device="cpu")
    extra = _unit(np.tile(x[:1], (jidx.cap + 8, 1))
                  + 0.01 * rng.standard_normal((jidx.cap + 8, 64)))
    jidx, tidx = jidx.add(extra), tidx.add(extra)
    assert tidx.cap == jidx.cap > 0 and tidx.cap > IVFIndex.load(str(tmp_path / "j"),
                                                                 device="cpu").cap
    jidx, tidx = jidx.delete([3, 1001, 99_999]), tidx.delete([3, 1001, 99_999])
    assert (tidx.n, tidx.next_id, tidx.live) == (jidx.n, jidx.next_id, jidx.live)
    np.testing.assert_array_equal(tidx.bucket_ids.numpy(), _np(jidx.bucket_ids))
    if case == "float32":       # each framework normalizes: last-ulp rows
        np.testing.assert_allclose(tidx.buckets.numpy(), _np(jidx.buckets), rtol=0,
                                   atol=1e-6)
    elif case == "bfloat16":
        np.testing.assert_allclose(tidx.buckets.float().numpy(),
                                   _np(jidx.buckets.astype(jnp.float32)), rtol=0, atol=8e-3)
    else:
        np.testing.assert_array_equal(tidx.buckets.numpy(), _np(jidx.buckets))
        np.testing.assert_allclose(tidx.bucket_scales.numpy(), _np(jidx.bucket_scales),
                                   rtol=1e-6)
        np.testing.assert_array_equal(tidx.refine, jidx.refine)
    assert tidx.delete([99_999]) is tidx
    _assert_search_equal(jidx, tidx, np.concatenate([x[:4], extra[:2]]), nprobe=16)


def test_streaming_int4_add_delete_matches_jax(tmp_path):
    """A JAX ``build_streaming`` int4 index (its buckets carry the dummy
    tail bucket) saved and loaded in the port: the same search, then
    ``add`` (which must cut the tail off before unpacking; the regression
    of tests/test_quant.py:336) and ``delete`` give JAX's bucket ids, cap,
    packed bytes and scales (within 1e-6: each framework normalizes)."""
    rng = np.random.default_rng(44)
    x = _clustered(rng, 1000, 64, 8, 0.3)
    jcfg = JEngineConfig(dim=64, dtype="int4", ivf_nlist=8, ivf_kmeans_iters=3,
                         ivf_sample=512)
    jidx = jivf.IVFIndex.build_streaming(lambda: (x[i:i + 256] for i in range(0, 1000, 256)),
                                         1000, jcfg, chunk_rows=256)
    assert jidx.buckets.shape[0] == (jidx.bucket_ids.shape[0] + 1) * jidx.cap // 2
    jidx.save(str(tmp_path / "j"))
    tidx = IVFIndex.load(str(tmp_path / "j"), device="cpu")
    q = _unit(rng.standard_normal((5, 64)))
    _assert_search_equal(jidx, tidx, q, nprobe=8)
    extra = _unit(rng.standard_normal((7, 64)))
    jidx, tidx = jidx.add(extra).delete([2, 1003]), tidx.add(extra).delete([2, 1003])
    assert (tidx.n, tidx.cap, tidx.live) == (jidx.n, jidx.cap, jidx.live) == (1007, tidx.cap, 1005)
    np.testing.assert_array_equal(tidx.bucket_ids.numpy(), _np(jidx.bucket_ids))
    np.testing.assert_array_equal(tidx.buckets.numpy(), _np(jidx.buckets))
    np.testing.assert_allclose(tidx.bucket_scales.numpy(), _np(jidx.bucket_scales), rtol=1e-6)
    _assert_search_equal(jidx, tidx, np.concatenate([q, extra[:3]]), nprobe=8)


def test_f32_ivf_on_the_card_raises():
    """f32 IVF storage goes to the card like the other types (f32 B8a/B9a):
    the build no longer refuses it, so on a host without a card it fails
    only for want of the device (with one, it builds there). What still
    raises: an f32 kernel handed buckets of another type, and int4 buckets
    that lack half of ``nlist * cap`` packed rows."""
    x = _unit(np.random.default_rng(42).standard_normal((64, 64)))
    cfg = EngineConfig(dim=64, dtype="float32", ivf_nlist=8, ivf_kmeans_iters=2)
    if torch.cuda.is_available():
        assert IVFIndex.build(x, cfg, device="cuda").buckets.dtype == torch.float32
    else:
        with pytest.raises((RuntimeError, AssertionError)) as err:
            IVFIndex.build(x, cfg, device="cuda")
        assert "float32" not in str(err.value)
    pid = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 buckets"):
        tk.ivf_probe_topk_f32_cuda(pid, _t(x[:1]), _t(x[:32]).to(torch.bfloat16),
                                   torch.zeros((1, 32), dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="int4 needs 32"):
        tk.ivf_batch_search(torch.zeros((1, 2), dtype=torch.int32), _t(x[:1]), _t(x[:31]),
                            torch.zeros((2, 32), dtype=torch.int32), k=5,
                            bucket_scales=torch.ones((2, 32)), quant="int4")


# -- (g) the port's own build ------------------------------------------------------------

@pytest.fixture(scope="module")
def recall_data():
    """tests/test_engine.py::test_partial_probe_recall's corpus and queries."""
    centers = jax.random.normal(jax.random.PRNGKey(12), (64, 64))
    assign = jax.random.randint(jax.random.PRNGKey(1), (4000,), 0, 64)
    c = centers[assign] + 0.3 * jax.random.normal(jax.random.PRNGKey(2), (4000, 64))
    c = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
    q = c[:16] + 0.05 * jax.random.normal(jax.random.PRNGKey(3), (16, 64))
    return np.array(c, dtype=np.float32), np.array(q, dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_own_build_recall_and_determinism(recall_data, dtype):
    """Recall@10 >= 0.9 at nprobe 16 of 64 (the JAX test's floor) against
    the exact f32 scan; two builds from one seed are identical; both
    layouts are bit-identical; ``tune_nprobe`` finds a passing nprobe."""
    c, q = recall_data
    cfg = EngineConfig(dim=64, dtype=dtype, ivf_nlist=64, ivf_kmeans_iters=6)
    a = IVFIndex.build(c, cfg, device="cpu")
    b = IVFIndex.build(c, cfg, device="cpu")
    for name in ("centroids", "buckets", "bucket_ids", "bucket_scales"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    oracle = FlatIndex.build(c, EngineConfig(dim=64, dtype="float32"), device="cpu")
    _, i_ref = oracle.search(q, k=10)
    s1, i1 = a.search(q, k=10, nprobe=16, batched=False)
    s2, i2 = a.search(q, k=10, nprobe=16, batched=True)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert recall_at_k(i1.numpy(), i_ref.numpy()) >= 0.9
    ids = a.bucket_ids.numpy().reshape(-1)
    assert sorted(ids[ids >= 0].tolist()) == list(range(4000))   # every doc once
    tuned = tune_nprobe(a, oracle, q, k=10, target_recall=0.9)
    assert tuned["recall"] >= 0.9 and tuned["nprobe"] <= 16


def test_int4_rerank4_recall_on_clustered_rows_matches_jax():
    """int4 + ``rerank_factor=4`` recall@10 on a small copy of the clustered
    mixture ``chip_smoke.py`` phase 3c serves (D = 768, 256 rows per center,
    noise 0.3): the port's IVF index, JAX's IVF index (every bucket probed,
    so both rerank the same int4 top-40) and the port's flat int4 index
    agree within 0.01 (3 of 320 ids), whatever that recall is. Run with
    ``-s`` to print the three values."""
    rng = np.random.default_rng(45)
    centers = rng.standard_normal((16, 768))
    x = _unit(centers[rng.integers(0, 16, 4096)] + 0.3 * rng.standard_normal((4096, 768)))
    q = _unit(centers[rng.integers(0, 16, 32)] + 0.3 * rng.standard_normal((32, 768)))
    exact = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :10]
    kw = {"dim": 768, "dtype": "int4", "ivf_nlist": 16, "ivf_kmeans_iters": 3,
          "rerank_factor": 4}
    port = IVFIndex.build(x, EngineConfig(**kw), device="cpu")
    rec_port = recall_at_k(port.search(q, k=10, nprobe=16)[1].numpy(), exact)
    rec_jax = recall_at_k(_np(jivf.IVFIndex.build(x, JEngineConfig(**kw)).search(
        q, k=10, nprobe=16)[1]), exact)
    flat = FlatIndex.build(x, EngineConfig(dim=768, dtype="int4", rerank_factor=4),
                           device="cpu")
    rec_flat = recall_at_k(flat.search(q, k=10)[1].numpy(), exact)
    print(f"int4 rerank_factor 4 recall@10 on clustered rows: port IVF {rec_port}, "
          f"JAX IVF {rec_jax}, port flat {rec_flat}")
    assert abs(rec_port - rec_jax) <= 0.01 and abs(rec_port - rec_flat) <= 0.01


# -- (h) the document store ----------------------------------------------------------------

@pytest.fixture(scope="module")
def embedders():
    return JIDF.fit_chunks(jparse(CORPUS)), IDFHashingEmbedder.fit_chunks(parse_corpus_file(CORPUS))


def _ids(rows):
    return [[d.metadata["chunk_id"] for d in row] for row in rows]


NEW = [("live-1", "深海鱼油与血脂调节",
        "适量摄入深海鱼油可能有助于调节血脂水平，高血脂患者应在医生指导下服用鱼油制剂。",
        ["血脂", "营养"]),
       ("live-2", "儿童高热惊厥的家庭处理",
        "孩子高热惊厥时应让其侧卧，保持呼吸道通畅，抽搐超过五分钟立即就医。", ["儿童"])]


def test_document_store_ivf(embedders, tmp_path):
    """``kind="ivf"`` at int8 with the rerank (160 chunks: nlist 20, every
    bucket probed): the same documents as JAX's IVF store, live add/delete,
    and a save that reloads as an IVF store; ``where`` searches (whose
    widening pass runs k = 128) equal the port's exact flat store, as JAX's
    interpreted kernels take seconds per new shape. One batch size and k
    throughout for the same reason."""
    jemb, temb = embedders
    kw = CASES["int8_rerank"]
    jstore = jbuild_store(CORPUS, jemb, JEngineConfig(**kw), kind="ivf")
    tstore = build_document_store(CORPUS, temb, EngineConfig(**kw), kind="ivf",
                                  device="cpu")
    assert isinstance(tstore.index, IVFIndex) and tstore.index.nlist == 20
    queries = [t + "：" + c for _, t, c, _ in NEW] + ["高血压患者饮食注意什么", "糖尿病的早期症状"]
    assert _ids(tstore.batch_search(queries, k=3)) == _ids(jstore.batch_search(queries, k=3))
    where = {"tags": "高血压"}
    flat = build_document_store(CORPUS, temb, EngineConfig(**kw), device="cpu")
    got = _ids(tstore.batch_search(queries, k=3, where=where))
    assert got == _ids(flat.batch_search(queries, k=3, where=where))
    assert all(len(row) == 3 for row in got)
    assert tstore.add_documents([Chunk(i, t, c, "http", g) for i, t, c, g in NEW]) == \
        jstore.add_documents([JChunk(i, t, c, "http", g) for i, t, c, g in NEW]) == [160, 161]
    got = _ids(tstore.batch_search(queries, k=3))
    assert got == _ids(jstore.batch_search(queries, k=3))
    assert [row[0] for row in got[:2]] == ["live-1", "live-2"]
    assert tstore.delete_documents(["live-1", "live-2", "absent"]) == 2
    assert jstore.delete_documents(["live-1", "live-2", "absent"]) == 2
    got = _ids(tstore.batch_search(queries, k=3))
    assert got == _ids(jstore.batch_search(queries, k=3))
    assert not {"live-1", "live-2"} & {c for row in got for c in row}
    tstore.save(str(tmp_path / "store"))
    back = DocumentStore.load(str(tmp_path / "store"), temb, device="cpu")
    assert isinstance(back.index, IVFIndex) and len(back.chunks) == 162
    assert _ids(back.batch_search(queries, k=3)) == got
