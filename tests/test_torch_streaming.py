"""The port's streaming tiers on the CPU: ``IVFIndex.build_streaming`` and
the host-streaming ``StreamingFlatIndex``, against the port's in-memory
indexes and the JAX package.

``build_streaming`` builds the in-memory ``build``'s index bucket for
bucket when every row is in the k-means sample; ``sample_rows`` gives the
iterated build's index; a wrong row count asserts. ``StreamingFlatIndex``
finds JAX's results on a JAX-saved index (int8 scores within one ulp), its own
build agrees with JAX's and with the port's resident ``FlatIndex``, host
prep agrees with device prep, ``.bin`` files load both ways, and a
``DocumentStore`` over it searches but refuses live changes, as in JAX.
Inputs come from ``np.random.default_rng``; every port call passes
``device="cpu"``; tolerances are stated per test.
"""

import os

import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import EngineConfig as JEngineConfig
from mediquery_rag_tpu.engine import StreamingFlatIndex as JStreamingFlatIndex
from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine import FlatIndex, IVFIndex, StreamingFlatIndex
from mediquery_rag_tpu_torch.ingest import Chunk, build_document_store, parse_corpus_file
from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
from mediquery_rag_tpu_torch.ops.quant import quantize_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
# f32 sums of D = 64 unit-row products in another order (JAX's interpreted
# kernel, the port's plain product, or chunk against whole corpus)
F32_TOL = 1e-5
INT8_REL_TOL = 1e-6       # one f32 ulp of an int8 score


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(60)
    centers = rng.standard_normal((16, 64))
    x = centers[rng.integers(0, 16, 1000)] + 0.3 * rng.standard_normal((1000, 64))
    return x.astype(np.float32), _unit(x[:9] + 0.05 * rng.standard_normal((9, 64)))


def _chunks(x, rows):
    return lambda: (x[i:i + rows] for i in range(0, len(x), rows))


# -- IVFIndex.build_streaming ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_build_streaming_equals_build(clustered, dtype):
    """n = 1,000 <= ivf_sample in chunks of 256 (a short last chunk of
    232): the in-memory build's centroids, cap, bucket ids, buckets and
    scales, bit for bit (empty slots included), plus a dummy tail bucket of
    zero rows; both searches bit-identical in both layouts."""
    x, q = clustered
    cfg = EngineConfig(dim=64, dtype=dtype, ivf_nlist=8, ivf_kmeans_iters=3)
    mem = IVFIndex.build(x, cfg, seed=3, device="cpu")
    st = IVFIndex.build_streaming(_chunks(x, 256), 1000, cfg, seed=3, chunk_rows=256,
                                  device="cpu")
    rows = mem.buckets.shape[0]
    assert st.cap == mem.cap and st.buckets.shape[0] == rows + rows // mem.nlist
    assert torch.equal(st.centroids, mem.centroids)
    assert torch.equal(st.bucket_ids, mem.bucket_ids)
    assert torch.equal(st.buckets[:rows], mem.buckets)
    tail = st.buckets[rows:]
    assert torch.equal(tail, torch.full_like(tail, 8 if dtype == "int4" else 0))
    if dtype == "bfloat16":
        assert st.bucket_scales is None and mem.bucket_scales is None
    else:
        assert torch.equal(st.bucket_scales, mem.bucket_scales)
    for batched in (False, True):
        s1, i1 = mem.search(q, k=5, nprobe=4, batched=batched)
        s2, i2 = st.search(q, k=5, nprobe=4, batched=batched)
        assert torch.equal(s1, s2) and torch.equal(i1, i2)


def test_build_streaming_sample_rows_timings_and_checks(clustered):
    """n > ivf_sample (a stride-3 sample of 256 rows): ``sample_rows``
    gives the iterated build's index; ``timings`` gets JAX's keys; a bf16
    transfer keeps the top-5 (overlap >= 0.9, JAX's floor for it); a wrong
    row count asserts and an unknown transfer type is refused."""
    x, q = clustered
    cfg = EngineConfig(dim=64, dtype="int8", ivf_nlist=8, ivf_kmeans_iters=3, ivf_sample=256)
    tm: dict = {}
    a = IVFIndex.build_streaming(_chunks(x, 300), 1000, cfg, chunk_rows=300, timings=tm,
                                 device="cpu")
    b = IVFIndex.build_streaming(_chunks(x, 300), 1000, cfg, chunk_rows=300,
                                 sample_rows=lambda idx: x[idx], device="cpu")
    for name in ("centroids", "buckets", "bucket_ids", "bucket_scales"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert set(tm) == {"sample_s", "kmeans_s", "assign_s", "assign_pull_s", "layout_s",
                       "scatter_s", "placement"}
    assert abs(sum(tm["placement"].values()) - 1.0) < 1e-3
    c = IVFIndex.build_streaming(_chunks(x, 300), 1000, cfg, chunk_rows=300,
                                 transfer_dtype="bfloat16", device="cpu")
    _, i1 = a.search(q, k=5, nprobe=8)
    _, i2 = c.search(q, k=5, nprobe=8)
    overlap = np.mean([len(set(r1) & set(r2)) / 5 for r1, r2 in zip(i1.tolist(), i2.tolist())])
    assert overlap >= 0.9
    with pytest.raises(AssertionError, match="expected"):
        IVFIndex.build_streaming(lambda: iter([x[:500]]), 600, cfg, device="cpu")
    with pytest.raises(ValueError, match="transfer_dtype"):
        IVFIndex.build_streaming(_chunks(x, 300), 1000, cfg, transfer_dtype="int8",
                                 device="cpu")


# -- StreamingFlatIndex ------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat_rows():
    rng = np.random.default_rng(61)
    return (rng.standard_normal((2000, 64)).astype(np.float32),
            rng.standard_normal((5, 64)).astype(np.float32))


def _kw(dtype, metric="dot"):
    return {"dim": 64, "dtype": dtype, "corpus_tile": 256, "metric": metric}


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_streaming_flat_matches_jax(flat_rows, dtype, tmp_path):
    """Three 768-row chunks (the last 464 rows valid). On JAX's saved
    index (the same bytes, loaded as memmaps) the port's search gives JAX's
    ids, int8 scores bit-equal to the exact integer sums scaled in IEEE
    order (metric "dot", so no query is renormalized) and JAX's within
    INT8_REL_TOL, float scores within F32_TOL; the port's own build gives JAX's ids and scores within F32_TOL
    (each framework normalizes the rows); the port's save loads in JAX and
    gives the same ids, scores within F32_TOL."""
    x, q = flat_rows
    jidx = JStreamingFlatIndex.build(x, JEngineConfig(**_kw(dtype)), chunk_rows=768)
    js, ji = (np.asarray(t) for t in jidx.search(q, k=10))
    jidx.save(str(tmp_path / "j"))
    loaded = StreamingFlatIndex.load(str(tmp_path / "j"), device="cpu")
    assert (loaded.n, loaded.chunk_rows, len(loaded.chunks)) == (2000, 768, 3)
    assert loaded.nbytes_host == jidx.nbytes_host
    ls, li = loaded.search(q, k=10)
    np.testing.assert_array_equal(li.numpy(), ji)
    if dtype == "int8":
        # bit-equal to the IEEE order (f32(q8 . c8) * scale) * query scale;
        # JAX's interpreted CPU scan rounds the last bit of some scores
        # apart from it (9 of these 50), so JAX's within one ulp
        q8, qs = quantize_rows(torch.from_numpy(q))
        c8 = torch.cat(loaded.chunks).long()
        raw = (q8.long() @ c8.T).float() * torch.cat(loaded.scales)
        want = torch.gather(raw, 1, li.long()) * qs[:, None]
        assert torch.equal(ls, want)
        np.testing.assert_allclose(ls.numpy(), js, rtol=INT8_REL_TOL, atol=0)
    else:
        np.testing.assert_allclose(ls.numpy(), js, rtol=0, atol=F32_TOL)
    own = StreamingFlatIndex.build(x, EngineConfig(**_kw(dtype)), chunk_rows=768, device="cpu")
    os_, oi = own.search(q, k=10)
    np.testing.assert_array_equal(oi.numpy(), ji)
    np.testing.assert_allclose(os_.numpy(), js, rtol=0, atol=F32_TOL)
    own.save(str(tmp_path / "t"))
    back = JStreamingFlatIndex.load(str(tmp_path / "t"))
    bs, bi = back.search(q, k=10)
    np.testing.assert_array_equal(np.asarray(bi), oi.numpy())
    # JAX's CPU scan may round the int8 product's last bit apart from IEEE
    # order on other scales (1 ulp on 10 of these 50 scores)
    np.testing.assert_allclose(np.asarray(bs), os_.numpy(), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_streaming_flat_matches_resident(flat_rows, dtype):
    """Against the port's resident ``FlatIndex`` on one device: int8 (cosine,
    the same normalization and quantization) ids and scores bit-equal;
    bf16 and f32 against a resident f32 index over the streamed rows
    themselves (the streaming float path scores in f32) within F32_TOL, ids
    equal. ``prefetch=False`` gives the same result bit for bit; a 1-D
    query gives 1-D results."""
    x, q = flat_rows
    st = StreamingFlatIndex.build(x, EngineConfig(**_kw(dtype, "cosine")), chunk_rows=768,
                                  device="cpu")
    s, i = st.search(q, k=10)
    if dtype == "int8":
        res = FlatIndex.build(x, EngineConfig(**_kw("int8", "cosine")), device="cpu")
        rs, ri = res.search(q, k=10)
        assert torch.equal(s, rs) and torch.equal(i, ri)
    else:
        rows = torch.cat(st.chunks)[:2000].float()
        res = FlatIndex.build(rows, EngineConfig(**_kw("float32")), device="cpu")
        rs, ri = res.search(_unit(q), k=10)
        assert torch.equal(i, ri)
        assert torch.allclose(s, rs, rtol=0, atol=F32_TOL)
    s2, i2 = st.search(q, k=10, prefetch=False)
    assert torch.equal(s, s2) and torch.equal(i, i2)
    s1, i1 = st.search(q[0], k=3)
    assert s1.shape == (3,) and torch.equal(i1, i[0, :3])


def test_streaming_flat_host_prep_and_refusals(flat_rows):
    """``prep="host"`` (numpy) against device prep: codes within one step
    and scales within 1e-6 (numpy's and torch's row norms may round the
    last bit apart), search recall >= 0.95 (JAX's test's tolerances);
    unsupported dtypes and preps are refused."""
    x, q = flat_rows
    cfg = EngineConfig(**_kw("int8", "cosine"))
    dev = StreamingFlatIndex.build(x, cfg, chunk_rows=768, device="cpu")
    host = StreamingFlatIndex.build(x, cfg, chunk_rows=768, prep="host", device="cpu")
    for cd, ch, sd, sh in zip(dev.chunks, host.chunks, dev.scales, host.scales):
        assert (cd.int() - ch.int()).abs().max().item() <= 1
        np.testing.assert_allclose(sd.numpy(), sh.numpy(), rtol=1e-6)
    _, i_d = dev.search(q, k=10)
    _, i_h = host.search(q, k=10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_d.tolist(), i_h.tolist())]) >= 0.95
    with pytest.raises(ValueError, match="supports"):
        StreamingFlatIndex.build(x[:512], EngineConfig(**_kw("int4")), device="cpu")
    with pytest.raises(ValueError, match="int8 storage only"):
        StreamingFlatIndex.build(x[:512], EngineConfig(**_kw("float32")), prep="host",
                                 device="cpu")
    with pytest.raises(ValueError, match="prep"):
        StreamingFlatIndex.build(x[:512], cfg, prep="gpu", device="cpu")


def test_build_from_blocks_repacks(flat_rows):
    """Blocks of any sizes repack to fixed chunks: the same index as one
    array, chunk for chunk."""
    x, q = flat_rows
    cfg = EngineConfig(**_kw("float32"))
    blocks = [x[0:300], x[300:1500], x[1500:1501], x[1501:2000]]
    a = StreamingFlatIndex.build_from_blocks(iter(blocks), cfg, chunk_rows=1024, device="cpu")
    b = StreamingFlatIndex.build(x, cfg, chunk_rows=1024, device="cpu")
    assert a.n == 2000 and len(a.chunks) == 2
    assert all(torch.equal(c1, c2) for c1, c2 in zip(a.chunks, b.chunks))


def test_document_store_streaming():
    """``build_document_store(kind="streaming")`` at int8 serves the flat
    int8 store's documents (the same scan per chunk, the same
    quantization); adding or deleting documents fails, as in JAX."""
    emb = IDFHashingEmbedder.fit_chunks(parse_corpus_file(CORPUS))
    cfg = EngineConfig(dtype="int8")
    store = build_document_store(CORPUS, emb, cfg, kind="streaming", device="cpu")
    flat = build_document_store(CORPUS, emb, cfg, device="cpu")
    assert isinstance(store.index, StreamingFlatIndex)
    queries = ["高血压患者饮食注意什么", "糖尿病的早期症状", "感冒发烧怎么办"]
    got = [[d.metadata["chunk_id"] for d in row] for row in store.batch_search(queries, k=3)]
    assert got == [[d.metadata["chunk_id"] for d in row]
                   for row in flat.batch_search(queries, k=3)]
    with pytest.raises(AttributeError):
        store.add_documents([Chunk("live-1", "深海鱼油", "适量摄入深海鱼油。", "http", [])])
    with pytest.raises(AttributeError):
        store.delete_documents([got[0][0]])
