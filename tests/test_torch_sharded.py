"""Parity of the port's sharded retrieval path with the JAX package, on the CPU.

The JAX side runs on its 8-device virtual CPU mesh (``tests/conftest.py``);
the port's meshes hold the CPU eight times (``devices=[cpu] * 8``), so its
shards run the plain versions of the kernels they launch on the card. The
same numpy rows go into both packages:

- ``ShardedFlatIndex`` (bf16, f32, int8, int4) over ``corpus_mesh(8)`` and
  ``slice_mesh(2, 4)``, 3,000 rows x 64 in tiles of 512, so the last two
  of eight shards hold no valid row: ids equal JAX's, scores within the
  tolerances below, and bit-equal to the port's one-device ``FlatIndex``;
- ``ShardedIVFIndex.from_single`` over a JAX-saved ``IVFIndex`` (bf16,
  int8, int4), query-major and bucket-major, and a batch whose probes all
  lie on one shard (the JAX test's worst-case skew);
- ``build_document_store(kind="sharded")`` against JAX's;
- the merge: ties by (score desc, id asc), the flat and hierarchical
  merges equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import EngineConfig as JEngineConfig
from mediquery_rag_tpu.engine import IVFIndex as JIVFIndex
from mediquery_rag_tpu.engine import ShardedFlatIndex as JShardedFlat
from mediquery_rag_tpu.engine.sharded_ivf import ShardedIVFIndex as JShardedIVF
from mediquery_rag_tpu.ingest import build_document_store as jbuild_store
from mediquery_rag_tpu.ingest.parser import parse_corpus_file as jparse
from mediquery_rag_tpu.models.lexical import IDFHashingEmbedder as JIDF
from mediquery_rag_tpu.parallel import corpus_mesh as jcorpus_mesh
from mediquery_rag_tpu.parallel import slice_mesh as jslice_mesh
from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine import (
    FlatIndex, IVFIndex, ShardedFlatIndex, ShardedIVFIndex)
from mediquery_rag_tpu_torch.ingest import build_document_store, parse_corpus_file
from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
from mediquery_rag_tpu_torch.ops.topk import merge_topk_many
from mediquery_rag_tpu_torch.parallel import (
    corpus_mesh, grouped_topk_merge, hierarchical_topk_merge, sharded_topk_merge, slice_mesh)

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                      "medical_data.txt")
N, D, TILE = 3000, 64, 512          # 8 x 512 = 4096 rows: shards 6 and 7 hold none
CPU8 = [torch.device("cpu")] * 8
# f32 sums in another order on unit rows of D = 64 (float dtypes); int8/int4:
# exact integer sums times scales, the query scale computed by each framework
SCORE_TOL = 1e-5
INT_REL_TOL = 1e-6


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(170)
    rows = _unit(rng.standard_normal((N, D)))
    # queries near rows spread over every valid shard
    q = _unit(rows[:: N // 6][:6] + 0.1 * rng.standard_normal((6, D)))
    return rows, q


def _meshes(kind):
    if kind == "corpus":
        return jcorpus_mesh(8), corpus_mesh(8, devices=CPU8), ""
    return jslice_mesh(2, 4), slice_mesh(2, 4, devices=CPU8), "dcn"


def _close(got, want, dtype):
    if dtype in ("int8", "int4"):
        np.testing.assert_allclose(got, want, rtol=INT_REL_TOL, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("mesh_kind", ["corpus", "slice"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_sharded_flat_matches_jax(data, dtype, mesh_kind):
    rows, q = data
    jmesh, tmesh, dcn = _meshes(mesh_kind)
    kw = dict(dim=D, dtype=dtype, corpus_tile=TILE, dcn_axis=dcn)
    want_s, want_i = JShardedFlat.build(jnp.asarray(rows), jmesh, JEngineConfig(**kw)).search(
        jnp.asarray(q), k=10)
    idx = ShardedFlatIndex.build(rows, tmesh, EngineConfig(**kw))
    assert len(idx.shards) == 8 and idx.per_shard == TILE and idx.n == N
    s, i = idx.search(q, k=10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    _close(s.numpy(), np.asarray(want_s), dtype)
    # sharding changes nothing: the one-device scan of the same rows
    one_s, one_i = FlatIndex.build(rows, EngineConfig(**kw), device="cpu").search(q, k=10)
    assert torch.equal(i, one_i) and torch.equal(s, one_s)


def test_sharded_flat_short_corpus_and_empty_shards():
    """Fewer valid rows than k over a mesh where most shards are empty:
    the valid rows first, then (-inf, id 0); a 1-D query gives 1-D lists."""
    rows = _unit(np.random.default_rng(1).standard_normal((5, D)))
    idx = ShardedFlatIndex.build(rows, corpus_mesh(4, devices=CPU8[:4]),
                                 EngineConfig(dim=D, dtype="int8", corpus_tile=64))
    s, i = idx.search(rows[2], k=8)
    assert s.shape == (8,) and i[0] == 2
    assert torch.isfinite(s[:5]).all() and (s[5:] == float("-inf")).all()
    assert sorted(i[:5].tolist()) == list(range(5)) and (i[5:] == 0).all()


@pytest.fixture(scope="module")
def ivf_pair(tmp_path_factory):
    """JAX-built IVF indexes (nlist 16 -> 2 clusters a shard), saved by JAX
    and loaded by the port: the same buckets in both packages."""
    rng = np.random.default_rng(171)
    centers = rng.standard_normal((24, D))
    rows = _unit(centers[rng.integers(0, 24, 2000)] + 0.4 * rng.standard_normal((2000, D)))
    out = {}
    for dtype in ("bfloat16", "int8", "int4"):
        cfg = JEngineConfig(dim=D, dtype=dtype, ivf_nlist=16, ivf_kmeans_iters=3)
        jbase = JIVFIndex.build(jnp.asarray(rows), cfg, key=jax.random.PRNGKey(3))
        path = str(tmp_path_factory.mktemp(f"ivf_{dtype}"))
        jbase.save(path)
        out[dtype] = (jbase, IVFIndex.load(path, device="cpu"))
    q = _unit(rows[::250][:8] + 0.1 * rng.standard_normal((8, D)))
    return out, q


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_sharded_ivf_matches_jax(ivf_pair, dtype, batched):
    pair, q = ivf_pair
    jbase, tbase = pair[dtype]
    jidx = JShardedIVF.from_single(jbase, jcorpus_mesh(8))
    idx = ShardedIVFIndex.from_single(tbase, corpus_mesh(8, devices=CPU8))
    assert idx.per_shard == jidx.per_shard == 2 and idx.nlist == 16
    assert [int(e[-1]) for e in idx.extent] == [0] * 8          # the sentinels
    want_s, want_i = jidx.search(jnp.asarray(q), k=10, nprobe=4, batched=batched)
    s, i = idx.search(q, k=10, nprobe=4, batched=batched)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    _close(s.numpy(), np.asarray(want_s), dtype)
    # and the one-device index's kernel output (no rerank), bit for bit
    one_s, one_i = tbase.search(q, k=10, nprobe=4, batched=batched)
    assert torch.equal(i, one_i) and torch.equal(s, one_s)


@pytest.mark.parametrize("dtype", ["bfloat16", "int4"])
def test_sharded_ivf_all_probes_on_one_shard(ivf_pair, dtype):
    """Every probe of the batch lies on shard 0, so the other seven scan
    only their sentinel, in both layouts (tests/test_scale_mesh.py:109)."""
    pair, _ = ivf_pair
    jbase, tbase = pair[dtype]
    cents = tbase.centroids.numpy()
    q = _unit(cents[[0, 1, 0, 1]] + 0.01 * np.random.default_rng(2).standard_normal((4, D)))
    assert (np.argmax(q @ cents.T, axis=1) < 2).all()
    jidx = JShardedIVF.from_single(jbase, jcorpus_mesh(8))
    idx = ShardedIVFIndex.from_single(tbase, corpus_mesh(8, devices=CPU8))
    for batched in (False, True):
        want_s, want_i = jidx.search(jnp.asarray(q), k=10, nprobe=1, batched=batched)
        s, i = idx.search(q, k=10, nprobe=1, batched=batched)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        _close(s.numpy(), np.asarray(want_s), dtype)


def test_sharded_document_store_matches_jax():
    """``build_document_store(kind="sharded")`` over the corpus file serves
    the same hits as JAX's sharded store (same IDF embedder, bf16 rows)."""
    queries = ["高血压 饮食 限盐", "糖尿病 运动", "感冒 发烧 怎么办"]
    jstore = jbuild_store(CORPUS, JIDF.fit_chunks(jparse(CORPUS)), kind="sharded",
                          mesh=jcorpus_mesh(8))
    store = build_document_store(CORPUS, IDFHashingEmbedder.fit_chunks(parse_corpus_file(CORPUS)),
                                 kind="sharded", mesh=corpus_mesh(8, devices=CPU8))
    assert isinstance(store.index, ShardedFlatIndex)
    for got, want in zip(store.batch_search(queries, k=4), jstore.batch_search(queries, k=4)):
        assert [d.text for d in got] == [d.text for d in want]
        np.testing.assert_allclose([d.score for d in got], [d.score for d in want],
                                   rtol=0, atol=SCORE_TOL)


def test_merges_order_ties_by_id_and_agree():
    """Tied scores across shards come out id-ascending whatever the shard
    order, and the flat and hierarchical merges give the same lists."""
    s = torch.tensor([[[0.5, 0.2]], [[0.5, 0.4]], [[0.9, 0.5]], [[0.1, -1.0]]])
    i = torch.tensor([[[30, 31]], [[7, 8]], [[12, 40]], [[3, 4]]], dtype=torch.int32)
    vals, ids = merge_topk_many(s, i, 4)
    assert torch.equal(vals, torch.tensor([[0.9, 0.5, 0.5, 0.5]]))
    assert ids.tolist() == [[12, 7, 30, 40]]
    flat = sharded_topk_merge(list(s), list(i), 4)
    hier = hierarchical_topk_merge(list(s), list(i), 4, groups=2)
    assert all(torch.equal(a, b) for a, b in zip(flat, hier))
    mesh = slice_mesh(2, 2, devices=CPU8[:4])
    grouped = grouped_topk_merge(list(s), list(i), 4, mesh, ("dcn", "shard"))
    assert all(torch.equal(a, b) for a, b in zip(flat, grouped))
    assert mesh.shape == {"dcn": 2, "shard": 2} and mesh.size == 4
