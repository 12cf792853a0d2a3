"""Checkpoints of the port's sharded indexes and trainer state, on the CPU.

``save_sharded_index``/``load_sharded_index`` and
``save_sharded_ivf``/``load_sharded_ivf`` round trips for every storage
type, saved on 8 shards and loaded onto 2, then saved on 2 and loaded onto
1 (the load splits the rows again): every search equals the first index's,
bit for bit. ``save_train_state``/``load_train_state``: a
``ContrastiveTrainer`` step resumed from a checkpoint equals the
uninterrupted step (loss, grad norm and every parameter bit for bit), as
the JAX package's ``tests/test_checkpoint.py:69`` resumes. The meshes hold
the CPU several times (``devices=[cpu] * n``).
"""

import json
import os

import numpy as np
import pytest
import torch

from mediquery_rag_tpu_torch.config import EmbedderConfig, EngineConfig, TrainConfig
from mediquery_rag_tpu_torch.engine import IVFIndex, ShardedFlatIndex, ShardedIVFIndex
from mediquery_rag_tpu_torch.engine.checkpoint import (
    load_sharded_index, load_sharded_ivf, load_train_state, save_sharded_index,
    save_sharded_ivf, save_train_state)
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.embedder import load_params
from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
from mediquery_rag_tpu_torch.models.trainer import Batch, ContrastiveTrainer
from mediquery_rag_tpu_torch.parallel import corpus_mesh, slice_mesh

CPU = torch.device("cpu")
D = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test processes share the cores: torch runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(172)
    x = _unit(rng.standard_normal((2001, D)))      # odd: int4's last pair is half pad
    return x, _unit(x[::400] + 0.1 * rng.standard_normal((6, D)))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_sharded_flat_roundtrip_across_mesh_sizes(rows, dtype, tmp_path):
    x, q = rows
    cfg = EngineConfig(dim=D, dtype=dtype, corpus_tile=256)
    idx = ShardedFlatIndex.build(x, corpus_mesh(8, devices=[CPU] * 8), cfg)
    want = idx.search(q, k=10)
    save_sharded_index(idx, str(tmp_path / "s8"))
    with open(tmp_path / "s8" / "meta.json") as f:
        meta = json.load(f)
    assert meta["kind"] == "sharded_flat" and meta["shards"] == 8 and meta["n"] == 2001
    two = load_sharded_index(str(tmp_path / "s8"), corpus_mesh(2, devices=[CPU] * 2))
    assert len(two.shards) == 2 and two.n == 2001 and two.cfg == idx.cfg
    assert _equal(two.search(q, k=10), want)
    save_sharded_index(two, str(tmp_path / "s2"))
    one = load_sharded_index(str(tmp_path / "s2"), corpus_mesh(1, devices=[CPU]))
    assert len(one.shards) == 1 and one.nbytes <= idx.nbytes
    assert _equal(one.search(q, k=10), want)


def test_sharded_flat_loads_onto_a_slice_mesh(rows, tmp_path):
    x, q = rows
    cfg = EngineConfig(dim=D, dtype="int8", corpus_tile=256)
    idx = ShardedFlatIndex.build(x, corpus_mesh(8, devices=[CPU] * 8), cfg)
    save_sharded_index(idx, str(tmp_path / "s"))
    meta = json.load(open(tmp_path / "s" / "meta.json"))
    meta["cfg"]["dcn_axis"] = "dcn"
    json.dump(meta, open(tmp_path / "s" / "meta.json", "w"))
    sl = load_sharded_index(str(tmp_path / "s"), slice_mesh(2, 2, devices=[CPU] * 4))
    assert len(sl.shards) == 4 and _equal(sl.search(q, k=10), idx.search(q, k=10))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_sharded_ivf_roundtrip_across_mesh_sizes(rows, dtype, tmp_path):
    x, q = rows
    base = IVFIndex.build(x, EngineConfig(dim=D, dtype=dtype, ivf_nlist=16, ivf_kmeans_iters=3),
                          device="cpu")
    idx = ShardedIVFIndex.from_single(base, corpus_mesh(8, devices=[CPU] * 8))
    want = {b: idx.search(q, k=10, nprobe=4, batched=b) for b in (False, True)}
    save_sharded_ivf(idx, str(tmp_path / "s8"))
    assert json.load(open(tmp_path / "s8" / "meta.json"))["kind"] == "sharded_ivf"
    two = load_sharded_ivf(str(tmp_path / "s8"), corpus_mesh(2, devices=[CPU] * 2))
    assert two.per_shard == 8 and len(two.buckets) == 2
    save_sharded_ivf(two, str(tmp_path / "s2"))
    one = load_sharded_ivf(str(tmp_path / "s2"), corpus_mesh(1, devices=[CPU]))
    assert one.per_shard == 16 and one.n == base.n and one.cap == base.cap
    for b in (False, True):
        assert _equal(two.search(q, k=10, nprobe=4, batched=b), want[b])
        assert _equal(one.search(q, k=10, nprobe=4, batched=b), want[b])


def test_index_loaders_refuse_other_checkpoints(tmp_path):
    os.makedirs(tmp_path / "o")
    json.dump({"kind": "sharded_flat", "n": 3, "cfg": {}}, open(tmp_path / "o" / "meta.json", "w"))
    with pytest.raises(ValueError, match="orbax"):
        load_sharded_index(str(tmp_path / "o"), corpus_mesh(1, devices=[CPU]))
    with pytest.raises(ValueError, match="sharded_ivf"):
        load_sharded_ivf(str(tmp_path / "o"), corpus_mesh(1, devices=[CPU]))


def test_resumed_contrastive_step_equals_uninterrupted(tmp_path):
    cfg = EmbedderConfig(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128,
                         max_len=128, dtype="float32")
    tr = ContrastiveTrainer(cfg, TrainConfig(remat=False, warmup_steps=1), device="cpu")
    tok = HashCharTokenizer(512, 128)
    q_ids, q_mask = tok.batch_encode([f"问题 {i}" for i in range(8)])
    d_ids, d_mask = tok.batch_encode([f"文档 {i} 内容" for i in range(8)])
    batch = Batch(*(torch.as_tensor(np.asarray(t)) for t in (q_ids, q_mask, d_ids, d_mask)))
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr.train_step(state, batch)
    save_train_state(state, str(tmp_path / "ts"))
    template = tr.init_state(torch.Generator().manual_seed(1))
    restored = load_train_state(str(tmp_path / "ts"), template)
    assert restored.step == 1
    for a, b in zip(optim.tree_leaves(restored.params), optim.tree_leaves(state.params)):
        assert torch.equal(a, b) and a.requires_grad
    # params.npz is the encoders' checkpoint file: it loads as one
    loaded = load_params(str(tmp_path / "ts"), state.params, "cpu")
    assert _equal(optim.tree_leaves(loaded), optim.tree_leaves(state.params))
    # the uninterrupted second step, then the resumed one (params update in place)
    snapshot = [t.detach().clone() for t in optim.tree_leaves(state.params)]
    state2, m = tr.train_step(state, batch)
    resumed2, rm = tr.train_step(restored, batch)
    assert state2.step == resumed2.step == 2
    assert torch.equal(m["loss"], rm["loss"]) and torch.equal(m["grad_norm"], rm["grad_norm"])
    for a, b, before in zip(optim.tree_leaves(resumed2.params),
                            optim.tree_leaves(state2.params), snapshot):
        assert torch.equal(a, b) and not torch.equal(a, before)
