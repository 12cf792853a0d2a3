"""The trainers' data/model mesh of the port against the JAX package's, on the CPU.

The port runs one process per rank (``parallel.dist.launch``: 4 gloo
workers, dp=2 x tp=2, one torch thread each); JAX runs one controller over
``make_mesh({"data": 2, "model": 2})`` on the virtual CPU devices of
``tests/conftest.py``. Both start from the same JAX-drawn f32 parameters
(numpy) and take the same numpy batches, whose padding differs between
the two data ranks' rows. One worker group runs every case
(``tests/torch_mesh_workers.py``) while JAX computes its side:

- ``LMTrainer``: AdamW over a GQA decoder with q/k/v bias, flash
  attention (B6/B10a/B10b's plain versions on the local heads) and
  per-block recompute (its collectives run again in the backward), and
  Adafactor over a one-KV-head decoder (each KV head held by both model
  ranks), 2 steps each;
- ``LoraTrainer`` over the flash decoder, 2 steps;
- ``ContrastiveTrainer`` with hard negatives, 2 steps; and with dropout,
  against the one-process port only (JAX draws other masks);
- ``BertEncoder``'s forward over its shard.

Losses and gradient norms are within MESH_REL of the one-process port's
and within JAX_REL of JAX's mesh step; every parameter tensor, gathered
to JAX's layout, within the same bounds (relative Frobenius norm). Also:
``partition_specs`` of the three models and ``lora_partition_specs``
equal JAX's; ``TextEmbedder(mesh=)`` over two CPU devices against the
one-device port and JAX's; the Adafactor state of the tp=2 run and the
AdamW state of the contrastive run, saved, load whole (tp=1) and equal
the gathered state.
"""

import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_mesh_workers as workers
from mediquery_rag_tpu.config import BertEmbedderConfig as JBertConfig
from mediquery_rag_tpu.config import DecoderConfig, EmbedderConfig, LoraConfig, TrainConfig
from mediquery_rag_tpu.models import lora as jlora
from mediquery_rag_tpu.models import train_lm as jtrain
from mediquery_rag_tpu.models import trainer as jtrainer
from mediquery_rag_tpu.models.bert_encoder import BertEncoder as JBert
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.embedder import Embedder as JEmbedder
from mediquery_rag_tpu.models.text_embedder import TextEmbedder as JTextEmbedder
from mediquery_rag_tpu.parallel import make_mesh as jmake_mesh
from mediquery_rag_tpu_torch import config as tconfig
from mediquery_rag_tpu_torch.engine.checkpoint import load_train_state
from mediquery_rag_tpu_torch.models import bert_encoder as tbert
from mediquery_rag_tpu_torch.models import decoder as tdecoder
from mediquery_rag_tpu_torch.models import embedder as tembedder
from mediquery_rag_tpu_torch.models import lora as tlora
from mediquery_rag_tpu_torch.models import train_lm as ttrain
from mediquery_rag_tpu_torch.models import trainer as ttrainer
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.models.text_embedder import TextEmbedder
from mediquery_rag_tpu_torch.parallel import make_mesh
from mediquery_rag_tpu_torch.parallel.dist import launch, tree_get, tree_paths

MESH_REL = 1e-6      # the port's mesh step against its one-process step (f32 sums in another order)
JAX_REL = 1e-5       # against JAX's mesh step
GQA = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128,
                    max_len=256, qkv_bias=True, dtype="float32", attn_impl="flash")
MQA = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=1, mlp_dim=128,
                    max_len=256, dtype="float32", attn_impl="einsum")
ENC = EmbedderConfig(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32,
                     dtype="float32")
BERT = JBertConfig(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32,
                   dtype="float32")
TRAIN = TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=10, weight_decay=0.01, remat=True)
PLAIN = TrainConfig(**{**TRAIN.__dict__, "remat": False})     # JAX compiles it faster
FACTOR = TrainConfig(**{**PLAIN.__dict__, "optimizer": "adafactor"})
LORA = LoraConfig(rank=4, alpha=8.0)


def _t(cfg):
    """The port's config of the same name and fields."""
    return getattr(tconfig, type(cfg).__name__)(**cfg.__dict__)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _flat(tree) -> dict:
    return {p: np.asarray(tree_get(tree, p)) for p in tree_paths(tree)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _lm_batches(seed):
    """2 batches of 4 rows x 32: rows 0-1 (data rank 0) and 2-3 (rank 1)
    padded differently, so the ranks' masked counts differ."""
    rng = np.random.default_rng(seed)
    out = []
    for ends in ((32, 20), (9, 27)), ((25, 32), (32, 14)):
        ids = rng.integers(3, 259, (4, 32)).astype(np.int64)
        mask = np.zeros((4, 32), np.float32)
        for r, e in enumerate(sum(ends, ())):
            mask[r, :e] = 1.0
        out.append((ids, mask))
    return out


def _enc_batches(seed, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        arrays = []
        for _ in range(3):                       # q, d, n
            ids = rng.integers(1, ENC.vocab_size, (4, 16)).astype(np.int64)
            mask = (np.arange(16)[None] < rng.integers(4, 17, (4, 1))).astype(np.float32)
            arrays += [ids * mask.astype(np.int64), mask]
        out.append(tuple(arrays))
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    gqa = JDecoder(GQA).init(jax.random.PRNGKey(0))
    gqa["blocks"]["qkv_b"] = jnp.asarray(np.random.default_rng(3).standard_normal(
        gqa["blocks"]["qkv_b"].shape).astype(np.float32) * 0.1)
    gqa = _np(gqa)
    adapters = _np(jlora.lora_init(jax.random.PRNGKey(6), gqa, LORA))
    tmp = tmp_path_factory.mktemp("mesh")
    enc_batches = _enc_batches(1)
    bert_rng = np.random.default_rng(4)
    return {
        "lm_adamw": dict(kind="lm", cfg=_t(GQA), train=_t(TRAIN), params=gqa,
                         batches=_lm_batches(0)),
        "lm_adafactor": dict(kind="lm", cfg=_t(MQA), params=_np(JDecoder(MQA).init(
            jax.random.PRNGKey(1))), train=_t(FACTOR),
            batches=_lm_batches(2), save=str(tmp / "adafactor")),
        "lora": dict(kind="lora", cfg=_t(GQA), lora=_t(LORA), train=_t(PLAIN), params=gqa,
                     adapters=adapters, batches=_lm_batches(3)),
        "contrastive": dict(kind="contrastive", cfg=_t(ENC), train=_t(PLAIN),
                            params=_np(JEmbedder(ENC).init(jax.random.PRNGKey(2))),
                            batches=enc_batches, save=str(tmp / "contrastive")),
        "dropout": dict(kind="contrastive", cfg=tconfig.EmbedderConfig(
            **{**ENC.__dict__, "dropout": 0.1}), train=_t(TRAIN),
            params=_np(JEmbedder(ENC).init(jax.random.PRNGKey(2))), batches=enc_batches[:1]),
        "bert": dict(kind="bert", cfg=_t(BERT), params=_np(JBert(BERT).init(
            jax.random.PRNGKey(5))), ids=bert_rng.integers(1, 512, (3, 12)),
            mask=(np.arange(12)[None] < np.array([[12], [7], [3]])).astype(np.float32)),
    }


def _jax_mesh():
    return jmake_mesh({"data": 2, "model": 2})


def _placed(tree, specs, mesh):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)), tree, specs)


def _jax_lm(case, cfg, tcfg):
    mesh = _jax_mesh()
    jt = jtrain.LMTrainer(cfg, tcfg, mesh=mesh)
    params = _placed(case["params"], JDecoder(cfg).partition_specs(), mesh)
    state = jtrain.LMTrainState(params, jt.tx.init(params), jnp.int32(0))
    out = {"loss": [], "grad_norm": []}
    for ids, mask in case["batches"]:
        state, m = jt.train_step(state, jtrain.LMBatch(jnp.asarray(ids, jnp.int32),
                                                       jnp.asarray(mask)))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _flat(_np(state.params))
    return out


def _jax_lora(case):
    mesh = _jax_mesh()
    jt = jlora.LoraTrainer(GQA, LORA, PLAIN, mesh=mesh)
    base = _placed(case["params"], JDecoder(GQA).partition_specs(), mesh)
    ad = _placed(case["adapters"], jlora.lora_partition_specs(JDecoder(GQA), LORA), mesh)
    state = jlora.LoraTrainState(ad, jt.tx.init(ad), jnp.int32(0))
    out = {"loss": [], "grad_norm": [], "delta_norm": []}
    for ids, mask in case["batches"]:
        state, m = jt.train_step(state, base, jtrain.LMBatch(jnp.asarray(ids, jnp.int32),
                                                             jnp.asarray(mask)))
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = _flat(_np(state.adapters))
    return out


def _jax_contrastive(case):
    mesh = _jax_mesh()
    jt = jtrainer.ContrastiveTrainer(ENC, PLAIN, mesh=mesh)
    params = _placed(case["params"], JEmbedder(ENC).partition_specs(), mesh)
    state = jtrainer.TrainState(params, jt.tx.init(params), jnp.int32(0))
    out = {"loss": [], "grad_norm": []}
    for arrays in case["batches"]:
        state, m = jt.train_step(state, jtrainer.Batch(*map(jnp.asarray, arrays)))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _flat(_np(state.params))
    return out


def _close(got, want, rel, name, params_rel=None):
    for key in want:
        if key == "params":
            assert set(got[key]) == set(want[key]), name
            for p, w in want[key].items():
                err = _rel(got[key][p], w)
                assert err <= (params_rel or rel), (name, p, err)
        else:
            assert _rel(got[key], want[key]) <= rel, (name, key, got[key], want[key])


@pytest.fixture(scope="module")
def runs(cases):
    """(the mesh's results, the one-process port's, JAX's mesh steps): the
    port's mesh and JAX's compiles run in threads beside the one-process
    port."""
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        mesh = pool.submit(launch, workers.run_cases, 2, 2, cases, device="cpu", timeout=300)
        want = {"lm_adamw": pool.submit(_jax_lm, cases["lm_adamw"], GQA, TRAIN),
                "lm_adafactor": pool.submit(_jax_lm, cases["lm_adafactor"], MQA, FACTOR),
                "lora": pool.submit(_jax_lora, cases["lora"]),
                "contrastive": pool.submit(_jax_contrastive, cases["contrastive"])}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = workers.run_cases(None, {k: {**c, "save": None} for k, c in cases.items()})
        finally:
            torch.set_num_threads(n)
        return (workers.same_on_every_rank(mesh.result()), one,
                {k: f.result() for k, f in want.items()})


@pytest.mark.parametrize("name", ["lm_adamw", "lm_adafactor", "lora", "contrastive"])
def test_mesh_step_matches_one_process_and_jax(runs, name):
    """Every step's metrics within MESH_REL of the one-process port's, and
    the params too; LoRA's adapters within JAX_REL: they are the Adam
    updates themselves (b starts at 0), each ~lr * g / |g|, so they carry
    the gradients' relative f32 error (2.2e-6 measured), where a full
    model's params dilute it."""
    mesh, one, want = runs
    _close(mesh[name], one[name], MESH_REL, name, JAX_REL if name == "lora" else None)
    _close(mesh[name], want[name], JAX_REL, name)


def test_mesh_dropout_and_bert_match_one_process(runs):
    """Dropout masks: each data rank takes its rows of the global batch's;
    BERT: the row-parallel biases are added once, after the reduce."""
    mesh, one, _ = runs
    _close(mesh["dropout"], one["dropout"], MESH_REL, "dropout")
    assert _rel(mesh["bert"]["emb"], one["bert"]["emb"]) <= MESH_REL


@pytest.mark.parametrize("name", ["lm_adafactor", "contrastive"])
def test_mesh_train_state_loads_whole(runs, cases, name):
    """The tp=2 state, saved gathered in JAX's leaf order, loads at tp=1:
    its params equal the mesh's gathered params, and every optimizer
    tensor is within MESH_REL of the one-process run's state."""
    mesh = runs[0]
    case = cases[name]
    if case["kind"] == "lm":
        tr = ttrain.LMTrainer(case["cfg"], case["train"], device="cpu")
        template = tr.init_state(params=params_from_jax(case["params"], device="cpu"))
        step = ttrain.LMBatch
    else:
        tr = ttrainer.ContrastiveTrainer(case["cfg"], case["train"], device="cpu")
        template = tr.init_state(params=params_from_jax(case["params"], device="cpu"))
        step = ttrainer.Batch
    loaded = load_train_state(case["save"], template)
    assert loaded.step == len(case["batches"]) and loaded.params["blocks"]["qkv"].requires_grad
    for p, a in mesh[name]["params"].items():
        np.testing.assert_array_equal(tree_get(loaded.params, p).detach().numpy(), a)
    state = template
    for arrays in case["batches"]:
        state, _ = tr.train_step(state, step(*map(torch.from_numpy, arrays)))
    want, got = _tensors(state.opt_state), _tensors(loaded.opt_state)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g.numpy(), w.numpy()) <= MESH_REL


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x.detach()]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def test_partition_specs_equal_jax():
    def tup(tree):
        return {k: tup(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}

    for cfg in (GQA, MQA):
        assert tdecoder.partition_specs(_t(cfg)) == tup(JDecoder(cfg).partition_specs())
    assert tembedder.partition_specs(_t(ENC)) == tup(JEmbedder(ENC).partition_specs())
    assert tbert.partition_specs(_t(BERT)) == tup(JBert(BERT).partition_specs())
    want = jlora.lora_partition_specs(JDecoder(GQA), LORA)
    assert tlora.lora_partition_specs(_t(GQA), _t(LORA)) == tup(want)


@pytest.mark.parametrize("kv_heads", [4, 2, 1])
def test_head_sharding_follows_heads(kv_heads):
    """Decoder qkv (and BERT's, kv = heads): rank r holds its query heads'
    columns and the KV heads they read; ``gather`` restores JAX's fused
    order. JAX's even split of the fused columns would give rank 0 query
    columns only."""
    cfg = tconfig.DecoderConfig(**{**GQA.__dict__, "kv_heads": kv_heads})
    full = tdecoder.init_params(cfg, seed=0, device="cpu")
    H, dh = cfg.heads, cfg.hidden // cfg.heads
    qkv = full["blocks"]["qkv"]
    q, k, v = qkv.split([H * dh, kv_heads * dh, kv_heads * dh], dim=-1)
    for r in range(2):
        mesh = types.SimpleNamespace(tp=2, model_rank=r, model_group=None)
        local = tdecoder.decoder_layout(cfg, full, mesh).shard(full)["blocks"]["qkv"]
        kv = slice(r * kv_heads // 2 * dh, (r * kv_heads // 2 + max(kv_heads // 2, 1)) * dh)
        want = torch.cat([q[..., r * 2 * dh:(r + 1) * 2 * dh], k[..., kv], v[..., kv]], -1)
        assert torch.equal(local, want)


def test_text_embedder_over_a_mesh():
    """5 texts over 2 CPU devices (padded to 6 rows) equal the one-device
    port's and JAX's ``TextEmbedder(mesh=)`` within 1e-6."""
    params = _np(JEmbedder(ENC).init(jax.random.PRNGKey(2)))
    texts = ["高血压的饮食建议", "头痛", "糖尿病早期症状有哪些", "儿童咳嗽", "BMI"]
    one = TextEmbedder(_t(ENC), params_from_jax(params, device="cpu"), device="cpu")
    two = TextEmbedder(_t(ENC), params_from_jax(params, device="cpu"), device="cpu",
                       mesh=make_mesh({"data": 2}, devices=["cpu"] * 2))
    got = two.embed(texts)
    want = np.asarray(JTextEmbedder(ENC, params=jax.tree_util.tree_map(jnp.asarray, params),
                                    mesh=jmake_mesh({"data": 2})).embed(texts))
    assert got.shape == (5, 64)
    np.testing.assert_allclose(got, one.embed(texts), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)
