"""Parity of the PyTorch port's serving slice with the JAX package, on the CPU.

Copied modules give identical outputs; the flat index and document store
return the same documents; a tiny decoder (hidden 64, 2 layers, 4q/2kv,
byte vocabulary, q/k/v bias, flash attention) converted from JAX params
gives the same logits and greedy tokens, float and int8; and the port's
``SearchServer`` + Self-RAG graph serve /search and /qa over HTTP from the
port's store and decoder. The port imports nothing of the JAX package and
its entry points default to the card. Inputs come from
``np.random.default_rng`` or the repo's corpus; tolerances are stated per
test. Every port call here passes ``device="cpu"``.
"""

import ast
import inspect
import json
import os
import shutil
import subprocess
import sys
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import DecoderConfig, EngineConfig
from mediquery_rag_tpu.engine.flat import FlatIndex as JFlatIndex
from mediquery_rag_tpu.ingest import build_document_store as jbuild_store
from mediquery_rag_tpu.ingest.parser import parse_corpus_file as jparse
from mediquery_rag_tpu.llm.messages import ai, system, user
from mediquery_rag_tpu.llm.tpu_client import _cut_turn as jcut, render_chat as jrender
from mediquery_rag_tpu.models.byte_tokenizer import ByteTokenizer as JByteTok
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.generate import Generator as JGenerator
from mediquery_rag_tpu.models.hash_embedder import HashingEmbedder as JHashEmb
from mediquery_rag_tpu.models.lexical import IDFHashingEmbedder as JIDF
from mediquery_rag_tpu.ops.matvec import quantize_decoder_params as jquantize
from mediquery_rag_tpu_torch.config import DecoderConfig as TDecoderConfig
from mediquery_rag_tpu_torch.config import EngineConfig as TEngineConfig
from mediquery_rag_tpu_torch.engine.flat import FlatIndex
from mediquery_rag_tpu_torch.ingest import build_document_store, parse_corpus_file
from mediquery_rag_tpu_torch.llm import TorchLLMClient
from mediquery_rag_tpu_torch.llm.torch_client import _cut_turn, render_chat
from mediquery_rag_tpu_torch.models import (
    ByteTokenizer, Decoder, Generator, HashingEmbedder, IDFHashingEmbedder)
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.serve import build_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
QUERIES = ["高血压患者饮食注意什么", "糖尿病的早期症状", "感冒发烧怎么办",
           "儿童咳嗽用药", "胃痛"]
TINY = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
                     mlp_dim=128, max_len=512, qkv_bias=True, dtype="float32",
                     attn_impl="flash")
TTINY = TDecoderConfig(**TINY.__dict__)       # the same config, the port's class


# -- copied modules: identical outputs -----------------------------------------

def test_parse_corpus_file_equal():
    want, got = jparse(CORPUS), parse_corpus_file(CORPUS)
    assert len(got) == len(want) > 100
    for a, b in zip(want, got):
        assert (a.chunk_id, a.title, a.content, a.source, a.tags, a.text,
                a.metadata) == (b.chunk_id, b.title, b.content, b.source,
                                b.tags, b.text, b.metadata)


@pytest.fixture(scope="module")
def embedders():
    return (JIDF.fit_chunks(jparse(CORPUS)),
            IDFHashingEmbedder.fit_chunks(parse_corpus_file(CORPUS)))


def test_idf_embedder_bit_equal(embedders):
    jemb, temb = embedders
    np.testing.assert_array_equal(jemb(QUERIES), temb(QUERIES))
    chunks_j, chunks_t = jparse(CORPUS)[:20], parse_corpus_file(CORPUS)[:20]
    np.testing.assert_array_equal(jemb.embed_docs(chunks_j),
                                  temb.embed_docs(chunks_t))


def test_hashing_embedder_bit_equal():
    np.testing.assert_array_equal(JHashEmb(128)(QUERIES), HashingEmbedder(128)(QUERIES))


def test_byte_tokenizer_equal():
    texts = ["你好", "hello world", "高血压" * 100, ""]
    for max_len in (512, 64):
        jids, jm = JByteTok(max_len).batch_encode(texts)
        tids, tm = ByteTokenizer(max_len).batch_encode(texts)
        np.testing.assert_array_equal(jids, tids)
        np.testing.assert_array_equal(jm, tm)
    ids = np.random.default_rng(0).integers(0, 384, 200)
    assert JByteTok().decode(ids) == ByteTokenizer().decode(ids)


def test_render_chat_and_cut_turn_equal():
    convs = ["单条问题", [system("你是医生"), user("头痛怎么办")],
             [user("问"), ai("答"), user("再问")]]
    for template in ("plain", "chatml"):
        for c in convs:
            assert render_chat(c, template=template) == jrender(c, template=template)
        train = [user("问"), ai("答")]
        assert (render_chat(train, for_training=True, template=template)
                == jrender(train, for_training=True, template=template))
        for out in ("  答案<|end|>其他", "a<|user|>b", "x<|im_end|>y", "plain  "):
            assert _cut_turn(out, template) == jcut(out, template)


# -- engine and store ------------------------------------------------------------

def test_flat_index_cross_load(tmp_path):
    """An index built and saved by JAX (bf16, cosine) loads in the port and
    returns the same ids; scores within 1e-2 (queries normalized by each
    framework, then rounded to bf16)."""
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((700, 96)).astype(np.float32)
    q = rng.standard_normal((6, 96)).astype(np.float32)
    jidx = JFlatIndex.build(vecs, EngineConfig(dim=96))
    jidx.save(str(tmp_path / "j"))
    tidx = FlatIndex.load(str(tmp_path / "j"), device="cpu")
    assert tidx.n == 700 and tidx.corpus.dtype == torch.bfloat16
    js, ji = jidx.search(q, k=8)
    ts, ti = tidx.search(q, k=8)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=1e-2)
    # and back: the port's save loads in JAX with the same rows
    tidx.save(str(tmp_path / "t"))
    back = JFlatIndex.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.corpus.astype(jnp.float32)),
                                  tidx.corpus.float().numpy())
    s1, i1 = tidx.search(q[0], k=3)         # 1-D query squeezes
    assert s1.shape == (3,) and i1.shape == (3,)


def test_flat_index_build_matches_jax():
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((300, 64)).astype(np.float32)
    for dtype in ("float32", "bfloat16", "int8", "int4"):
        j = JFlatIndex.build(vecs, EngineConfig(dim=64, dtype=dtype))
        t = FlatIndex.build(vecs, TEngineConfig(dim=64, dtype=dtype), device="cpu")
        assert j.corpus.shape == tuple(t.corpus.shape)
        assert j.cfg.__dict__ == t.cfg.__dict__
        if dtype in ("int8", "int4"):       # codes equal; test_torch_quant.py has the rest
            np.testing.assert_array_equal(np.asarray(j.corpus), t.corpus.numpy())
            continue
        np.testing.assert_allclose(np.asarray(j.corpus.astype(jnp.float32)),
                                   t.corpus.float().numpy(), rtol=8e-3, atol=1e-7)
    with pytest.raises(ValueError):
        FlatIndex.build(vecs, TEngineConfig(dim=64, dtype="float16"), device="cpu")


@pytest.fixture(scope="module")
def stores(embedders):
    jemb, temb = embedders
    return (jbuild_store(CORPUS, jemb, EngineConfig()),
            build_document_store(CORPUS, temb, TEngineConfig(), device="cpu"))


def _doc_ids(rows):
    return [[d.metadata["chunk_id"] for d in row] for row in rows]


def test_document_store_batch_search_equal(stores):
    jstore, tstore = stores
    assert _doc_ids(jstore.batch_search(QUERIES, k=5)) == _doc_ids(
        tstore.batch_search(QUERIES, k=5))
    where = {"tags": "高血压"}
    assert _doc_ids(jstore.batch_search(QUERIES[:2], k=3, where=where)) == \
        _doc_ids(tstore.batch_search(QUERIES[:2], k=3, where=where))


def test_document_store_save_load(stores, tmp_path, embedders):
    from mediquery_rag_tpu_torch.ingest import DocumentStore
    _, tstore = stores
    tstore.save(str(tmp_path / "store"))
    back = DocumentStore.load(str(tmp_path / "store"), embedders[1], device="cpu")
    assert _doc_ids(back.batch_search(QUERIES, k=5)) == _doc_ids(
        tstore.batch_search(QUERIES, k=5))
    with pytest.raises(ValueError):
        DocumentStore.load(str(tmp_path / "store"), HashingEmbedder(64), device="cpu")


# -- decoder ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    params = JDecoder(TINY).init(jax.random.PRNGKey(0))
    qkv_b = np.random.default_rng(3).standard_normal(
        params["blocks"]["qkv_b"].shape).astype(np.float32) * 0.1
    params["blocks"]["qkv_b"] = jnp.asarray(qkv_b)   # non-zero biases
    return params


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("quant", [False, True])
def test_decoder_prefill_and_decode_match_jax(jax_params, quant):
    """f32 prefill logits and 8 greedy decode steps within 1e-4 (f32 sums in
    another order; int8: exact integer matvec on both sides)."""
    params = jquantize(jax_params) if quant else jax_params
    jdec = JDecoder(TINY)
    tdec = Decoder(TTINY, params_from_jax(_np_tree(params), device="cpu"))
    rng = np.random.default_rng(4)
    B, S = 2, 128
    ids = rng.integers(3, 259, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    ids[1, :50], mask[1, :50] = 0, 0.0          # left padding
    jl, jc = jdec.prefill(params, jnp.asarray(ids), jnp.asarray(mask), 256)
    tl, tc = tdec.prefill(torch.from_numpy(ids), torch.from_numpy(mask), 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(8):
        jl, jc = jdec.decode_step(params, jc, jnp.asarray(tok))
        tl = tdec.decode_step(tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tc.cursor == S + 8 and tc.next_pos.tolist() == [S + 8, S - 50 + 8]


def test_decoder_einsum_attention_matches_jax(jax_params):
    cfg = DecoderConfig(**{**TINY.__dict__, "attn_impl": "einsum"})
    jdec = JDecoder(cfg)
    tdec = Decoder(TDecoderConfig(**cfg.__dict__),
                   params_from_jax(_np_tree(jax_params), device="cpu"))
    ids = np.random.default_rng(5).integers(3, 259, (1, 128)).astype(np.int32)
    mask = np.ones((1, 128), np.float32)
    jl, jc = jdec.prefill(jax_params, jnp.asarray(ids), jnp.asarray(mask), 256)
    tl, tc = tdec.prefill(torch.from_numpy(ids), torch.from_numpy(mask), 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    jl, _ = jdec.decode_step(jax_params, jc, jnp.asarray([7], jnp.int32))
    tl = tdec.decode_step(tc, torch.tensor([7]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


PROMPTS = ["<|user|>\n高血压患者饮食注意什么？<|end|><|assistant|>\n", "hello"]


@pytest.mark.parametrize("quant", [False, True])
def test_generator_greedy_tokens_equal(jax_params, quant):
    jgen = JGenerator(TINY, params=jax_params)
    tgen = Generator(TTINY, params_from_jax(_np_tree(jax_params), device="cpu"),
                     device="cpu")
    if quant:
        jgen.quantize_weights(bits=8)
        tgen.quantize_weights(bits=8)
    assert jgen.generate(PROMPTS, max_new_tokens=16) == tgen.generate(
        PROMPTS, max_new_tokens=16)


def test_generator_from_jax_checkpoint(jax_params, tmp_path):
    jgen = JGenerator(TINY, params=jax_params)
    jgen.save(str(tmp_path))
    tgen = Generator.from_checkpoint(str(tmp_path), device="cpu")
    assert jgen.generate(PROMPTS, max_new_tokens=16) == tgen.generate(
        PROMPTS, max_new_tokens=16)


def test_generator_sampling_and_limits():
    gen = Generator(TTINY, seed=1, device="cpu")
    a = gen.generate(PROMPTS, max_new_tokens=8, temperature=1.0, seed=3)
    assert a == gen.generate(PROMPTS, max_new_tokens=8, temperature=1.0, seed=3)
    assert gen.generate([], max_new_tokens=4) == []
    with pytest.raises(ValueError):                 # no room under max_len
        gen.generate(["x" * 600], max_new_tokens=4)
    # a schema is compiled once per client, and the reply is valid JSON of it
    from mediquery_rag_tpu_torch.models.constrain import RISK_SCHEMA
    llm = TorchLLMClient(gen)
    out = [llm.complete("问", schema=RISK_SCHEMA) for _ in range(2)]
    (c,) = llm._constraints.values()
    assert out[0] == out[1] and c.accepts(out[0])
    assert set(json.loads(out[0])) == {"risk", "severity", "reason"}


# -- the slice over HTTP -------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_search_and_qa_over_http(stores, jax_params):
    """/search returns the JAX store's documents; /qa answers through the
    port's decoder and its copy of the Self-RAG graph."""
    jstore, tstore = stores
    # /qa prompts carry retrieved chunks (~700 bytes each): room for 5
    cfg = TDecoderConfig(**{**TINY.__dict__, "max_len": 8192})
    llm = TorchLLMClient(Generator(cfg, params_from_jax(_np_tree(jax_params), device="cpu"),
                                   device="cpu"),
                         max_new_tokens=16)
    server = build_server(tstore, llm)
    port = server.start("127.0.0.1", 0)
    try:
        status, body = _post(port, "/search", {"queries": QUERIES, "k": 5})
        assert status == 200
        got = [[d["metadata"]["chunk_id"] for d in row] for row in body["results"]]
        assert got == _doc_ids(jstore.batch_search(QUERIES, k=5))
        status, body = _post(port, "/qa", {"question": QUERIES[0]})
        assert status == 200
        assert isinstance(body["answer"], str) and body["answer"]
        assert isinstance(body["docs"], list) and len(body["docs"]) == 5
    finally:
        server.shutdown()


def test_app_context_build_and_graph(tmp_path, monkeypatch):
    """The port's AppContext on a copy of the corpus, with the scripted
    fake LLM: builds (then reloads) the flat store and answers via the
    graph; ``MEDIQUERY_INDEX=ivf`` rebuilds it as an IVF store, a flat
    request rebuilds it as flat, an unknown kind is refused, and an int4
    IVF store with the rerank (split-half packed buckets) finds the IVF
    store's documents."""
    from mediquery_rag_tpu_torch.cli.context import AppContext
    os.makedirs(tmp_path / "data")
    shutil.copy(CORPUS, tmp_path / "data" / "medical_data.txt")
    monkeypatch.chdir(tmp_path)
    for name in ("MEDIQUERY_INDEX", "MEDIQUERY_HF_EMBEDDER", "MEDIQUERY_HYBRID",
                 "MEDIQUERY_HF_LLM", "TAVILY_API_KEY"):
        monkeypatch.delenv(name, raising=False)
    ctx = AppContext.build(str(tmp_path), fake_llm=True, device="cpu")
    assert ctx.store.live_count == len(parse_corpus_file(CORPUS))
    again = AppContext.build(str(tmp_path), fake_llm=True, device="cpu")
    assert _doc_ids(again.store.batch_search(QUERIES, k=3)) == _doc_ids(
        ctx.store.batch_search(QUERIES, k=3))
    events = list(ctx.graph_app.stream(
        {"messages": [user(QUERIES[0])], "user_id": "anonymous"}, thread_id="t1"))
    assert events[-1][1]["final_answer"]
    # MEDIQUERY_INDEX=ivf: the saved flat index is rebuilt as IVF, and back
    from mediquery_rag_tpu_torch.engine import IVFIndex
    monkeypatch.setenv("MEDIQUERY_INDEX", "ivf")
    ivf = AppContext.build(str(tmp_path), fake_llm=True, device="cpu")
    assert isinstance(ivf.store.index, IVFIndex)
    hits = ivf.store.similarity_search("高血压 饮食 限盐", k=3)
    assert any("高血压" in d.text for d in hits)
    monkeypatch.delenv("MEDIQUERY_INDEX")
    flat = AppContext.build(str(tmp_path), fake_llm=True, device="cpu", index_kind="flat")
    assert isinstance(flat.store.index, FlatIndex)
    with pytest.raises(ValueError, match="index_kind"):
        AppContext.build(str(tmp_path), fake_llm=True, device="cpu", index_kind="hnsw")
    int4 = build_document_store(CORPUS, ivf.embedder, TEngineConfig(dtype="int4",
                                                                   rerank_factor=4),
                                kind="ivf", device="cpu")
    assert isinstance(int4.index, IVFIndex) and int4.index.buckets.shape[0] == (
        int4.index.nlist * int4.index.cap // 2)
    assert _doc_ids(int4.batch_search(QUERIES, k=3)) == _doc_ids(
        ivf.store.batch_search(QUERIES, k=3))


def test_serve_main_rejects_draft(tmp_path):
    """``--draft`` takes a ``Generator.save`` directory (served by
    ``tests/test_torch_spec.py``) or an HF checkpoint directory (loaded by
    ``tests/test_torch_hf.py``); before anything is built, ``serve.main``
    rejects a directory without a config and an HF directory without
    weights."""
    from mediquery_rag_tpu_torch.serve.server import main
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen2"}))
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        main(["--draft", str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        main(["--draft", str(tmp_path / "missing"), "--device", "cpu"])


_BLOCKED_RUN = r"""
import importlib, json, pkgutil, sys, urllib.error, urllib.request
for name in ("jax", "mediquery_rag_tpu", "regex", "ml_dtypes", "transformers", "tokenizers"):
    sys.modules[name] = None
import mediquery_rag_tpu_torch as p
mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")
        if not m.name.endswith("__main__")]
for m in mods:
    importlib.import_module(m)
assert len(mods) > 40, mods
for m in ("engine.ivf", "ops.ivf_kernel", "ops.kmeans", "engine.tuning",
          "engine.streaming", "models.constrain", "models.optim", "models.train_lm",
          "models.lora", "models.speculative", "models.distill", "models.bpe_tokenizer",
          "models.wordpiece_tokenizer", "models.bert_encoder", "models.hf_import",
          "app.risk", "app.consultation", "cli.interface", "ops.matmul",
          "native.tokenizer", "models.tokenizer", "models.embedder",
          "models.text_embedder", "models.hybrid_embedder", "models.eval",
          "models.cross_encoder", "models.data", "models.trainer", "models.train",
          "models.train_grader", "engine.sharded", "engine.sharded_ivf",
          "engine.checkpoint", "parallel.mesh", "parallel.collectives", "parallel.dist",
          "obs.tracing", "native.hnsw"):
    assert "mediquery_rag_tpu_torch." + m in mods, m

# a sharded int8 search over the CPU four times, saved and loaded onto one shard
import tempfile
import numpy as np
from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine import ShardedFlatIndex
from mediquery_rag_tpu_torch.engine.checkpoint import load_sharded_index, save_sharded_index
from mediquery_rag_tpu_torch.parallel import corpus_mesh
rows = np.random.default_rng(0).standard_normal((300, 32)).astype(np.float32)
four = ShardedFlatIndex.build(rows, corpus_mesh(4, devices=["cpu"] * 4),
                              EngineConfig(dim=32, dtype="int8", corpus_tile=64))
with tempfile.TemporaryDirectory() as tmp:
    save_sharded_index(four, tmp)
    one = load_sharded_index(tmp, corpus_mesh(1, devices=["cpu"]))
got = [t.tolist() for t in four.search(rows[:3], k=4)]
assert got == [t.tolist() for t in one.search(rows[:3], k=4)] and got[1][0][0] == 0

# one training step and one constrained reply, with jax unimportable
from mediquery_rag_tpu_torch.config import DecoderConfig, TrainConfig
from mediquery_rag_tpu_torch.llm import TorchLLMClient
from mediquery_rag_tpu_torch.models import Generator
from mediquery_rag_tpu_torch.models.constrain import RISK_SCHEMA
from mediquery_rag_tpu_torch.models.train_lm import LMBatch, LMTrainer
import torch
tiny = DecoderConfig(vocab_size=384, hidden=32, layers=1, heads=2, mlp_dim=64,
                     max_len=256, dtype="float32", attn_impl="flash")
trainer = LMTrainer(tiny, TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=4), device="cpu")
state, m = trainer.train_step(trainer.init_state(0), LMBatch(
    torch.randint(3, 259, (2, 16)), torch.ones((2, 16))))
assert state.step == 1 and bool(torch.isfinite(m["loss"]))
# the same step over a world-size-1 training mesh (gloo, a file store)
import os
from mediquery_rag_tpu_torch.parallel.dist import init_train_mesh
with tempfile.TemporaryDirectory() as tmp:
    mesh = init_train_mesh(1, 1, device="cpu", init_method="file://" + os.path.join(tmp, "s"),
                           rank=0, world_size=1)
    mtr = LMTrainer(tiny, TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=4), mesh=mesh)
    mstate, mm = mtr.train_step(mtr.init_state(0), LMBatch(
        torch.randint(3, 259, (2, 16)), torch.ones((2, 16))))
    assert mesh.dp == mesh.tp == 1 and bool(torch.isfinite(mm["loss"]))
    torch.distributed.destroy_process_group()
reply = TorchLLMClient(Generator(tiny, seed=1, device="cpu")).complete("x", schema=RISK_SCHEMA)
assert json.loads(reply)["risk"] in ("CRITICAL", "HIGH", "MEDIUM", "LOW")

# one contrastive step over the corpus pairs and one trained-grader decision
from mediquery_rag_tpu_torch.config import EmbedderConfig
from mediquery_rag_tpu_torch.ingest import parse_corpus_file as _parse
from mediquery_rag_tpu_torch.models import HashCharTokenizer
from mediquery_rag_tpu_torch.models.cross_encoder import TrainedGrader, init_cross_params
from mediquery_rag_tpu_torch.models.data import PairLoader, pairs_from_chunks
from mediquery_rag_tpu_torch.models.trainer import ContrastiveTrainer
ecfg = EmbedderConfig(vocab_size=256, hidden=32, layers=1, heads=2, mlp_dim=64, max_len=128)
ctr = ContrastiveTrainer(ecfg, TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=4),
                         device="cpu")
loader = PairLoader(pairs_from_chunks(_parse("data/medical_data.txt")),
                    HashCharTokenizer(256, 128), 4, seed=0)
cstate, cm = ctr.train_step(ctr.init_state(), next(loader.batches()))
assert cstate.step == 1 and bool(torch.isfinite(cm["loss"]))
grader = TrainedGrader(init_cross_params(ecfg, device="cpu"), ecfg, device="cpu")
assert grader("高血压", ["高血压患者应限盐"]) in (True, False)

# one speculative reply and one speculative server reply, equal to plain decode
from mediquery_rag_tpu_torch.models.speculative import SpeculativeGenerator
from mediquery_rag_tpu_torch.serve.llm import LLMServer
target, drafter = Generator(tiny, seed=1, device="cpu"), Generator(tiny, seed=2, device="cpu")
want = target.generate(["x"], max_new_tokens=8)
assert SpeculativeGenerator(target, drafter, gamma=2).generate(["x"], max_new_tokens=8) == want
with LLMServer(target, slots=1, chunk=4, draft=drafter, gamma=2) as srv:
    assert srv.complete("x", max_new_tokens=8) == want[0] and srv.stats["spec_rounds"] > 0

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.ingest import build_document_store, parse_corpus_file
from mediquery_rag_tpu_torch.llm.client import FakeLLM
from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
from mediquery_rag_tpu_torch.serve import build_server

corpus = "data/medical_data.txt"
emb = IDFHashingEmbedder.fit_chunks(parse_corpus_file(corpus))
store = build_document_store(corpus, emb, EngineConfig(dtype="int8"), device="cpu")
server = build_server(store, FakeLLM())
port = server.start("127.0.0.1", 0)

def post(path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

try:
    bad = post("/search", {"query": "高血压", "k": 500})     # k past the kernel's 128
    added = post("/documents", {"documents": [{
        "chunk_id": "blocked-1", "title": "深海鱼油与血脂调节",
        "content": "适量摄入深海鱼油可能有助于调节血脂水平。", "tags": ["血脂"]}]})
    hit = post("/search", {"query": "深海鱼油与血脂调节", "k": 3})
finally:
    server.shutdown()
print(json.dumps({"mods": len(mods), "bad": bad, "added": added,
                  "first": hit[1]["results"][0][0]["metadata"]["chunk_id"]}))
"""


def test_port_imports_without_jax():
    """With jax, the JAX package, ``regex``, ``ml_dtypes``, transformers and
    tokenizers unimportable: every module of the port imports (the training,
    HF, encoder and training-mesh modules among them), an LM training step
    (alone and over a world-size-1 training mesh), a contrastive
    step of the encoder, a trained-grader decision and a
    schema-constrained reply run, a sharded int8 index searches, saves and
    loads onto one shard, a /search that raises gets a JSON 4xx
    reply, and POST /documents inserts into a CPU int8 store over HTTP (a
    subprocess: no test may put stubs into sys.modules of a shared
    worker)."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    code, body = res["bad"]
    assert 400 <= code < 500 and body["error"].startswith("ValueError")
    assert res["added"] == [200, {"added": 1, "doc_ids": [160]}]
    assert res["first"] == "blocked-1"


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_package():
    """No module of the port, nor chip_smoke.py or tools/, imports jax or
    anything of ``mediquery_rag_tpu`` (other than the port itself), nor
    ``regex``, ``ml_dtypes``, transformers or tokenizers (the GPU host has
    none of them)."""
    pkg = os.path.join(ROOT, "mediquery_rag_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "ivf_kernel_times.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    assert len(files) > 40
    bad = [(os.path.relpath(f, ROOT), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "mediquery_rag_tpu", "regex",
                                     "ml_dtypes", "transformers", "tokenizers")]
    assert bad == []


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/ivf_kernel_times.py"])
def test_chip_scripts_need_a_card(script):
    """Without a CUDA device the card's scripts exit non-zero and print no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_entry_points_default_to_cuda():
    """Every public entry point that takes ``device`` defaults to the card
    (``distill_draft``, the ``--draft`` loader and the encoders' and
    grader's constructors and trainers among them;
    ``SpeculativeGenerator`` takes none: it runs where its target and draft
    are), as do the training mesh (``init_train_mesh``: ``cuda:<local
    rank>``; ``launch``) and the trainers' ``--device``; a generator over a
    tensor-parallel mesh (``Generator(mesh=)``, ``from_checkpoint(mesh=)``)
    runs on the mesh's device, a rank's card; on a host without one,
    building an index with the default, an f32 IVF index too, or a mesh
    over the visible devices, raises instead of quietly using the CPU."""
    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.engine import IVFIndex, StreamingFlatIndex
    from mediquery_rag_tpu_torch.ingest import DocumentStore
    from mediquery_rag_tpu_torch.models import (
        convert, cross_encoder, decoder, distill, embedder, hf_import, lora, train_lm, trainer)
    from mediquery_rag_tpu_torch.models import HybridEmbedder, TextEmbedder
    from mediquery_rag_tpu_torch.models.speculative import SpeculativeGenerator
    from mediquery_rag_tpu_torch.serve.server import load_draft
    fns = [FlatIndex.build, FlatIndex.load, IVFIndex.build, IVFIndex.build_streaming,
           IVFIndex.load, StreamingFlatIndex.build, StreamingFlatIndex.build_from_blocks,
           StreamingFlatIndex.load, DocumentStore.load, build_document_store,
           Generator.__init__, Generator.from_checkpoint, TorchLLMClient.from_checkpoint,
           decoder.init_params, convert.to_tensor, convert.params_from_jax,
           convert.load_jax_checkpoint, AppContext.build, train_lm.LMTrainer.__init__,
           lora.LoraTrainer.__init__, lora.load_adapters, distill.distill_draft, load_draft,
           hf_import.load_qwen2, hf_import.load_qwen2_generator, hf_import.load_bert,
           hf_import.BertTextEmbedder.from_hf, TorchLLMClient.from_hf,
           embedder.init_params, TextEmbedder.__init__, TextEmbedder.from_checkpoint,
           HybridEmbedder.from_checkpoint, trainer.ContrastiveTrainer.__init__,
           cross_encoder.init_cross_params, cross_encoder.CrossEncoderTrainer.__init__,
           cross_encoder.train_cross_encoder, cross_encoder.TrainedGrader.__init__,
           cross_encoder.TrainedGrader.from_checkpoint]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # meshes span the visible cards unless given devices, and never fall back to the CPU
    from mediquery_rag_tpu_torch.parallel import corpus_mesh, make_mesh, slice_mesh
    for fn in (make_mesh, corpus_mesh, slice_mesh):
        assert inspect.signature(fn).parameters["devices"].default is None, fn
    if torch.cuda.is_available():
        assert corpus_mesh().flat()[0].type == "cuda"
    else:
        for make in (lambda: make_mesh({"shard": 1}), corpus_mesh, lambda: slice_mesh(1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert "device" not in inspect.signature(SpeculativeGenerator.__init__).parameters
    # the training mesh: a rank's card by default, and the trainers' CLIs default to the card
    from mediquery_rag_tpu_torch.models import train
    from mediquery_rag_tpu_torch.parallel import dist
    assert inspect.signature(dist.launch).parameters["device"].default == "cuda"
    assert inspect.signature(dist.init_train_mesh).parameters["device"].default is None
    assert dist.resolve_device(None, 3) == dist.resolve_device("cuda", 3) == torch.device("cuda", 3)
    for fn in (Generator.__init__, Generator.from_checkpoint):
        assert inspect.signature(fn).parameters["mesh"].default is None, fn
    mesh = types.SimpleNamespace(dp=1, tp=1, model_rank=0, model_group=None,
                                 device=dist.resolve_device(None, 0))
    if not torch.cuda.is_available():       # the mesh's card, never the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            Generator(TTINY, mesh=mesh, device="cpu")
    for main in (train_lm.main, lora.main, train.main):
        assert '"--device", default="cuda"' in inspect.getsource(main), main
    f32 = np.random.default_rng(7).standard_normal((64, 32)).astype(np.float32)
    if torch.cuda.is_available():
        assert IVFIndex.build(f32, TEngineConfig(dim=32, dtype="float32")).buckets.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            IVFIndex.build(f32, TEngineConfig(dim=32, dtype="float32", ivf_nlist=4))
    vecs = np.random.default_rng(6).standard_normal((10, 32)).astype(np.float32)
    if torch.cuda.is_available():
        assert FlatIndex.build(vecs).corpus.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            FlatIndex.build(vecs)


def test_health_extraction_failure_is_logged(tmp_path, caplog):
    """The fail-open extractor logs a client that fails instead of hiding
    it: an ``LLMServer`` that is closed raises for every request."""
    from mediquery_rag_tpu_torch.app.memory import ProfileStore, extract_health_info
    from mediquery_rag_tpu_torch.serve.llm import LLMServer, ServedLLMClient
    srv = LLMServer(Generator(TTINY, seed=1, device="cpu"), slots=1)
    srv.close()
    store = ProfileStore(str(tmp_path / "p.sqlite"))
    with caplog.at_level("WARNING"):
        assert extract_health_info("我对青霉素过敏", "u1", ServedLLMClient(srv), store) == 0
    assert any("health-profile extraction failed" in r.getMessage() and r.exc_info
               and r.exc_info[0] is RuntimeError for r in caplog.records)


def test_app_context_falls_back_on_bad_checkpoints(tmp_path, monkeypatch, capsys):
    """As in the JAX package, startup never aborts on a checkpoint: a
    decoder checkpoint that fails to load falls back to the HTTP client,
    and a grader checkpoint that fails to load falls back to the
    similarity grader, each with a printed notice."""
    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.llm.client import HTTPChatClient
    os.makedirs(tmp_path / "data")
    shutil.copy(CORPUS, tmp_path / "data" / "medical_data.txt")
    for d in ("lm", "grader"):
        os.makedirs(tmp_path / "checkpoints" / d)
    with open(tmp_path / "checkpoints" / "lm" / "config.json", "w") as f:
        json.dump(TTINY.__dict__, f)
    (tmp_path / "checkpoints" / "lm" / "params.npz").write_bytes(b"not an npz archive")
    (tmp_path / "checkpoints" / "grader" / "params.npz").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    for name in ("MEDIQUERY_INDEX", "MEDIQUERY_HF_EMBEDDER", "MEDIQUERY_HYBRID",
                 "MEDIQUERY_HF_LLM", "TAVILY_API_KEY"):
        monkeypatch.delenv(name, raising=False)
    ctx = AppContext.build(str(tmp_path), llm_url="http://127.0.0.1:9", device="cpu")
    printed = capsys.readouterr().out
    assert isinstance(ctx.llm, HTTPChatClient)
    assert "回退 HTTP 客户端" in printed and "回退 LLM grade" in printed
    assert ctx.graph_app is not None
