"""Parity of the PyTorch port's serving slice with the JAX package, on the CPU.

Copied modules give identical outputs; the flat index and document store
return the same documents; a tiny decoder (hidden 64, 2 layers, 4q/2kv,
byte vocabulary, q/k/v bias, flash attention) converted from JAX params
gives the same logits and greedy tokens, float and int8; and the shared
``SearchServer`` + Self-RAG graph serve /search and /qa over HTTP from the
port's store and decoder. Inputs come from ``np.random.default_rng`` or the
repo's corpus; tolerances are stated per test.
"""

import json
import os
import shutil
import subprocess
import sys
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
    tidx = FlatIndex.load(str(tmp_path / "j"))
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
    for dtype in ("float32", "bfloat16"):
        cfg = EngineConfig(dim=64, dtype=dtype)
        j, t = JFlatIndex.build(vecs, cfg), FlatIndex.build(vecs, cfg)
        assert j.corpus.shape == tuple(t.corpus.shape) and j.cfg == t.cfg
        np.testing.assert_allclose(np.asarray(j.corpus.astype(jnp.float32)),
                                   t.corpus.float().numpy(), rtol=8e-3, atol=1e-7)
    with pytest.raises(NotImplementedError):
        FlatIndex.build(vecs, EngineConfig(dim=64, dtype="int8"))


@pytest.fixture(scope="module")
def stores(embedders):
    jemb, temb = embedders
    return (jbuild_store(CORPUS, jemb, EngineConfig()),
            build_document_store(CORPUS, temb, EngineConfig()))


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
    back = DocumentStore.load(str(tmp_path / "store"), embedders[1])
    assert _doc_ids(back.batch_search(QUERIES, k=5)) == _doc_ids(
        tstore.batch_search(QUERIES, k=5))
    with pytest.raises(ValueError):
        DocumentStore.load(str(tmp_path / "store"), HashingEmbedder(64))


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
    jdec, tdec = JDecoder(TINY), Decoder(TINY, params_from_jax(_np_tree(params)))
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
    jdec, tdec = JDecoder(cfg), Decoder(cfg, params_from_jax(_np_tree(jax_params)))
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
    tgen = Generator(TINY, params_from_jax(_np_tree(jax_params)))
    if quant:
        jgen.quantize_weights(bits=8)
        tgen.quantize_weights(bits=8)
    assert jgen.generate(PROMPTS, max_new_tokens=16) == tgen.generate(
        PROMPTS, max_new_tokens=16)


def test_generator_from_jax_checkpoint(jax_params, tmp_path):
    jgen = JGenerator(TINY, params=jax_params)
    jgen.save(str(tmp_path))
    tgen = Generator.from_checkpoint(str(tmp_path))
    assert jgen.generate(PROMPTS, max_new_tokens=16) == tgen.generate(
        PROMPTS, max_new_tokens=16)


def test_generator_sampling_and_limits():
    gen = Generator(TINY, seed=1)
    a = gen.generate(PROMPTS, max_new_tokens=8, temperature=1.0, seed=3)
    assert a == gen.generate(PROMPTS, max_new_tokens=8, temperature=1.0, seed=3)
    assert gen.generate([], max_new_tokens=4) == []
    with pytest.raises(ValueError):                 # no room under max_len
        gen.generate(["x" * 600], max_new_tokens=4)
    with pytest.raises(NotImplementedError):
        TorchLLMClient(gen).complete("问", schema={"type": "object"})


# -- the slice over HTTP -------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_search_and_qa_over_http(stores, jax_params):
    """/search returns the JAX store's documents; /qa answers through the
    port's decoder and the shared Self-RAG graph."""
    jstore, tstore = stores
    # /qa prompts carry retrieved chunks (~700 bytes each): room for 5
    cfg = DecoderConfig(**{**TINY.__dict__, "max_len": 8192})
    llm = TorchLLMClient(Generator(cfg, params_from_jax(_np_tree(jax_params))),
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
    fake LLM: builds (then reloads) the flat store and answers via the graph."""
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
    monkeypatch.setenv("MEDIQUERY_INDEX", "ivf")
    with pytest.raises(NotImplementedError):
        AppContext.build(str(tmp_path), fake_llm=True, device="cpu")


def test_serve_main_rejects_draft():
    from mediquery_rag_tpu_torch.serve.server import main
    with pytest.raises(NotImplementedError):
        main(["--draft", "somewhere"])


def test_port_imports_without_jax():
    """Every module of the port imports with jax made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import mediquery_rag_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "        if not m.name.endswith('__main__')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 20, mods\n"
        "print('ok', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
