"""Parity of the port's encoders and graders with the JAX package, on the CPU.

The character-hash tokenizer (native and Python), ``Embedder``,
``TextEmbedder``, ``HybridEmbedder``, ``CrossEncoder`` and its graders,
``retrieval_recall`` and the CLI's wiring of them, at tiny widths (2
layers, hidden 64, 4 heads, MLP 128, vocab 512, 128 tokens). JAX's weights
reach the port through the checkpoint functions (JAX saves, the port
loads), so every parity test also holds the ``params.npz`` format. Also the
f32-sum products of bf16 operands (``ops.matmul``): ``QLinear`` against
JAX's ``_mm`` and one bf16 decoder layer walked intermediate by
intermediate. Every port call passes ``device="cpu"``; tolerances are
stated per test.

Run as a script (``python tests/test_torch_encoders.py [--root DIR]``) it
prints the bf16 layer walk of the port found under ``DIR`` (default: this
checkout) against JAX.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)        # run as a script: the packages live beside tests/

from mediquery_rag_tpu.config import DecoderConfig as JDecoderConfig  # noqa: E402
from mediquery_rag_tpu.config import EmbedderConfig as JEmbedderConfig  # noqa: E402
from mediquery_rag_tpu.models import cross_encoder as jce  # noqa: E402
from mediquery_rag_tpu.models import decoder as jdec  # noqa: E402
from mediquery_rag_tpu.models import eval as jeval  # noqa: E402
from mediquery_rag_tpu.models.embedder import Embedder as JEmbedder  # noqa: E402
from mediquery_rag_tpu.models.hybrid_embedder import HybridEmbedder as JHybrid  # noqa: E402
from mediquery_rag_tpu.models.text_embedder import TextEmbedder as JTextEmbedder  # noqa: E402
from mediquery_rag_tpu.models.tokenizer import HashCharTokenizer as JTok  # noqa: E402

CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=128)
TEXTS = ["高血压患者平时饮食需要注意什么？", "糖尿病的早期症状有哪些", "头痛 怎么办\t",
         "x" * 100, "", "混合 English 和 中文 with spaces"]
QUERIES = ["高血压饮食", "糖尿病症状", "头痛"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test processes share the cores: torch runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype):
    from mediquery_rag_tpu_torch.config import EmbedderConfig
    return JEmbedderConfig(**TINY, dtype=dtype), EmbedderConfig(**TINY, dtype=dtype)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def embedders(request, tmp_path_factory):
    """A JAX ``TextEmbedder`` (key 1) and the port's, loaded from its save."""
    from mediquery_rag_tpu_torch.models import TextEmbedder
    jcfg, _ = _cfgs(request.param)
    j = JTextEmbedder(jcfg, key=jax.random.PRNGKey(1))
    d = str(tmp_path_factory.mktemp("emb") / "ckpt")
    j.save(d)
    return j, TextEmbedder.from_checkpoint(d, device="cpu"), d


# -- Queue C 7: f32 sums of bf16 operands ------------------------------------------

def _sum_order_bound(x, w):
    """|f32 sum in one order - in another| <= K 2^-24 sum_k |x_k w_k|, per
    element (the products are exact in f32)."""
    return x.shape[-1] * 2.0 ** -24 * (np.abs(x) @ np.abs(w)) + 1e-30


@pytest.mark.parametrize("rows", [16, 200])
def test_qlinear_keeps_jax_f32_sum(rows):
    """``QLinear`` with bf16 activations and float weights returns JAX
    ``_mm``'s f32 sum at up to 128 rows (decode) and past them (prefill),
    per element within the f32 sum-order bound of the rounded operands (a
    product rounded to bf16, as the port's was, misses it by ~2^-9
    relative)."""
    from mediquery_rag_tpu_torch.models.decoder import QLinear
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 96)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    wr = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
    want = np.asarray(jdec._mm(jnp.asarray(x, jnp.bfloat16), w, jnp.bfloat16))
    got = QLinear(torch.from_numpy(w))(torch.from_numpy(x), torch.bfloat16).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert (np.abs(got - want) <= _sum_order_bound(xb, wr)).all()


def test_card_product_autograd_on_the_cpu(monkeypatch):
    """The card's autograd Function (``ops.matmul._CardMm``), its cuBLAS call
    replaced by the widened f32 product: forward equal to the CPU path, and
    each operand's gradient equal to the widened product's gradient of the
    incoming gradient rounded to bf16, rounded to bf16 (2-D and batched)."""
    from mediquery_rag_tpu_torch.ops import matmul
    monkeypatch.setattr(matmul, "_mm", lambda a, b: a.float() @ b.float())
    rng = np.random.default_rng(3)
    for lead in ((), (2, 3)):
        a = torch.from_numpy(rng.standard_normal((*lead, 5, 24)).astype(np.float32)).to(
            torch.bfloat16).requires_grad_(True)
        w = torch.from_numpy(rng.standard_normal((*lead, 24, 7)).astype(np.float32)).to(
            torch.bfloat16).requires_grad_(True)
        flat = (a.reshape(-1, 5, 24), w.reshape(-1, 24, 7)) if lead else (a, w)
        out = matmul._CardMm.apply(*flat).reshape(*lead, 5, 7)
        np.testing.assert_array_equal(out.detach().numpy(), (a.float() @ w.float()).detach().numpy())
        g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
        ga, gw = torch.autograd.grad(out, (a, w), g)
        gb = g.to(torch.bfloat16).float()
        assert torch.equal(ga, (gb @ w.float().transpose(-1, -2)).to(torch.bfloat16))
        assert torch.equal(gw, (a.float().transpose(-1, -2) @ gb).to(torch.bfloat16))


def layer_walk(port_root: str = ROOT, S: int = 160) -> dict:
    """One bf16 decoder layer (hidden 128, 4/2 heads, q/k/v bias, ``S``
    rows, one left-padded lane) through JAX's block functions and the
    port's (imported from ``port_root``), intermediate by intermediate.
    ``"site"``: each port step fed JAX's own inputs, so a difference is that
    step's alone; ``"chain"``: the port fed its own results. Returns
    {mode: {name: (share of elements that differ, max |diff|, relative
    L2)}} over the real rows."""
    sys.path.insert(0, port_root)
    try:
        from mediquery_rag_tpu_torch.config import DecoderConfig
        from mediquery_rag_tpu_torch.models import decoder as td
        from mediquery_rag_tpu_torch.models.convert import params_from_jax
        from mediquery_rag_tpu_torch.ops.attention import attention_plain
    finally:
        sys.path.remove(port_root)
    kw = dict(vocab_size=300, hidden=128, layers=1, heads=4, kv_heads=2, mlp_dim=256,
              max_len=512, dtype="bfloat16", qkv_bias=True)
    jcfg, tcfg = JDecoderConfig(**kw), DecoderConfig(**kw)
    jp = jdec.Decoder(jcfg).init(jax.random.PRNGKey(3))
    jp["blocks"]["qkv_b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                                    jp["blocks"]["qkv_b"].shape)
    m = td.Decoder(tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    B, H, KH, dh, adt = 2, 4, 2, 32, jnp.bfloat16
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 300, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, :17] = 0
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    pos = jnp.clip(jnp.cumsum(mask, axis=1).astype(jnp.int32) - 1, 0)
    bias = (jnp.tril(jnp.ones((S, S)))[None, None] * mask[:, None, None, :] - 1.0) * 1e9
    J = {"x": jp["tok_embed"][ids].astype(adt)}
    J["qkv"] = (jdec._mm(jdec._rmsnorm(J["x"], lp["rms1"]), lp["qkv"], adt)
                + lp["qkv_b"]).astype(adt)
    q, k, J["v"] = jdec._split_qkv(J["qkv"], B, S, H, KH, dh)
    J["q"], J["k"] = jdec._rope(q, pos, jcfg.rope_theta), jdec._rope(k, pos, jcfg.rope_theta)
    J["ctx"] = jdec._attend(J["q"], J["k"], J["v"], bias, adt, dh)
    ctx = J["ctx"].transpose(0, 2, 1, 3).reshape(B, S, -1)
    J["x2"] = J["x"] + jdec._mm(ctx, lp["attn_out"], adt).astype(adt)
    h = jdec._rmsnorm(J["x2"], lp["rms2"])
    J["ff"] = (jax.nn.silu(jdec._mm(h, lp["w_gate"], adt))
               * jdec._mm(h, lp["w_up"], adt)).astype(adt)
    J["out"] = J["x2"] + jdec._mm(J["ff"], lp["w_down"], adt).astype(adt)
    J["logits"] = jdec._mm(jdec._rmsnorm(J["out"], jp["rms_f"]), jp["lm_head"], adt)

    tmask = torch.from_numpy(mask)
    tpos = torch.clamp(torch.cumsum(tmask, 1).to(torch.int32) - 1, min=0)
    rope = td._rope_tables(tpos, dh, tcfg.rope_theta)

    def port(site: bool) -> dict:
        T = {}

        def inp(name):        # a step's input: JAX's (site) or the port's own
            if site or name not in T:
                return torch.from_numpy(np.asarray(J[name], np.float32)).to(
                    torch.float32 if name == "logits" else m.adt)
            return T[name]

        T["x"] = m.tok_embed[torch.from_numpy(ids).long()].to(m.adt)
        T["qkv"] = (m.qkv(td._rmsnorm(inp("x"), m.rms1[0]), m.adt, 0)
                    + m.qkv_b[0].float()).to(m.adt)
        q, k, T["v"] = td._split_qkv(inp("qkv"), B, S, H, KH, dh)
        T["q"], T["k"] = td._rope(q, rope), td._rope(k, rope)
        T["ctx"] = attention_plain(inp("q"), inp("k"), inp("v"), tmask, dh ** -0.5,
                                   causal=True)
        T["x2"] = inp("x") + m.attn_out(inp("ctx").transpose(1, 2).reshape(B, S, -1),
                                        m.adt, 0).to(m.adt)
        h = td._rmsnorm(inp("x2"), m.rms2[0])
        T["ff"] = (torch.nn.functional.silu(m.w_gate(h, m.adt, 0))
                   * m.w_up(h, m.adt, 0)).to(m.adt)
        T["out"] = inp("x2") + m.w_down(inp("ff"), m.adt, 0).to(m.adt)
        T["logits"] = m.lm_head(td._rmsnorm(inp("out"), m.rms_f), m.adt)
        return T

    out, real = {}, mask.astype(bool)
    for mode in ("site", "chain"):
        T, out[mode] = port(mode == "site"), {}
        for name in J:
            a, b = np.asarray(J[name], np.float32), T[name].float().numpy()
            if a.ndim == 4:                        # [B, H, S, dh] -> [B, S, H dh]
                a, b = (t.transpose(0, 2, 1, 3).reshape(B, S, -1) for t in (a, b))
            a, b = a[real], b[real]
            out[mode][name] = (float((a != b).mean()), float(np.abs(a - b).max()),
                               float(np.linalg.norm(a - b) / np.linalg.norm(a)))
    return out


def test_bf16_decoder_layer_walk_matches_jax():
    """Each step of a bf16 layer, fed JAX's inputs, equals JAX's result but
    where an f32 sum taken in another order rounds to the other bf16
    neighbour: at most 0.5% of any bf16 intermediate's elements differ
    (rounding the products to bf16, as the port did, changes about a
    quarter of them), and the logits from JAX's last hidden state sit
    within 1e-5 relative L2 of JAX's. Fed its own results, the layer's
    logits stay within 2e-3 relative L2 (the port rounding its products
    moved them by about 1.2e-2)."""
    walk = layer_walk()
    for name, (share, _, _) in walk["site"].items():
        if name != "logits":
            assert share <= 0.005, (name, walk["site"][name])
    assert walk["site"]["logits"][2] <= 1e-5, walk["site"]["logits"]
    assert walk["chain"]["logits"][2] <= 2e-3, walk["chain"]["logits"]


# -- the tokenizer -----------------------------------------------------------------

def _adversarial():
    import random
    random.seed(7)
    rand = "".join(chr(random.randint(1, 0x10FFFF - 2048)) for _ in range(800))
    rand = "".join(c for c in rand if not 0xD800 <= ord(c) <= 0xDFFF)
    return ["", " ", "\t\n\x1c\x1d\x1e\x1f\x85\xa0        　",
            "高血压患者的饮食建议", "a b  c", "🩺💊🧬 emoji 测试", "x" * 1000,
            "混合 English 和 中文 with spaces   and\ttabs", rand]


def test_hash_tokenizer_native_python_and_jax_equal(monkeypatch):
    """On ``tests/test_native.py``'s adversarial inputs: the port's native
    tokens == its Python loop == JAX's, and ``batch_encode`` through either
    path equals JAX's (ids and mask, bit for bit)."""
    from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
    from mediquery_rag_tpu_torch.native import tokenizer as nt
    cases = _adversarial()
    tok, jtok = HashCharTokenizer(16384, 256), JTok(16384, 256)
    py = [tok.encode(t)[:256] for t in cases]
    assert py == [jtok.encode(t)[:256] for t in cases]
    assert nt.native_available()
    ids, lens = nt.tok_batch(cases, 16384, 255, 256)
    for r, e in enumerate(py):
        assert int(lens[r]) == len(e) and ids[r, : len(e)].tolist() == e
        assert (ids[r, len(e):] == 0).all()
    small, jsmall = HashCharTokenizer(2048, 128), JTok(2048, 128)
    want = jsmall.batch_encode(cases + TEXTS)
    native = small.batch_encode(cases + TEXTS)
    monkeypatch.setattr(nt, "native_available", lambda: False)
    python = small.batch_encode(cases + TEXTS)
    for got in (native, python):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# -- the encoder -------------------------------------------------------------------

def test_text_embedder_matches_jax(embedders):
    """``TextEmbedder.embed`` of JAX's weights: f32 within 1e-5 per element
    (rtol ~1e-5 on unit rows), bf16 per-row cosine >= 0.9999 and within
    4e-3 per element (measured 0.99999 and 8.6e-4: bf16 intermediates
    flip where an f32 sum in another order rounds the other way). Rows are
    unit norm, an empty batch gives [0, 64]."""
    j, t, _ = embedders
    a, b = j.embed(TEXTS), t.embed(TEXTS)
    assert b.shape == (len(TEXTS), 64) and b.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-6)
    if t.cfg.dtype == "float32":
        np.testing.assert_allclose(b, a, atol=1e-5)
    else:
        assert (a * b).sum(1).min() >= 0.9999
        np.testing.assert_allclose(b, a, atol=4e-3)
    assert t.embed([]).shape == (0, 64) and t.dim == 64


def test_embedder_apply_matches_jax_and_ignores_padding(embedders):
    """``Embedder.forward`` against JAX's ``apply`` on the same ids and mask
    (f32 within 1e-5; bf16 cosine >= 0.9999), and padding invariance: the
    same rows padded to 128 columns instead of 64 give the same
    embeddings (within 1e-6: masked columns carry a weight of exactly 0,
    only the sum's blocking can change)."""
    j, t, _ = embedders
    rng = np.random.default_rng(5)
    ids = rng.integers(2, 512, (3, 64)).astype(np.int32)
    mask = np.zeros((3, 64), np.float32)
    for r, n in enumerate((64, 40, 1)):
        mask[r, :n] = 1.0
    want = np.asarray(JEmbedder(j.cfg).apply(j.params, ids, mask))
    got = t.model(ids, mask).numpy()
    if t.cfg.dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (got * want).sum(1).min() >= 0.9999
    wide = t.model(np.pad(ids, ((0, 0), (0, 64))), np.pad(mask, ((0, 0), (0, 64))))
    np.testing.assert_allclose(wide.numpy(), got, atol=1e-6)


def test_text_embedder_checkpoints_load_both_ways(embedders, tmp_path):
    """JAX's ``params.npz`` loads in the port leaf for leaf (bit-equal), and
    the port's save loads in JAX (``from_checkpoint`` and ``load_params``)
    bit-equal, embedding as before."""
    from mediquery_rag_tpu_torch.models.embedder import leaf_paths
    j, t, _ = embedders
    jleaves = jax.tree_util.tree_leaves(j.params)
    paths = leaf_paths(t.params)
    assert len(paths) == len(jleaves) == 14
    for p, jl in zip(paths, jleaves):
        leaf = t.params
        for k in p:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jl))
    t.save(str(tmp_path / "port"))
    back = JTextEmbedder.from_checkpoint(str(tmp_path / "port"))
    assert back.cfg == j.cfg
    for a, b in zip(jax.tree_util.tree_leaves(back.params), jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(back.embed(TEXTS), j.embed(TEXTS))


def test_text_embedder_rejects_a_mesh_and_a_wrong_checkpoint(tmp_path):
    """A mesh that is not a device mesh with a "data" axis raises (the
    data-parallel embedding itself runs in
    ``tests/test_torch_mesh_train.py``); a checkpoint of another
    architecture raises ValueError, as in JAX."""
    from mediquery_rag_tpu_torch.models import TextEmbedder
    from mediquery_rag_tpu_torch.parallel import make_mesh
    _, cfg = _cfgs("float32")
    with pytest.raises(ValueError, match="'data' axis"):
        TextEmbedder(cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        TextEmbedder(cfg, mesh=make_mesh({"shard": 2}, devices=["cpu"] * 2), device="cpu")
    t = TextEmbedder(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    np.savez(tmp_path / "params.npz", **{"0": np.zeros(3)})
    with pytest.raises(ValueError, match="architecture"):
        t.load_params(str(tmp_path))


# -- the hybrid embedder -----------------------------------------------------------

def _hybrid_channels():
    from mediquery_rag_tpu_torch.models import HashingEmbedder

    def sem(texts):   # deterministic fake semantic embedder, NOT normed
        return np.stack([np.cos(np.arange(16) * (1 + len(t))) for t in texts]).astype(
            np.float32)

    return HashingEmbedder(32), sem


def test_hybrid_fused_score_equals_weighted_cosines():
    """``dot(out_a, out_b) == w cos_lex + (1 - w) cos_sem`` (rtol 1e-5),
    rows unit norm, the output equal to JAX's ``HybridEmbedder`` over the
    same channels, and weights outside (0, 1) refused."""
    from mediquery_rag_tpu_torch.models import HybridEmbedder
    lex, sem = _hybrid_channels()
    hy = HybridEmbedder(lex, sem, w_lex=0.8)
    texts = ["高血压饮食建议", "糖尿病运动指导", "高血压用药提醒"]
    out = hy(texts)
    assert out.shape == (3, 48)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)

    def ncos(e, a, b):
        va, vb = np.asarray(e([a]))[0], np.asarray(e([b]))[0]
        return float(va @ vb / np.linalg.norm(va) / np.linalg.norm(vb))

    want = 0.8 * ncos(lex, texts[0], texts[2]) + 0.2 * ncos(sem, texts[0], texts[2])
    np.testing.assert_allclose(float(out[0] @ out[2]), want, rtol=1e-5)
    np.testing.assert_array_equal(out, JHybrid(lex, sem, w_lex=0.8)(texts))
    for w in (0.0, 1.0, -0.2, 1.5):
        with pytest.raises(ValueError):
            HybridEmbedder(lex, sem, w_lex=w)


@pytest.mark.parametrize("embedders", ["float32"], indirect=True)
def test_hybrid_document_store_roundtrip(embedders, tmp_path):
    """A hybrid of the IDF lexical channel and the trained encoder's
    checkpoint (``from_checkpoint`` on the CPU) through build/save/load of
    the port's store (fingerprint included): rows as wide as the two
    channels together, the same top-3 after the reload."""
    from mediquery_rag_tpu_torch.ingest import (
        DocumentStore, build_document_store, parse_corpus_file)
    from mediquery_rag_tpu_torch.models import HybridEmbedder, IDFHashingEmbedder
    _, t, ckpt = embedders
    lex = IDFHashingEmbedder.fit_chunks(parse_corpus_file(CORPUS), dim=64)
    hy = HybridEmbedder.from_checkpoint(ckpt, lex_dim=64, lexical=lex, w_lex=0.7,
                                        device="cpu")
    store = build_document_store(CORPUS, hy, device="cpu")
    assert store.index.corpus.shape[1] == lex(["x"]).shape[1] + 64
    docs = store.similarity_search("高血压饮食", k=3)
    store.save(str(tmp_path / "idx"))
    again = DocumentStore.load(str(tmp_path / "idx"), hy, device="cpu")
    assert [d.text for d in again.similarity_search("高血压饮食", k=3)] == [
        d.text for d in docs]


# -- the cross-encoder and the graders ---------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def graders(request, tmp_path_factory):
    """JAX cross-encoder params (key 2) saved by JAX's ``TrainedGrader``
    (threshold 0.5) and the port's ``TrainedGrader`` loaded from it."""
    from mediquery_rag_tpu_torch.models.cross_encoder import TrainedGrader
    jcfg, _ = _cfgs(request.param)
    params = jce.CrossEncoder(jcfg).init(jax.random.PRNGKey(2))
    d = str(tmp_path_factory.mktemp("grader") / "ckpt")
    jce.TrainedGrader(params, jcfg, threshold=0.5).save(d)
    return params, jcfg, TrainedGrader.from_checkpoint(d, device="cpu"), d


def test_encode_pairs_equal():
    """``encode_pairs``: ids, mask and segments equal JAX's, with a query
    longer than half of max_len cut there and pairs past max_len cut."""
    from mediquery_rag_tpu_torch.models.cross_encoder import encode_pairs
    from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
    qs = TEXTS + ["长" * 90]
    ds = TEXTS[::-1] + ["短" * 200]
    got = encode_pairs(HashCharTokenizer(512, 128), qs, ds)
    want = jce.encode_pairs(JTok(512, 128), qs, ds)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cross_encoder_logits_and_grader_match_jax(graders):
    """``CrossEncoder`` logits of JAX's weights (f32 within 2e-5, bf16
    within 1e-2 of logits near 3: bf16 intermediates flip where an f32 sum
    in another order rounds the other way; measured 2.4e-7 and 1.7e-3),
    ``score_pairs`` the same at batch 4, and ``make_grader``'s decision
    equal to JAX's at thresholds between the logits."""
    from mediquery_rag_tpu_torch.models.cross_encoder import (
        CrossEncoder, make_grader, score_pairs)
    from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
    params, jcfg, tg, _ = graders
    tol = 2e-5 if jcfg.dtype == "float32" else 1e-2
    qs, ds = TEXTS, TEXTS[::-1]
    ids, mask, seg = jce.encode_pairs(JTok(512, 128), qs, ds)
    want = np.asarray(jce.CrossEncoder(jcfg).apply(params, ids, mask, seg))
    got = CrossEncoder(tg.cfg, tg.params)(ids, mask, seg).numpy()
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(score_pairs(tg.params, tg.cfg, qs, ds, batch=4),
                               jce.score_pairs(params, jcfg, qs, ds, batch=4), atol=tol)
    assert score_pairs(tg.params, tg.cfg, [], []).shape == (0,)
    tok, jtok = HashCharTokenizer(512, 128), JTok(512, 128)
    docs = ["高血压的饮食建议：少盐", "糖尿病运动指导"]
    logits = np.asarray(jce.score_pairs(params, jcfg, [qs[0]] * 2, docs))
    for thr in (float(logits.min()) - 0.5, float(logits.mean()), float(logits.max()) + 0.5):
        if min(abs(logits - thr)) < 2 * tol:
            continue
        assert make_grader(tg.params, tok, tg.cfg, threshold=thr)(qs[0], docs) == \
            jce.make_grader(params, jtok, jcfg, threshold=thr)(qs[0], docs)
    assert make_grader(tg.params, tok, tg.cfg)(qs[0], []) is False


def test_trained_grader_checkpoints_load_both_ways(graders, tmp_path):
    """JAX's grader checkpoint loads in the port (17 leaves bit-equal, the
    threshold kept) and the port's save loads in JAX bit-equal; a
    checkpoint with another architecture's leaf count raises ValueError."""
    from mediquery_rag_tpu_torch.models.cross_encoder import TrainedGrader
    from mediquery_rag_tpu_torch.models.embedder import leaf_paths
    params, jcfg, tg, _ = graders
    assert tg.threshold == 0.5
    jleaves = jax.tree_util.tree_leaves(params)
    assert len(leaf_paths(tg.params)) == len(jleaves) == 17
    tg.save(str(tmp_path / "port"))
    back = jce.TrainedGrader.from_checkpoint(str(tmp_path / "port"))
    assert back.cfg == jcfg and back.threshold == 0.5
    for a, b in zip(jax.tree_util.tree_leaves(back.params), jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    z = dict(np.load(tmp_path / "port" / "params.npz"))
    np.savez(tmp_path / "port" / "params.npz", **{k: z[k] for k in list(z)[:14]})
    with pytest.raises(ValueError, match="architecture"):
        TrainedGrader.from_checkpoint(str(tmp_path / "port"), device="cpu")


def test_retrieval_recall_and_heldout_equal(embedders):
    """``load_heldout`` reads the held-out TSV as JAX does, and
    ``retrieval_recall`` over the same embedding function (the port's
    encoder) gives JAX's numbers."""
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models import eval as teval
    _, t, _ = embedders
    path = os.path.join(ROOT, "data", "heldout_queries.tsv")
    held = teval.load_heldout(path)
    assert held == jeval.load_heldout(path) and len(held) > 10
    chunks = parse_corpus_file(CORPUS)
    ids = [c.chunk_id for c in chunks]
    docs = [c.text for c in chunks]
    gold, queries = zip(*held[:12])
    got = teval.retrieval_recall(t.embed, docs, ids, queries, gold, batch=64)
    assert got == jeval.retrieval_recall(t.embed, docs, ids, queries, gold, batch=64)
    assert set(got) == {"recall@1", "recall@5", "recall@10", "mrr"}


# -- the CLI's wiring --------------------------------------------------------------

def _app_root(tmp_path, monkeypatch):
    os.makedirs(tmp_path / "data")
    shutil.copy(CORPUS, tmp_path / "data" / "medical_data.txt")
    monkeypatch.chdir(tmp_path)
    for name in ("MEDIQUERY_INDEX", "MEDIQUERY_HF_EMBEDDER", "MEDIQUERY_HYBRID",
                 "MEDIQUERY_HF_LLM", "TAVILY_API_KEY"):
        monkeypatch.delenv(name, raising=False)
    return str(tmp_path)


@pytest.mark.parametrize("embedders,graders", [("bfloat16", "bfloat16")], indirect=True)
def test_app_context_hybrid_and_trained_grader(embedders, graders, tmp_path, monkeypatch,
                                               capsys):
    """``AppContext.build(device="cpu")`` with ``MEDIQUERY_HYBRID=1`` and an
    encoder checkpoint (JAX's save) builds the hybrid store (IDF lexical
    width + the encoder's 64) graded by ``SimilarityGrader`` at JAX's 0.2;
    with a grader checkpoint (JAX's save) ``grade_fn`` is a ``TrainedGrader``
    and a /qa graph run goes through it; a stale grader checkpoint (another
    architecture's arrays) falls back to the similarity grader with JAX's
    notice. Nothing prints "not
    ported"."""
    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.llm.messages import user
    from mediquery_rag_tpu_torch.models import HybridEmbedder
    from mediquery_rag_tpu_torch.models.cross_encoder import SimilarityGrader, TrainedGrader
    _, _, ckpt = embedders
    _, _, _, gckpt = graders
    root = _app_root(tmp_path, monkeypatch)
    shutil.copytree(ckpt, os.path.join(root, "checkpoints", "embedder"))
    monkeypatch.setenv("MEDIQUERY_HYBRID", "1")
    ctx = AppContext.build(root, fake_llm=True, device="cpu")
    assert isinstance(ctx.embedder, HybridEmbedder) and ctx.embedder.w_lex == 0.9
    lex_dim = ctx.embedder.lexical.dim
    assert ctx.store.index.corpus.shape[1] == lex_dim + 64 and ctx.store.live_count == 160
    shutil.copytree(gckpt, os.path.join(root, "checkpoints", "grader"))
    ctx2 = AppContext.build(root, fake_llm=True, device="cpu")
    printed = capsys.readouterr().out
    assert "not ported" not in printed and "交叉编码器文档评分器已加载" in printed
    events = list(ctx2.graph_app.stream(
        {"messages": [user("高血压患者平时饮食需要注意什么？")], "user_id": "anonymous"},
        thread_id="t1"))
    assert events[-1][1]["final_answer"]
    # stale: the encoder's 14 arrays where the grader's 17 belong
    shutil.copy(os.path.join(ckpt, "params.npz"),
                os.path.join(root, "checkpoints", "grader", "params.npz"))
    ctx3 = AppContext.build(root, fake_llm=True, device="cpu")
    assert "回退 LLM grade" in capsys.readouterr().out
    for c, want in ((ctx, SimilarityGrader), (ctx2, TrainedGrader), (ctx3, SimilarityGrader)):
        assert isinstance(c.grade_fn, want)
    assert ctx.grade_fn.threshold == 0.2


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the bf16 decoder layer walk against JAX")
    ap.add_argument("--root", default=ROOT, help="checkout whose port is walked")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for mode, rows in layer_walk(os.path.abspath(args.root)).items():
        for name, (share, dmax, rel) in rows.items():
            print(f"{mode:5s} {name:6s} differing {share:.3e}  max|d| {dmax:.3e}  "
                  f"rel L2 {rel:.3e}")
