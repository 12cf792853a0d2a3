"""The port's continuous-batching LLM path against the JAX package, on the CPU.

A tiny decoder (f32, hidden 64, 2 layers, 4q/2kv, q/k/v bias, flash
attention) drawn by JAX, its weights carried into the port with
``params_from_jax``: the int4 quantizer and matvec, the int8 KV cache, the
fresh-column fold, ``flash_attention_at``, ``decode_step_slots`` against
JAX's stacked form and ``prefill_extend`` against JAX's, then the port's
``LLMServer`` held to JAX's lockstep ``Generator.generate`` (the oracle;
never JAX's threaded server) and served over HTTP through ``serve.main``'s
wiring; grammar-constrained decoding (``Generator.generate(constraint=)``,
constrained and free lanes side by side in ``LLMServer``, the health
extractor over ``TorchLLMClient``) held to JAX's greedy strings and facts.
JAX's Pallas kernels run in interpret mode. Inputs come from
``np.random.default_rng``; every tolerance is stated where it is asserted.
"""

import json
import time
import urllib.error
import urllib.request
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import DecoderConfig
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.decoder import _kv_quantize as jkv_quantize
from mediquery_rag_tpu.models import constrain as jconstrain
from mediquery_rag_tpu.models.generate import Generator as JGenerator
from mediquery_rag_tpu.ops import attention as jattn
from mediquery_rag_tpu.ops import matvec as jmv
from mediquery_rag_tpu_torch.config import DecoderConfig as TDecoderConfig
from mediquery_rag_tpu_torch.llm import TorchLLMClient
from mediquery_rag_tpu_torch.llm.torch_client import _cut_turn, render_chat
from mediquery_rag_tpu_torch.models import Decoder, Generator
from mediquery_rag_tpu_torch.models import constrain as tconstrain
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.models.decoder import _kv_quantize
from mediquery_rag_tpu_torch.ops import attention as tattn
from mediquery_rag_tpu_torch.ops import matvec as tmv
from mediquery_rag_tpu_torch.serve import build_app_server
from mediquery_rag_tpu_torch.serve.llm import (
    ChatSession, LLMServer, ServedLLMClient, ServerSaturated)

TINY = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
                     mlp_dim=128, max_len=1024, qkv_bias=True, dtype="float32",
                     attn_impl="flash")
TINY8 = replace(TINY, kv_dtype="int8")
PROMPTS = ["高血压的饮食建议", "头痛", "BMI 如何计算？体重 70kg 身高 1.75m"]
LONG = "高血压患者的日常饮食应当注意低盐低脂并保持适量运动与充足睡眠。" * 6


def T(a):
    return torch.from_numpy(np.array(a))      # writable copy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    params = JDecoder(TINY).init(jax.random.PRNGKey(0))
    qkv_b = np.random.default_rng(3).standard_normal(
        params["blocks"]["qkv_b"].shape).astype(np.float32) * 0.1
    params["blocks"]["qkv_b"] = jnp.asarray(qkv_b)    # non-zero biases
    return params


@pytest.fixture(scope="module")
def jparams4(jparams):
    return jmv.quantize_decoder_params(jparams, bits=4)


def _port_gen(cfg, params):
    return Generator(TDecoderConfig(**cfg.__dict__),
                     params_from_jax(_np_tree(params), device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def oracle(jparams, jparams4):
    """JAX lockstep greedy text for (config, weights, prompt, token budget)."""
    gens, cache = {}, {}

    def get(cfg, bits, prompt, n):
        key = (cfg.kv_dtype, bits, prompt, n)
        if key not in cache:
            if (cfg.kv_dtype, bits) not in gens:
                gens[cfg.kv_dtype, bits] = JGenerator(
                    cfg, params=jparams4 if bits == 4 else jparams)
            cache[key] = gens[cfg.kv_dtype, bits].generate([prompt], max_new_tokens=n)[0]
        return cache[key]

    return get


# -- int4 weights -----------------------------------------------------------------

def test_quantize_weight_int4_matches_jax():
    """Codes bit-equal; scales and equalizer within 2 ulp: the equalizer's
    geometric mean goes through log and exp, which XLA's CPU backend and
    torch round differently in the last bit (15% of f32 logs differ)."""
    rng = np.random.default_rng(0)
    for shape in [(128, 64), (384, 96)]:
        w = (rng.standard_normal(shape) * rng.random(shape[0])[:, None]).astype(np.float32)
        j = jmv.quantize_weight_int4(jnp.asarray(w))
        t = tmv.quantize_weight_int4(T(w))
        np.testing.assert_array_equal(np.asarray(j["q4"]), t["q4"].numpy())
        for k in ("s", "t"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=2.4e-7, atol=0)
        np.testing.assert_allclose(tmv.dequantize_weight_int4(t).numpy(),
                                   np.asarray(jmv.dequantize_weight_int4(j)),
                                   rtol=5e-7, atol=1e-9)


@pytest.mark.parametrize("layer", [None, 1])
def test_quant_matvec_int4_matches_jax(layer):
    """JAX's packed weights in both: exact integer dots, the same f32
    epilogue; within rtol 1e-6 (the row quantization's f32 rounding)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 64, 96)).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    if layer is None:
        jq = jmv.quantize_weight_int4(jnp.asarray(w[0]))
        want = jmv.quant_matvec_int4(jnp.asarray(x), jq)
    else:
        jq = jax.lax.map(jmv.quantize_weight_int4, jnp.asarray(w))
        want = jmv.quant_matvec_int4(jnp.asarray(x), jq, layer=jnp.int32(layer))
    tq = {k: T(v) for k, v in jq.items()}
    got = tmv.quant_matvec_int4(T(x), tq, layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the plain version is the kernel's exact arithmetic: integer dots
    wq = tq if layer is None else {k: v[layer] for k, v in tq.items()}
    x8, qs = tmv.quantize_rows_absmax(T(x) * wq["t"])
    dense = tmv.dequantize_weight_int4(wq)
    ref = (x8.double() @ (dense.double() / wq["t"].double()).T) * qs.double()[:, None]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_quantize_decoder_params_int4_matches_jax(jparams):
    """The port quantizes a float tree into JAX's int4 tree: the same keys
    and shapes, gate and up apart, codes equal."""
    j = jmv.quantize_decoder_params(jparams, bits=4)
    t = tmv.quantize_decoder_params(params_from_jax(_np_tree(jparams), device="cpu"), bits=4)
    assert set(t["blocks"]) == set(j["blocks"]) and "w_gateup" not in t["blocks"]
    for k in ("qkv", "attn_out", "w_gate", "w_up", "w_down"):
        for leaf in ("q4", "s", "t"):
            assert tuple(t["blocks"][k][leaf].shape) == j["blocks"][k][leaf].shape
        np.testing.assert_array_equal(t["blocks"][k]["q4"].numpy(),
                                      np.asarray(j["blocks"][k]["q4"]))
    np.testing.assert_array_equal(t["lm_head"]["q4"].numpy(), np.asarray(j["lm_head"]["q4"]))


# -- int8 KV and the attention variants --------------------------------------------

def test_kv_quantize_bit_equal():
    x = np.random.default_rng(2).standard_normal((2, 3, 7, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # the 1e-6 floor
    jc, js = jkv_quantize(jnp.asarray(x))
    tc, ts = _kv_quantize(T(x))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def _cache_inputs(rng, B, KH, C, dh, int8):
    if int8:
        k = rng.integers(-127, 128, (B, KH, C, dh)).astype(np.int8)
        v = rng.integers(-127, 128, (B, KH, C, dh)).astype(np.int8)
        return k, v, (rng.random((B, KH, C)) * 0.02).astype(np.float32), \
            (rng.random((B, KH, C)) * 0.02).astype(np.float32)
    return (rng.standard_normal((B, KH, C, dh)).astype(np.float32),
            rng.standard_normal((B, KH, C, dh)).astype(np.float32), None, None)


@pytest.mark.parametrize("int8,fresh", [(True, True), (False, True), (True, False)])
def test_flash_attention_cached_matches_jax(int8, fresh):
    """int8 codes + scales and/or the gated fresh-column fold, f32 inputs:
    within 1e-5 of JAX's interpreted kernel. Lane 2 is gated off over an
    empty cache: finite (zero), never NaN."""
    rng = np.random.default_rng(5)
    B, H, KH, C, dh = 3, 4, 2, 256, 16
    q = rng.standard_normal((B, H, 1, dh)).astype(np.float32)
    k, v, ks, vs = _cache_inputs(rng, B, KH, C, dh, int8)
    km = (rng.random((B, C)) < 0.5).astype(np.float32)
    km[2] = 0.0
    jkw, tkw = {}, {}
    if int8:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=T(ks), v_scale=T(vs))
    if fresh:
        fk, fv = (rng.standard_normal((B, KH, 1, dh)).astype(np.float32) for _ in "kv")
        gate = np.array([1.0, 0.0, 0.0], np.float32)
        jkw.update(fresh_k=jnp.asarray(fk), fresh_v=jnp.asarray(fv),
                   fresh_gate=jnp.asarray(gate))
        tkw.update(fresh_k=T(fk), fresh_v=T(fv), fresh_gate=T(gate))
    want = np.asarray(jattn.flash_attention_cached(
        *map(jnp.asarray, (q, k, v, km)), **jkw))
    got = tattn.flash_attention_cached(T(q), T(k), T(v), T(km), **tkw).numpy()
    live = [0, 1, 2] if fresh else [0, 1]          # no fold: lane 2 sees nothing
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
    assert np.isfinite(got).all()
    if fresh:
        assert (got[2] == 0.0).all()


@pytest.mark.parametrize("int8", [False, True])
def test_flash_attention_at_matches_jax(int8):
    """A 40-query suffix at column 100 over a 256-column cache with a left
    pad and a dead tail: within 1e-5 of JAX."""
    rng = np.random.default_rng(6)
    B, H, KH, C, dh, S = 2, 4, 2, 256, 16, 40
    q = rng.standard_normal((B, H, S, dh)).astype(np.float32)
    k, v, ks, vs = _cache_inputs(rng, B, KH, C, dh, int8)
    km = np.ones((B, C), np.float32)
    km[:, :5] = 0.0
    km[:, 160:] = 0.0
    col0 = np.array([100, 37], np.int32)
    jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if int8 else {}
    tkw = dict(k_scale=T(ks), v_scale=T(vs)) if int8 else {}
    want = np.asarray(jattn.flash_attention_at(*map(jnp.asarray, (q, k, v, km, col0)), **jkw))
    got = tattn.flash_attention_at(T(q), T(k), T(v), T(km), T(col0), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- the decoder's serving methods -------------------------------------------------

@pytest.fixture(scope="module")
def prefilled(jparams):
    """JAX and port int8-KV decoders after the same left-padded prefill."""
    jd = JDecoder(TINY8)
    td = Decoder(TDecoderConfig(**TINY8.__dict__), params_from_jax(_np_tree(jparams),
                                                                   device="cpu"))
    rng = np.random.default_rng(4)
    B, S, C = 3, 128, 256
    ids = rng.integers(3, 259, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    ids[1, :50], mask[1, :50] = 0, 0.0
    jl, jc = jd.prefill(jparams, jnp.asarray(ids), jnp.asarray(mask), C)
    tl, tc = td.prefill(T(ids), T(mask), C)
    return jparams, jd, td, jl, jc, tl, tc


def test_prefill_int8_kv_matches_jax(prefilled):
    """Attention within the prompt at full precision, the stored cache
    quantized: codes equal, scales within 1e-6 (f32 K/V from sums in
    another order), logits within 1e-4."""
    _, _, _, jl, jc, tl, tc = prefilled
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jc.key_mask), tc.key_mask.numpy())


def test_decode_step_slots_matches_jax_stacked(jparams):
    """Against JAX's ``_decode_step_slots_stacked`` (its fresh-fold form,
    flash in interpret mode), int8 KV, lanes at different cursors and lane
    1 inactive: logits within 1e-4, cache codes, key mask and cursors equal;
    the inactive lane's cursor and position stay frozen. (int4 weights
    through the slot lanes: the server case ``int4_weights_int8_kv``.)"""
    params = jparams
    jd = JDecoder(TINY8)
    td = Decoder(TDecoderConfig(**TINY8.__dict__), params_from_jax(_np_tree(params),
                                                                   device="cpu"))
    rng = np.random.default_rng(7)
    B, S, C = 3, 128, 256
    ids = rng.integers(3, 259, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    ids[2, :70], mask[2, :70] = 0, 0.0
    jl, jc = jd.prefill(params, jnp.asarray(ids), jnp.asarray(mask), C)
    tl, tc = td.prefill(T(ids), T(mask), C)
    cur = np.array([S, S - 20, S], np.int32)        # lane 1 rolled back 20 columns
    jc = jc._replace(cursor=jnp.asarray(cur),
                     key_mask=jc.key_mask.at[1, S - 20:].set(0.0))
    tc.cursor = T(cur).long()
    tc.key_mask[1, S - 20:] = 0.0
    active = np.array([True, False, True])
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    pos1 = int(tc.next_pos[1])
    for _ in range(2):
        jl, jc = jd._decode_step_slots_stacked(params, jc, jnp.asarray(tok),
                                               jnp.asarray(active))
        tl = td.decode_step_slots(tc, T(tok), T(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(np.asarray(jc.cursor), tc.cursor.numpy())
        np.testing.assert_array_equal(np.asarray(jc.key_mask), tc.key_mask.numpy())
        np.testing.assert_array_equal(np.asarray(jc.k), tc.k.numpy())
        np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=0,
                                   atol=1e-6)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tc.cursor.tolist() == [S + 2, S - 20, S + 2]
    assert int(tc.next_pos[1]) == pos1


def test_prefill_extend_rollback_matches_jax(prefilled):
    """Lane 0 rolled back to column 100 and a right-padded 70-token suffix
    prefilled there (int8 KV, in place on copies of the lane's rows):
    logits within 1e-4, codes and key mask equal, scales within 1e-6."""
    jparams, jd, td, _, jc, _, tc = prefilled
    rng = np.random.default_rng(8)
    ids = rng.integers(3, 259, (128,)).astype(np.int32)
    mask = np.zeros(128, np.float32)
    mask[:70] = 1.0
    want = jd.prefill_extend(jparams, jc.k[:, 0], jc.v[:, 0], jc.key_mask[0],
                             jnp.asarray(ids), jnp.asarray(mask), jnp.int32(100),
                             jnp.int32(100), k_scale_row=jc.k_scale[:, 0],
                             v_scale_row=jc.v_scale[:, 0])
    rows = [t.clone() for t in (tc.k[:, 0], tc.v[:, 0], tc.key_mask[0],
                                tc.k_scale[:, 0], tc.v_scale[:, 0])]
    got = td.prefill_extend(rows[0], rows[1], rows[2], T(ids), T(mask), 100, 100,
                            k_scale_row=rows[3], v_scale_row=rows[4])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-6)
    assert got[3][:100].sum() == tc.key_mask[0, :100].sum()      # the prefix stays
    assert got[3][170:].sum() == 0                                # the rest is dead


def test_int8_kv_checkpoint_loads_and_generates_like_jax(jparams, tmp_path):
    """A JAX ``Generator.save`` of an int8-KV model loads in the port with
    its config, and lockstep greedy generation gives JAX's strings."""
    jgen = JGenerator(TINY8, params=jparams)
    jgen.save(str(tmp_path))
    tgen = Generator.from_checkpoint(str(tmp_path), device="cpu")
    assert tgen.cfg.kv_dtype == "int8" and tgen.model.quant_kv
    assert jgen.generate(PROMPTS[:2], max_new_tokens=16) == tgen.generate(
        PROMPTS[:2], max_new_tokens=16)


# -- LLMServer against JAX's lockstep generate ---------------------------------------

def _wait(pred, timeout=120.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("server made no progress")
        time.sleep(0.005)


def _case_concurrent(gen, want):
    with LLMServer(gen, slots=4, chunk=8) as srv:
        outs = [f.result(timeout=300) for f in
                [srv.submit(p, max_new_tokens=48) for p in PROMPTS]]
    assert outs == [want(p, 48) for p in PROMPTS]


def _case_more_than_slots(gen, want):
    with LLMServer(gen, slots=2, chunk=8) as srv:
        outs = srv.complete_batch(PROMPTS * 2, max_new_tokens=32, timeout=300)
        assert srv.stats["prefills"] == 6
    assert outs == [want(p, 32) for p in PROMPTS * 2]


def _case_chunked_prefill(gen, want):
    with LLMServer(gen, slots=2, chunk=4, prefill_chunk=128) as srv:
        f1 = srv.submit(PROMPTS[0], max_new_tokens=48)
        _wait(lambda: srv.stats["chunks"] > 0)        # a co-tenant is decoding
        f2 = srv.submit(LONG, max_new_tokens=24)
        o1, o2 = f1.result(timeout=300), f2.result(timeout=300)
        assert srv.stats["prefill_pieces"] >= 2
    assert o1 == want(PROMPTS[0], 48) and o2 == want(LONG, 24)


def _case_session(gen, want):
    with LLMServer(gen, slots=2, chunk=8) as srv:
        s = ChatSession(srv, max_new_tokens=24)
        s.ask("高血压饮食")
        r2 = s.ask("运动呢？")
        assert srv.stats["extends"] >= 1 and srv.stats["prefix_tokens_reused"] > 0
    # a cold full prefill of the same transcript gives the same reply
    assert r2 == _cut_turn(want(render_chat(s.messages[:-1]), 24), "plain")


CASES = {"concurrent": (_case_concurrent, TINY, None),
         "more_requests_than_slots": (_case_more_than_slots, TINY, None),
         "chunked_prefill": (_case_chunked_prefill, TINY, None),
         "two_turn_session": (_case_session, TINY, None),
         "int4_weights_int8_kv": (_case_concurrent, TINY8, 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_llm_server_greedy_matches_jax_lockstep(jparams, jparams4, oracle, case):
    """Greedy strings equal JAX's lockstep ``Generator.generate`` on the
    same weights, whoever shares the batch and however the prompt landed."""
    run, cfg, bits = CASES[case]
    gen = _port_gen(cfg, jparams4 if bits == 4 else jparams)
    run(gen, lambda p, n: oracle(cfg, bits, p, n))


@pytest.fixture(scope="module")
def tgen(jparams):
    return _port_gen(TINY, jparams)


def test_failing_step_fails_futures_and_recovers(tgen, oracle):
    """A step that raises fails the in-flight futures with its error (no
    fallback), and the server keeps serving the next request exactly."""
    with LLMServer(tgen, slots=2, chunk=8) as srv:
        real = srv.model.decode_step_slots

        def bad(*a, **k):
            raise RuntimeError("injected step failure")

        srv.model.decode_step_slots = bad
        try:
            f = srv.submit(PROMPTS[0], max_new_tokens=16)
            with pytest.raises(RuntimeError, match="injected"):
                f.result(timeout=300)
            assert srv.stats["errors"] >= 1
        finally:
            srv.model.decode_step_slots = real
        assert srv.complete(PROMPTS[1], max_new_tokens=16) == oracle(TINY, None, PROMPTS[1], 16)


def test_unported_server_options_raise(tgen):
    """Speculative serving (``draft=``) is ported (``tests/test_torch_spec.py``);
    what it still refuses, as JAX does: a draft of another vocabulary, a
    gamma below 1, and more rounds per quantum than the draft cache holds.
    A draft that fits sizes its cache and rounds as JAX's: ceil(chunk / 2)
    rounds, the cache cut to a 128 multiple."""
    small = Generator(TDecoderConfig(**replace(TINY, max_len=256).__dict__), seed=2,
                      device="cpu")
    other = Generator(TDecoderConfig(**replace(TINY, vocab_size=512).__dict__), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        LLMServer(tgen, draft=other)
    with pytest.raises(ValueError, match="gamma"):
        LLMServer(tgen, draft=small, gamma=0)
    with pytest.raises(ValueError, match="too small"):
        LLMServer(tgen, draft=small, gamma=4, spec_rounds=40)
    with LLMServer(tgen, chunk=8, draft=small, gamma=4) as srv:
        assert (srv.Cd, srv._rounds, srv._margin) == (256, 4, 5)


# -- grammar-constrained decoding ------------------------------------------------------

SCHEMAS = {"extract": (jconstrain.EXTRACT_SCHEMA, tconstrain.EXTRACT_SCHEMA),
           "risk": (jconstrain.RISK_SCHEMA, tconstrain.RISK_SCHEMA)}
FACTS = "我对青霉素过敏，每天吃二甲双胍"


@pytest.fixture(scope="module")
def constrained_oracle(jparams):
    """JAX lockstep greedy text under a compiled schema, per (schema, prompts)."""
    gen = JGenerator(TINY, params=jparams)
    cache = {}

    def get(name, prompts):
        key = (name, tuple(prompts))
        if key not in cache:
            c = jconstrain.JsonConstraint.compile(SCHEMAS[name][0], gen.tokenizer,
                                                  vocab_size=TINY.vocab_size)
            cache[key] = gen.generate(list(prompts), max_new_tokens=8, constraint=c)
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_constrained_greedy_matches_jax(tgen, constrained_oracle, name):
    """``Generator.generate(constraint=)``: the same greedy strings as JAX's
    on the same weights, each accepted by the schema's DFA, and the same
    tables as JAX's compiler (the module is a copy)."""
    prompts = [render_chat(FACTS), render_chat("头痛")]
    tc = tconstrain.JsonConstraint.compile(SCHEMAS[name][1], tgen.tokenizer,
                                           vocab_size=TINY.vocab_size)
    jc = jconstrain.JsonConstraint.compile(SCHEMAS[name][0], JGenerator(TINY).tokenizer,
                                           vocab_size=TINY.vocab_size)
    np.testing.assert_array_equal(tc.next_table, jc.next_table)
    outs = tgen.generate(prompts, max_new_tokens=8, constraint=tc)
    assert outs == constrained_oracle(name, prompts)
    assert all(tc.accepts(o) for o in outs)


def test_llm_server_constrained_and_free_lanes(tgen, oracle, constrained_oracle):
    """A constrained lane and a free-text lane side by side in one server:
    each equals JAX's lockstep output (the constrained one under its
    schema), and ``ServedLLMClient(schema=)`` returns the JSON unstripped
    of markers."""
    p_json, p_free = render_chat(FACTS), PROMPTS[1]
    with LLMServer(tgen, slots=2, chunk=8) as srv:
        f1 = srv.submit(p_json, max_new_tokens=8, schema=tconstrain.RISK_SCHEMA)
        f2 = srv.submit(p_free, max_new_tokens=24)
        o1, o2 = f1.result(timeout=300), f2.result(timeout=300)
        o3 = ServedLLMClient(srv).complete(FACTS, schema=tconstrain.EXTRACT_SCHEMA)
    assert o1 == constrained_oracle("risk", [p_json])[0]
    assert o2 == oracle(TINY, None, p_free, 24)
    assert o3 == constrained_oracle("extract", [p_json])[0].strip()


def test_health_extractor_stores_facts_like_jax(tmp_path, caplog):
    """With a ``TorchLLMClient`` the port's extractor decodes under
    ``EXTRACT_SCHEMA``, parses the reply, logs no error and stores as many
    facts as JAX's extractor with ``TPULLMClient`` on the same weights.
    The weights are JAX's init from ``PRNGKey(3)``: on them the random
    model's constrained reply holds facts (on the module fixture's it is
    ``[]``, which would store nothing on either side)."""
    from mediquery_rag_tpu.app.memory import ProfileStore as JProfileStore
    from mediquery_rag_tpu.app.memory import extract_health_info as jextract
    from mediquery_rag_tpu.llm.tpu_client import TPULLMClient
    from mediquery_rag_tpu_torch.app.memory import ProfileStore, extract_health_info
    params = JDecoder(TINY).init(jax.random.PRNGKey(3))
    jstore = JProfileStore(str(tmp_path / "j.sqlite"))
    tstore = ProfileStore(str(tmp_path / "t.sqlite"))
    n_jax = jextract(FACTS, "u1", TPULLMClient(JGenerator(TINY, params=params)), jstore)
    with caplog.at_level("WARNING"):
        n_port = extract_health_info(FACTS, "u1", TorchLLMClient(_port_gen(TINY, params)),
                                     tstore)
    assert not [r for r in caplog.records if "extraction failed" in r.getMessage()]
    assert n_port == n_jax >= 1
    assert ([(r.category, r.content) for r in tstore.get_health_records("u1")]
            == [(r.category, r.content) for r in jstore.get_health_records("u1")])


# -- over HTTP --------------------------------------------------------------------------

def _post(port, path, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


class _NoStore:
    def batch_search(self, queries, k, **kw):
        return [[] for _ in queries]


def test_backlog_saturation_is_http_429(tgen):
    """One lane busy, one request queued, ``max_backlog=1``: the next
    submit raises ``ServerSaturated`` and HTTP answers 429; the backlog
    drains once the lane frees."""
    from mediquery_rag_tpu_torch.serve.server import SearchServer
    with LLMServer(tgen, slots=1, chunk=4, max_backlog=1) as srv:
        f1 = srv.submit(PROMPTS[0], max_new_tokens=512)
        _wait(lambda: srv.stats["prefills"] > 0)
        f2 = srv.submit(PROMPTS[1], max_new_tokens=8)
        with pytest.raises(ServerSaturated):
            srv.submit(PROMPTS[2], max_new_tokens=8)
        http = SearchServer(_NoStore(), llm_server=srv)
        port = http.start("127.0.0.1", 0)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, "/v1/chat/completions",
                      {"messages": [{"role": "user", "content": "头痛"}], "max_tokens": 4})
            assert e.value.code == 429
            assert "ServerSaturated" in json.loads(e.value.read())["error"]
        finally:
            http.shutdown()
        assert srv.stats["rejected"] == 2
        f1.cancel()
        assert isinstance(f2.result(timeout=300), str)


def test_chat_completions_and_qa_through_serve_wiring(jparams):
    """``build_app_server`` (``serve.main``'s wiring) over a context whose
    LLM is a ``TorchLLMClient`` on the tiny model: /v1/chat/completions
    answers (not "not configured"), its stream concatenates to the same
    content, and /qa answers through the server's lanes."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.ingest import build_document_store, parse_corpus_file
    from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
    corpus = "data/medical_data.txt"
    store = build_document_store(corpus, IDFHashingEmbedder.fit_chunks(
        parse_corpus_file(corpus)), EngineConfig(), device="cpu")
    # /qa prompts carry 5 retrieved chunks (~3,500 bytes); a 2,048-column
    # cache keeps their tails, as the server truncates any long prompt
    gen = _port_gen(replace(TINY8, max_len=2048), jparams)
    ctx = SimpleNamespace(store=store, llm=TorchLLMClient(gen, max_new_tokens=16),
                          web_search=None)
    server = build_app_server(ctx)
    assert isinstance(server.llm_server, LLMServer)
    port = server.start("127.0.0.1", 0)
    try:
        body = {"messages": [{"role": "user", "content": "咳嗽有痰"}], "max_tokens": 24}
        status, text = _post(port, "/v1/chat/completions", body)
        out = json.loads(text)
        assert status == 200 and out["object"] == "chat.completion"
        content = out["choices"][0]["message"]["content"]
        assert out["choices"][0]["finish_reason"] in {"stop", "length"}
        status, text = _post(port, "/v1/chat/completions", {**body, "stream": True})
        chunks, done = [], False
        for line in text.splitlines():
            if line.startswith("data: "):
                data = line[len("data: "):]
                if data == "[DONE]":
                    done = True
                    break
                delta = json.loads(data)["choices"][0]["delta"]
                chunks.append(delta.get("content", ""))
        assert status == 200 and done and "".join(chunks) == content
        status, text = _post(port, "/qa", {"question": "高血压患者饮食注意什么"})
        qa = json.loads(text)
        assert status == 200 and isinstance(qa["answer"], str) and qa["answer"]
        assert len(qa["docs"]) == 5
        assert server.llm_server.stats["requests"] >= 3   # /qa rode the lanes
    finally:
        server.shutdown()
        server.llm_server.close()
