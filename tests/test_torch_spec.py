"""The port's speculative decoding and serving against the JAX package, on the CPU.

``flash_attention_cached(return_ml=True)`` against JAX's interpreted
Pallas kernel (bf16-layout float and int8 caches); ``prefill_extend(
all_logits=True)`` against JAX's; ``Decoder.extend_slots`` against JAX's
``_extend_slots_stacked`` (its flash form, the kernel interpreted), int8
KV and float, with an inactive lane; ``SpeculativeGenerator`` strings
against JAX's and against the port's ``Generator.generate``;
``LLMServer(draft=)`` strings against JAX's lockstep ``Generator.generate``
(the oracle); ``distill_draft`` against JAX's on the same weights and
batches; and the distill CLI's checkpoint served through ``--draft``'s
loader. The models are ``tests/test_speculative.py``'s TARGET and DRAFT
(f32, JAX's init), carried into the port with ``params_from_jax``. Inputs
come from ``np.random.default_rng``; every tolerance is stated where it is
asserted. Every port call passes ``device="cpu"``.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import DecoderConfig, TrainConfig
from mediquery_rag_tpu.models import distill as jdistill
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.generate import Generator as JGenerator
from mediquery_rag_tpu.models.speculative import SpeculativeGenerator as JSpec
from mediquery_rag_tpu.ops import attention as jattn
from mediquery_rag_tpu.ops import matvec as jmv
from mediquery_rag_tpu_torch.config import DecoderConfig as TDecoderConfig
from mediquery_rag_tpu_torch.config import TrainConfig as TTrainConfig
from mediquery_rag_tpu_torch.llm.torch_client import _cut_turn, render_chat
from mediquery_rag_tpu_torch.models import Decoder, Generator, KVCache
from mediquery_rag_tpu_torch.models import distill as tdistill
from mediquery_rag_tpu_torch.models.constrain import RISK_SCHEMA
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.models.speculative import SpeculativeGenerator
from mediquery_rag_tpu_torch.ops import attention as tattn
from mediquery_rag_tpu_torch.serve.llm import ChatSession, LLMServer
from mediquery_rag_tpu_torch.serve.server import load_draft

TARGET = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4,
                       mlp_dim=128, max_len=1024, dtype="float32")
DRAFT = DecoderConfig(vocab_size=384, hidden=32, layers=1, heads=2,
                      mlp_dim=64, max_len=1024, dtype="float32")
# decoder-level parity: GQA, q/k/v bias, flash attention in JAX's stacked form
GQA = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
                    mlp_dim=128, max_len=1024, qkv_bias=True, dtype="float32",
                    attn_impl="flash")
PROMPTS = ["高血压的饮食建议", "头痛", "BMI 如何计算？体重 70kg 身高 1.75m"]
# f32 logits of the same forward, attention and products summed in another order
LOGIT_TOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))      # writable copy


def _tcfg(cfg):
    return TDecoderConfig(**cfg.__dict__)


def _port_params(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def jparams():
    """JAX draws: the target from key 0, the draft from key 7 (as
    tests/test_speculative.py), the GQA decoder from key 0 with non-zero
    q/k/v biases."""
    gqa = JDecoder(GQA).init(jax.random.PRNGKey(0))
    gqa["blocks"]["qkv_b"] = jnp.asarray(np.random.default_rng(3).standard_normal(
        gqa["blocks"]["qkv_b"].shape).astype(np.float32) * 0.1)
    return {"target": JDecoder(TARGET).init(jax.random.PRNGKey(0)),
            "draft": JDecoder(DRAFT).init(jax.random.PRNGKey(7)),
            "gqa": gqa}


@pytest.fixture(scope="module")
def gens(jparams):
    """(JAX, port) Generators of the target and the draft on the same weights."""
    out = {}
    for name, cfg in (("target", TARGET), ("draft", DRAFT)):
        out[name] = (JGenerator(cfg, params=jparams[name]),
                     Generator(_tcfg(cfg), _port_params(jparams[name]), device="cpu"))
    return out


@pytest.fixture(scope="module")
def oracle(gens):
    """JAX lockstep greedy text of the target per (prompt, token budget)."""
    cache = {}

    def get(prompt, n):
        if (prompt, n) not in cache:
            cache[prompt, n] = gens["target"][0].generate([prompt], max_new_tokens=n)[0]
        return cache[prompt, n]

    return get


# -- B5's (m, l) outputs ------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_flash_attention_cached_ml_matches_jax(int8):
    """G = 3 query rows per lane over a 200-column cache (JAX pads it to 256
    under the -1e9 bias), 4q/2kv, on rows with a live column: o within 1e-5
    of JAX's interpreted kernel, m within 1e-5, l within 1e-5 relative.
    Lane 2 sees no live column: its (o, l) average over every column under
    the bias, JAX's padded ones included and the port's not, so there o is
    only required to be finite."""
    rng = np.random.default_rng(11)
    B, H, KH, G, C, dh = 3, 4, 2, 3, 200, 16
    q = rng.standard_normal((B, H, G, dh)).astype(np.float32)
    km = (rng.random((B, C)) < 0.5).astype(np.float32)
    km[2] = 0.0
    if int8:
        k = rng.integers(-127, 128, (B, KH, C, dh)).astype(np.int8)
        v = rng.integers(-127, 128, (B, KH, C, dh)).astype(np.int8)
        ks, vs = ((rng.random((B, KH, C)) * 0.02).astype(np.float32) for _ in "kv")
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=T(ks), v_scale=T(vs))
    else:
        k, v = (rng.standard_normal((B, KH, C, dh)).astype(np.float32) for _ in "kv")
        jkw, tkw = {}, {}
    jo, jm, jl = (np.asarray(t) for t in jattn.flash_attention_cached(
        *map(jnp.asarray, (q, k, v, km)), return_ml=True, **jkw))
    to, tm, tl = (t.numpy() for t in tattn.flash_attention_cached(
        T(q), T(k), T(v), T(km), return_ml=True, **tkw))
    assert to.shape == (B, H, G, dh) and tm.shape == tl.shape == (B, H, G)
    np.testing.assert_allclose(to[:2], jo[:2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm[:2], jm[:2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=1e-5)
    assert np.isfinite(to).all()


# -- the decoder's speculative primitives --------------------------------------------

@pytest.fixture(scope="module")
def prefilled(jparams):
    """JAX and port GQA decoders (float and int8 KV) after one left-padded
    prefill of 3 lanes into a 256-column cache."""
    rng = np.random.default_rng(12)
    B, S, C = 3, 128, 256
    ids = rng.integers(3, 259, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    ids[1, :40], mask[1, :40] = 0, 0.0
    out = {}
    for kv in ("", "int8"):
        cfg = replace(GQA, kv_dtype=kv)
        jd, td = JDecoder(cfg), Decoder(_tcfg(cfg), _port_params(jparams["gqa"]))
        jl, jc = jd.prefill(jparams["gqa"], jnp.asarray(ids), jnp.asarray(mask), C)
        tl, tc = td.prefill(T(ids), T(mask), C)
        out[kv] = (jd, td, jl, jc, tl, tc)
    return out


@pytest.mark.parametrize("kv", ["", "int8"])
def test_prefill_extend_all_logits_matches_jax(jparams, prefilled, kv):
    """A 5-token extension of lane 0 at column 128 with ``all_logits``: one
    distribution per token [5, V] within LOGIT_TOL of JAX's, the cache rows
    equal (int8 codes) or within 1e-5 (float, scales within 1e-6); with
    ``col0``/``pos0`` as 0-dim tensors (the speculative loop's cursor) the
    port gives the same logits and rows bit for bit."""
    jd, td, _, jc, _, tc = prefilled[kv]
    cand = np.array([5, 77, 200, 3, 150], np.int32)
    ones = np.ones(5, np.float32)
    scales = kv == "int8"
    want = jd.prefill_extend(jparams["gqa"], jc.k[:, 0], jc.v[:, 0], jc.key_mask[0],
                             jnp.asarray(cand), jnp.asarray(ones), jnp.int32(128),
                             jnp.int32(128), all_logits=True,
                             k_scale_row=jc.k_scale[:, 0] if scales else None,
                             v_scale_row=jc.v_scale[:, 0] if scales else None)
    got = []
    for col0, pos0 in ((128, 128), (torch.tensor(128), torch.tensor(128))):
        rows = [None if t is None else t.clone() for t in (
            tc.k[:, 0], tc.v[:, 0], tc.key_mask[0],
            tc.k_scale[:, 0] if scales else None, tc.v_scale[:, 0] if scales else None)]
        got.append(td.prefill_extend(rows[0], rows[1], rows[2], T(cand), T(ones), col0, pos0,
                                     all_logits=True, k_scale_row=rows[3],
                                     v_scale_row=rows[4]))
    assert got[0][0].shape == (5, TARGET.vocab_size)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got[0][3].numpy(), np.asarray(want[3]))
    for i in (1, 2):
        if scales:
            np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[i]))
        else:
            np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[i]), rtol=0,
                                       atol=1e-5)
    if scales:
        for i in (4, 5):
            np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[i]), rtol=0,
                                       atol=1e-6)
    for a, b in zip(got[0], got[1]):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("kv", ["", "int8"])
def test_extend_slots_matches_jax_stacked(jparams, prefilled, kv):
    """Two rounds of ``extend_slots`` with G = 4 at per-lane cursors (lane 1
    rolled back 20 columns, lane 2 inactive) against JAX's
    ``_extend_slots_stacked``: logits within LOGIT_TOL, the key mask,
    cursors and positions equal, the cache equal (int8 codes; float within
    1e-5, scales within 1e-6); the inactive lane's cursor, position and
    mask stay as they were."""
    jd, td, _, jc, _, tc = prefilled[kv]
    S = 128
    cur = np.array([S, S - 20, S], np.int32)
    jc = jc._replace(cursor=jnp.asarray(cur), key_mask=jc.key_mask.at[1, S - 20:].set(0.0))
    tc = KVCache(k=tc.k.clone(), v=tc.v.clone(), key_mask=tc.key_mask.clone(),
                 cursor=T(cur).long(), next_pos=tc.next_pos.clone(),
                 k_scale=None if tc.k_scale is None else tc.k_scale.clone(),
                 v_scale=None if tc.v_scale is None else tc.v_scale.clone())
    tc.key_mask[1, S - 20:] = 0.0
    frozen = (int(tc.cursor[2]), int(tc.next_pos[2]), tc.key_mask[2].clone())
    active = np.array([True, True, False])
    toks = np.random.default_rng(13).integers(3, 259, (2, 3, 4)).astype(np.int32)
    for r in range(2):
        jl, jc = jd._extend_slots_stacked(jparams["gqa"], jc, jnp.asarray(toks[r]),
                                          jnp.asarray(active))
        tl = td.extend_slots(tc, T(toks[r]), T(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(tc.cursor.numpy(), np.asarray(jc.cursor))
        np.testing.assert_array_equal(tc.next_pos.numpy(), np.asarray(jc.next_pos))
        np.testing.assert_array_equal(tc.key_mask.numpy(), np.asarray(jc.key_mask))
        if kv == "int8":
            np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
            np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0, atol=1e-5)
    assert tc.cursor.tolist() == [S + 8, S - 12, S]
    assert (int(tc.cursor[2]), int(tc.next_pos[2])) == frozen[:2]
    assert torch.equal(tc.key_mask[2], frozen[2])


def test_extend_slots_inactive_empty_lane_is_finite(jparams):
    """A lane that is inactive over an empty cache (never admitted) gives
    finite logits: the combine's denominator is clamped at 1e-30, as the
    decode fold's is."""
    td = Decoder(_tcfg(GQA), _port_params(jparams["gqa"]))
    cache = td.empty_cache(2, 128)
    logits = td.extend_slots(cache, torch.tensor([[5, 9, 11], [7, 3, 2]]),
                             torch.tensor([True, False]))
    assert torch.isfinite(logits).all()
    assert cache.cursor.tolist() == [3, 0]


def test_extend_slots_combine_takes_the_kernels_empty_cache_state(jparams, monkeypatch):
    """On the card, B5 gives a lane with no live cache column (o, m, l) = (0,
    -1e30, 0) (JAX's kernel: a padding-dependent average under the -1e9
    bias). ``extend_slots``' combine weighs that part by e^(m1 - m) l1 = 0,
    so its logits are finite and equal to those from the plain version's
    state, for an active lane with an empty cache and an inactive one."""
    from mediquery_rag_tpu_torch.models import decoder as tdec
    td = Decoder(_tcfg(GQA), _port_params(jparams["gqa"]))
    toks = torch.tensor([[5, 9, 11], [7, 3, 2]])
    act = torch.tensor([True, False])
    want = td.extend_slots(td.empty_cache(2, 128), toks, act)
    real = tdec.flash_attention_cached

    def kernel_state(q, k, v, key_mask, **kw):
        o, m, l = real(q, k, v, key_mask, **kw)
        empty = (key_mask.sum(-1) == 0)[:, None, None]
        return (torch.where(empty[..., None], 0.0, o), torch.where(empty, -1e30, m),
                torch.where(empty, 0.0, l))

    monkeypatch.setattr(tdec, "flash_attention_cached", kernel_state)
    got = td.extend_slots(td.empty_cache(2, 128), toks, act)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- SpeculativeGenerator ---------------------------------------------------------------

SPEC_CASES = {"gamma1": (1, 40), "gamma4": (4, 40), "eos_budget": (3, 96)}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_generator_matches_jax(gens, case):
    """The adversarial (random) draft: the port's strings equal JAX's
    ``SpeculativeGenerator`` and the port's own ``Generator.generate``
    exactly (f32 on the CPU), with JAX's round count; a 96-token budget
    lets EOS, where the model emits one, cut both at the same place."""
    gamma, n = SPEC_CASES[case]
    (jt, tt), (jd, td) = gens["target"], gens["draft"]
    spec = SpeculativeGenerator(tt, td, gamma=gamma)
    got = spec.generate(PROMPTS[:2], max_new_tokens=n)
    jspec = JSpec(jt, jd, gamma=gamma)
    assert got == jspec.generate(PROMPTS[:2], max_new_tokens=n)
    assert got == [tt.generate([p], max_new_tokens=n)[0] for p in PROMPTS[:2]]
    assert spec.last_stats == jspec.last_stats
    assert spec.last_stats["tokens_per_round"] >= 1.0


def test_speculative_exact_at_context_limit(jparams, gens):
    """max_len 192 and a prompt that buckets to 128: the budget is exactly
    64 and the cache's scratch tail takes the last round's candidates; the
    output equals the target's own decode and JAX's."""
    cfg = replace(TARGET, max_len=192)
    tt = Generator(_tcfg(cfg), _port_params(jparams["target"]), device="cpu")
    prompt = "高血压患者日常饮食应当注意哪些方面？" * 2
    got = SpeculativeGenerator(tt, gens["draft"][1], gamma=4).generate(
        [prompt], max_new_tokens=512)[0]
    assert got == tt.generate([prompt], max_new_tokens=512)[0]
    jt = JGenerator(cfg, params=jparams["target"])
    assert got == JSpec(jt, gens["draft"][0], gamma=4).generate([prompt],
                                                                max_new_tokens=512)[0]


def test_speculative_int4_target_and_perfect_draft(jparams, gens, oracle):
    """An int4 target (JAX's quantizer, carried over) stays lossless
    against its own decode and JAX's int4 lockstep decode; the target
    drafting for itself accepts every proposal: more than 4.0 tokens per
    round at gamma 4, output unchanged."""
    p4 = jmv.quantize_decoder_params(jparams["target"], bits=4)
    t4 = Generator(_tcfg(TARGET), _port_params(p4), device="cpu")
    got = SpeculativeGenerator(t4, gens["draft"][1], gamma=3).generate(
        PROMPTS[:1], max_new_tokens=32)
    assert got == [t4.generate(PROMPTS[:1], max_new_tokens=32)[0]]
    assert got == JGenerator(TARGET, params=p4).generate(PROMPTS[:1], max_new_tokens=32)
    tt = gens["target"][1]
    spec = SpeculativeGenerator(tt, tt, gamma=4)
    assert spec.generate(PROMPTS[:1], max_new_tokens=40) == [oracle(PROMPTS[0], 40)]
    assert spec.last_stats["tokens_per_round"] > 4.0
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeGenerator(tt, Generator(_tcfg(replace(DRAFT, vocab_size=512)),
                                           device="cpu"))


# -- LLMServer(draft=) -------------------------------------------------------------------

def test_spec_server_adversarial_and_perfect_drafts(gens, oracle):
    """An adversarial draft over 4 lanes: every string equals JAX's
    lockstep decode, and speculative quanta ran (rounds, tokens, one draft
    sync per prompt at least). The target as its own draft: output
    unchanged and at least 4 tokens per round (gamma 4)."""
    tt, td = gens["target"][1], gens["draft"][1]
    with LLMServer(tt, slots=4, chunk=8, draft=td, gamma=3) as srv:
        outs = [f.result(timeout=300) for f in
                [srv.submit(p, max_new_tokens=40) for p in PROMPTS]]
        stats = dict(srv.stats)
    assert outs == [oracle(p, 40) for p in PROMPTS]
    assert stats["spec_rounds"] > 0 and stats["spec_tokens"] > 0
    assert stats["draft_syncs"] >= len(PROMPTS)
    with LLMServer(tt, slots=2, chunk=10, draft=tt, gamma=4) as srv:
        out = srv.submit(PROMPTS[0], max_new_tokens=40).result(timeout=300)
        stats = dict(srv.stats)
    assert out == oracle(PROMPTS[0], 40)
    assert stats["spec_tokens"] >= 4 * stats["spec_rounds"] > 0


def test_spec_server_falls_back_for_sampled_and_constrained_lanes(gens, oracle):
    """A sampled lane sends the server to plain quanta while it runs; the
    greedy lane beside it stays exact and speculative quanta resume after
    (a draft resync). A constrained lane falls back too: its reply is JSON
    of the schema."""
    tt, td = gens["target"][1], gens["draft"][1]
    with LLMServer(tt, slots=2, chunk=8, draft=td, gamma=3) as srv:
        f_greedy = srv.submit(PROMPTS[0], max_new_tokens=64)
        f_sampled = srv.submit(PROMPTS[1], max_new_tokens=8, temperature=0.9)
        assert f_greedy.result(timeout=300) == oracle(PROMPTS[0], 64)
        assert isinstance(f_sampled.result(timeout=300), str)
        rounds = srv.stats["spec_rounds"]
        reply = srv.complete("血压 180/120", schema=RISK_SCHEMA)
        assert srv.stats["spec_rounds"] == rounds     # the constrained reply: plain quanta
    assert rounds > 0
    assert json.loads(reply)["risk"] in ("CRITICAL", "HIGH", "MEDIUM", "LOW")


def test_spec_server_session_matches_cold(gens, oracle):
    """A two-turn ``ChatSession`` over a speculative server: the second
    turn extends the parked lane (and marks its draft lane for a resync),
    and its reply equals JAX's lockstep decode of the whole transcript."""
    tt, td = gens["target"][1], gens["draft"][1]
    with LLMServer(tt, slots=2, chunk=8, draft=td, gamma=3) as srv:
        s = ChatSession(srv, max_new_tokens=24)
        s.ask("高血压饮食")
        r2 = s.ask("运动呢？")
        assert srv.stats["extends"] == 1
        assert srv.stats["draft_syncs"] >= 2
    assert r2 == _cut_turn(oracle(render_chat(s.messages[:-1]), 24), "plain")


def test_spec_server_small_draft_cache_windows(jparams, gens, oracle):
    """A draft of max_len 256 beside the target's 1,024-column cache: the
    draft lane re-windows (a second sync at least) and the 200-token reply
    is still the target's own."""
    small = replace(DRAFT, max_len=256)
    td = Generator(_tcfg(small), _port_params(JDecoder(small).init(jax.random.PRNGKey(11))),
                   device="cpu")
    with LLMServer(gens["target"][1], slots=1, chunk=10, draft=td, gamma=4) as srv:
        out = srv.submit(PROMPTS[0], max_new_tokens=200).result(timeout=600)
        syncs = srv.stats["draft_syncs"]
    assert out == oracle(PROMPTS[0], 200)
    assert syncs >= 2


def test_spec_server_cache_end_is_prefix_of_plain(gens):
    """Near the end of a 256-column cache a speculative lane needs room for
    gamma + 1 columns, so it may stop up to gamma + 1 tokens before the
    plain server; what it emits is a prefix of the plain server's reply."""
    tt, td = gens["target"][1], gens["draft"][1]
    prompt = "健康" * 60
    with LLMServer(tt, slots=1, chunk=8, cache_len=256) as plain:
        want = plain.complete(prompt, max_new_tokens=500)
    with LLMServer(tt, slots=1, chunk=8, cache_len=256, draft=td, gamma=3) as srv:
        got = srv.complete(prompt, max_new_tokens=500)
    assert want.startswith(got)
    assert len(want.encode()) - len(got.encode()) <= 4 * 3


# -- distillation --------------------------------------------------------------------------

def test_distill_draft_matches_jax(jparams, gens):
    """Three epochs of ``distill_draft`` from the same draft weights, on the
    same teacher tokens and batches: the last loss within 1e-4 relative of
    JAX's (f32 sums in another order over three AdamW steps) and the draft
    weights within 1e-4."""
    prompts = ["高血压饮食", "糖尿病运动", "头痛"]
    jt, tt = gens["target"]
    tcfg = dict(lr=3e-3, warmup_steps=2, decay_steps=10, remat=False)
    assert tt.generate_tokens(prompts, max_new_tokens=16) == jt.generate_tokens(
        prompts, max_new_tokens=16)
    tdr = tdistill.distill_draft(tt, _tcfg(DRAFT), prompts, max_new_tokens=16, epochs=3,
                                 train_cfg=TTrainConfig(**tcfg),
                                 init_params=_port_params(jparams["draft"]), device="cpu")
    # the JAX step donates its state: hand it a copy of the shared fixture
    jdr = jdistill.distill_draft(jt, DRAFT, prompts, max_new_tokens=16, epochs=3,
                                 train_cfg=TrainConfig(**tcfg),
                                 init_params=jax.tree_util.tree_map(jnp.array,
                                                                    jparams["draft"]))
    np.testing.assert_allclose(tdr.last_loss, jdr.last_loss, rtol=1e-4)
    want = _port_params(jdr.params)
    for name in ("tok_embed", "lm_head"):
        np.testing.assert_allclose(tdr.params[name].numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="vocab"):
        tdistill.distill_draft(tt, _tcfg(replace(DRAFT, vocab_size=512)), ["x"], device="cpu")


def test_distill_cli_roundtrip_serves_through_draft_loader(gens, oracle, tmp_path):
    """``python -m mediquery_rag_tpu_torch.models.distill`` on a saved
    target writes a checkpoint that ``serve --draft``'s loader restores
    (int8 weights here, ``--draft-quantize 8``) and ``LLMServer`` serves
    speculatively: the reply is still the target's own. An HF target
    directory is loaded as one (``tests/test_torch_hf.py`` distills from
    one): without weights it raises before anything is trained."""
    tt = gens["target"][1]
    tdir, odir = tmp_path / "target", tmp_path / "draft"
    tt.save(str(tdir))
    pfile = tmp_path / "p.txt"
    pfile.write_text("\n".join(PROMPTS), encoding="utf-8")
    tdistill.main(["--target", str(tdir), "--out", str(odir), "--preset", "tiny",
                   "--prompts-file", str(pfile), "--max-new", "16", "--epochs", "3",
                   "--device", "cpu"])
    draft = load_draft(str(odir), quantize=8, device="cpu")
    assert draft.cfg.hidden == 64 and isinstance(draft.params["lm_head"], dict)
    with LLMServer(tt, slots=1, chunk=6, draft=draft, gamma=2) as srv:
        got = srv.complete(PROMPTS[0], max_new_tokens=16)
        assert srv.stats["spec_rounds"] > 0
    assert got == oracle(PROMPTS[0], 16)
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps({
        "model_type": "qwen2", "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128}))
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        tdistill.main(["--target", str(hf), "--device", "cpu"])
