"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same inputs, drawn with ``np.random.default_rng``, go through the JAX
function (its Pallas kernels in interpret mode, as the JAX package's own
tests run them) and through the port's counterpart, whose CPU path is the
plain PyTorch version of each CUDA kernel. Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.ops import attention as jattn
from mediquery_rag_tpu.ops import matvec as jmv
from mediquery_rag_tpu.ops import scoring as jsc
from mediquery_rag_tpu.ops import topk as jtopk
from mediquery_rag_tpu_torch.ops import attention as tattn
from mediquery_rag_tpu_torch.ops import matvec as tmv
from mediquery_rag_tpu_torch.ops import scoring as tsc
from mediquery_rag_tpu_torch.ops import topk as ttopk


def T(a):
    return torch.from_numpy(np.array(a))     # writable copy


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_flat_search_matches_jax():
    """f32 corpus, N_pad 4096, n_valid 3000, D 64, B 5, k 10: ids equal,
    scores within 1e-5 (f32 sums of 64 terms in another order)."""
    rng = np.random.default_rng(0)
    c = _normal(rng, (4096, 64))
    c[3000:] = 0.0
    q = _normal(rng, (5, 64))
    js, ji = jsc.flat_search(jnp.asarray(q), jnp.asarray(c), 10, n_valid=3000)
    ts, ti = tsc.flat_search(T(q), T(c), 10, n_valid=3000)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=1e-5)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32


def test_flat_search_short_results_match_jax():
    """Fewer valid rows than k: both give (-inf, id 0) for the missing slots."""
    rng = np.random.default_rng(1)
    c = _normal(rng, (2048, 32))
    q = _normal(rng, (3, 32))
    js, ji = jsc.flat_search(jnp.asarray(q), jnp.asarray(c), 10, n_valid=4)
    ts, ti = tsc.flat_search(T(q), T(c), 10, n_valid=4)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=1e-5)
    assert np.isinf(ts.numpy()[:, 4:]).all()


@pytest.mark.parametrize("period", [64, 128, 100])
def test_flat_search_tie_rule_matches_jax_oracle(period):
    """Duplicated rows: exact ties. The port keeps lax.top_k's order (lower
    index first, == never displaces an earlier row), identical ids to the
    JAX oracle ``flat_search_xla``."""
    rng = np.random.default_rng(2)
    base = _normal(rng, (period, 32))
    c = np.concatenate([base] * (4096 // period + 1))[:4096]
    q = _normal(rng, (3, 32))
    _, ji = jsc.flat_search_xla(jnp.asarray(q), jnp.asarray(c), 10)
    _, ti = tsc.flat_search(T(q), T(c), 10)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_flat_search_ties_match_jax_kernel_sets():
    """Every row duplicated once (rows r and r + 2048): the JAX kernel picks
    the same tied pairs; within a pair its order follows its lane merge,
    so ids are compared as sets and scores position by position (1e-5)."""
    rng = np.random.default_rng(3)
    base = _normal(rng, (2048, 32))
    c = np.concatenate([base, base])
    q = _normal(rng, (4, 32))
    js, ji = jsc.flat_search(jnp.asarray(q), jnp.asarray(c), 10)
    ts, ti = tsc.flat_search(T(q), T(c), 10)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=1e-5)
    for r in range(4):
        assert set(np.asarray(ji)[r].tolist()) == set(ti.numpy()[r].tolist())


def test_flat_search_xla_matches_jax():
    rng = np.random.default_rng(4)
    c, q = _normal(rng, (500, 48)), _normal(rng, (6, 48))
    js, ji = jsc.flat_search_xla(jnp.asarray(q), jnp.asarray(c), 7)
    ts, ti = tsc.flat_search_xla(T(q), T(c), 7)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=1e-5)


def test_topk_and_merge_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 20, (4, 30)).astype(np.float32)     # many ties
    b = rng.integers(0, 20, (4, 25)).astype(np.float32)
    ia = rng.integers(0, 1000, (4, 30)).astype(np.int32)
    ib = rng.integers(0, 1000, (4, 25)).astype(np.int32)
    jv, jp = jtopk.exact_topk(jnp.asarray(a), 8)
    tv, tp = ttopk.exact_topk(T(a), 8)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    jv, ji = jtopk.merge_topk(*(jnp.asarray(x) for x in (a, ia, b, ib)), 12)
    tv, ti = ttopk.merge_topk(T(a), T(ia), T(b), T(ib), 12)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_quantize_weight_bytes_equal():
    rng = np.random.default_rng(6)
    w = _normal(rng, (96, 80))
    jq, js = jmv.quantize_weight(jnp.asarray(w))
    tq, ts = tmv.quantize_weight(T(w))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("b", [1, 5])
def test_quant_matvec_matches_jax(b):
    """rtol 1e-6: exact int32 sums on both sides, same f32 rescale."""
    rng = np.random.default_rng(7)
    w = _normal(rng, (64, 256))
    x = _normal(rng, (b, 64))
    jq, js = jmv.quantize_weight(jnp.asarray(w))
    out_j = np.asarray(jmv.quant_matvec(jnp.asarray(x), jq, js))
    out_t = tmv.quant_matvec(T(x), T(np.asarray(jq)), T(np.asarray(js))).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=0)


def test_quant_matvec_stacked_layer_matches_jax():
    rng = np.random.default_rng(8)
    w = _normal(rng, (3, 64, 128))
    x = _normal(rng, (2, 64))
    q, s = jax.lax.map(jmv.quantize_weight, jnp.asarray(w))
    for layer in range(3):
        out_j = np.asarray(jmv.quant_matvec(jnp.asarray(x), q, s,
                                            layer=jnp.int32(layer)))
        out_t = tmv.quant_matvec(T(x), T(np.asarray(q)), T(np.asarray(s)),
                                 layer=layer).numpy()
        np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=0)


def test_quantize_decoder_params_matches_jax():
    rng = np.random.default_rng(9)
    L, D, F, V = 2, 32, 48, 40
    params = {"tok_embed": _normal(rng, (V, D)), "rms_f": np.ones(D, np.float32),
              "lm_head": _normal(rng, (D, V)),
              "blocks": {"qkv": _normal(rng, (L, D, 3 * D)),
                         "attn_out": _normal(rng, (L, D, D)),
                         "w_gate": _normal(rng, (L, D, F)),
                         "w_up": _normal(rng, (L, D, F)),
                         "w_down": _normal(rng, (L, F, D)),
                         "rms1": np.ones((L, D), np.float32),
                         "rms2": np.ones((L, D), np.float32)}}
    jq = jax.tree_util.tree_map(np.asarray, jmv.quantize_decoder_params(
        jax.tree_util.tree_map(jnp.asarray, params)))
    tq = tmv.quantize_decoder_params(jax.tree_util.tree_map(T, params))
    assert set(jq["blocks"]) == set(tq["blocks"])
    # under jit XLA turns the /127 into a multiply by 1/127: scales may
    # differ in the last ulp (rtol 2.4e-7), which can move a code by one
    # at an exact rounding boundary (rare)
    for name in ("qkv", "attn_out", "w_gateup", "w_down"):
        np.testing.assert_allclose(tq["blocks"][name]["s"].numpy(),
                                   jq["blocks"][name]["s"], rtol=2.4e-7, atol=0)
        dq = np.abs(tq["blocks"][name]["q"].numpy().astype(np.int32)
                    - jq["blocks"][name]["q"].astype(np.int32))
        assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
    np.testing.assert_array_equal(jq["lm_head"]["q"], tq["lm_head"]["q"].numpy())


def _attn_inputs(rng, b, h, kh, s, dh):
    return (_normal(rng, (b, h, s, dh)), _normal(rng, (b, kh, s, dh)),
            _normal(rng, (b, kh, s, dh)))


def test_flash_attention_matches_jax():
    """4 q heads over 2 KV heads, left-padded mask, f32: within 1e-5 on every
    row with a visible key (fully masked rows are garbage by contract)."""
    rng = np.random.default_rng(10)
    q, k, v = _attn_inputs(rng, 2, 4, 2, 40, 16)
    mask = np.ones((2, 40), np.float32)
    mask[1, :7] = 0.0
    out_j = np.asarray(jattn.flash_attention(*(jnp.asarray(x) for x in (q, k, v, mask))))
    out_t = tattn.flash_attention(T(q), T(k), T(v), T(mask))
    assert torch.isfinite(out_t).all()
    live = mask[:, None, :, None] > 0
    np.testing.assert_allclose(np.where(live, out_t.numpy(), 0),
                               np.where(live, out_j, 0), rtol=0, atol=1e-5)


def test_flash_attention_matches_mha_reference():
    rng = np.random.default_rng(11)
    q, k, v = _attn_inputs(rng, 1, 6, 3, 33, 8)
    mask = np.ones((1, 33), np.float32)
    ref = np.asarray(jattn.mha_reference(*(jnp.asarray(x) for x in (q, k, v, mask)),
                                         8 ** -0.5))
    out = tattn.attention_plain(T(q), T(k), T(v), T(mask), 8 ** -0.5, causal=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [1, 3])
def test_flash_attention_cached_matches_jax(s):
    """Mask-only decode attention over a 200-column cache: within 1e-5."""
    rng = np.random.default_rng(12)
    q = _normal(rng, (2, 4, s, 16))
    k, v = _normal(rng, (2, 2, 200, 16)), _normal(rng, (2, 2, 200, 16))
    mask = np.zeros((2, 200), np.float32)
    mask[0, 5:150] = 1.0
    mask[1, :77] = 1.0
    out_j = np.asarray(jattn.flash_attention_cached(
        *(jnp.asarray(x) for x in (q, k, v, mask))))
    out_t = tattn.flash_attention_cached(T(q), T(k), T(v), T(mask)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)


def _kernel_numerics(q, k, v, mask, scale, causal, *, chunk, tile=64, skip_chunk=None,
                     ignore_mask=False):
    """The CUDA kernels' arithmetic in plain torch: per ``tile``-key tile an
    online softmax whose unnormalized P is rounded to bf16 before P.V, one
    (m, l, acc) per ``chunk`` keys (a split of the key range), chunks
    combined at the end. ``skip_chunk`` and ``ignore_mask`` inject the
    faults the bound must catch."""
    B, H, S, dh = q.shape
    C = k.shape[2]
    g = H // k.shape[1]
    kf, vf = (t.float().repeat_interleave(g, 1) for t in (k, v))
    vis = (mask > 0)[:, None, None, :] | ignore_mask
    if causal:
        vis = vis & (torch.arange(C)[None, :] <= torch.arange(S)[:, None])
    s_all = (q.float() @ kf.transpose(-1, -2)) * scale + (~vis).float() * -1e9
    parts = []
    for c0 in range(0, C, chunk):
        if c0 // chunk == skip_chunk:
            continue
        m = torch.full((B, H, S, 1), -1e30)
        l, acc = torch.zeros((B, H, S, 1)), torch.zeros((B, H, S, dh))
        for t0 in range(c0, min(C, c0 + chunk), tile):
            sc = s_all[..., t0:t0 + tile]
            mn = torch.maximum(m, sc.amax(-1, keepdim=True))
            p, corr = torch.exp(sc - mn), torch.exp(m - mn)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(torch.bfloat16).float() @ vf[..., t0:t0 + tile, :]
            m = mn
        parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    den = sum(l * torch.exp(m - top) for m, l, _ in parts)
    num = sum(a * torch.exp(m - top) for m, _, a in parts)
    return (num / den).to(torch.bfloat16)


@pytest.mark.parametrize("causal,tile,chunk", [
    (True, 128, None),    # B6 bf16: 128-key tiles, one block per row tile
    (True, 64, None),     # B6 int8: 64-key tiles
    (True, 64, 64),       # B6 int8 with its key range split over blocks, then combined
    (False, 64, 128),     # B5: 64-key tiles, the cache split over blocks
], ids=["b6-bf16", "b6-int8", "b6-int8-split", "b5-decode"])
def test_attention_error_bound_separates_rounding_from_faults(causal, tile, chunk):
    """The bound the card holds B5/B6 to: the kernels' own rounding (at
    each kernel's key-tile width and key-range split) stays well inside it,
    a dropped key tile (causal) or split (decode) or an ignored mask breaks
    it."""
    g = torch.Generator().manual_seed(13)
    b, s, c = (1, 256, 256) if causal else (2, 1, 1024)
    q = torch.randn((b, 8, s, 64), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((b, 2, c, 64), generator=g).to(torch.bfloat16) for _ in "kv")
    mask = torch.zeros((b, c))
    mask[:, 20:c if causal else c // 2] = 1.0
    chunk = chunk or c
    ref = tattn.attention_plain(q, k, v, mask, 0.125, causal=causal)
    bound = tattn.attention_error_bound(q, k, v, mask, 0.125, ref, causal=causal)
    live = mask[:, None, :s, None] > 0 if causal else torch.ones_like(mask[:, None, :1, None]) > 0

    def worst(out):
        return (((out.float() - ref.float()).abs() / bound) * live).max().item()

    run = dict(tile=tile, chunk=chunk)
    assert worst(_kernel_numerics(q, k, v, mask, 0.125, causal, **run)) < 0.75
    drop = tile if causal else chunk     # the 2nd key tile (causal) or split (decode)
    assert worst(_kernel_numerics(q, k, v, mask, 0.125, causal, tile=tile, chunk=drop,
                                  skip_chunk=1)) > 4.0
    assert worst(_kernel_numerics(q, k, v, mask, 0.125, causal, ignore_mask=True,
                                  **run)) > 4.0


def test_unported_options_raise():
    """``return_ml`` (speculative ``extend_slots``) returns (o, m, l) but
    cannot be combined with the fresh-column fold, as in JAX; half-given
    int8 scales or fresh columns and unknown bit widths are refused."""
    x = torch.zeros((1, 2, 1, 8))
    kv = torch.zeros((1, 2, 4, 8))
    m = torch.ones((1, 4))
    o, mx, l = tattn.flash_attention_cached(x, kv, kv, m, return_ml=True)
    assert o.shape == x.shape and mx.shape == l.shape == (1, 2, 1)
    assert torch.equal(l, torch.full((1, 2, 1), 4.0))       # four equal logits
    with pytest.raises(ValueError, match="fold"):
        tattn.flash_attention_cached(x, kv, kv, m, return_ml=True, fresh_k=x[:, :, :1],
                                     fresh_v=x[:, :, :1])
    with pytest.raises(ValueError):
        tattn.flash_attention_cached(x, kv, kv, m, k_scale=m[None])
    with pytest.raises(ValueError):
        tattn.flash_attention_cached(x, kv, kv, m, fresh_k=x)
    with pytest.raises(ValueError):
        tmv.quantize_decoder_params({}, bits=3)
