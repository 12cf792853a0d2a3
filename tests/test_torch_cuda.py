"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. On the GPU machine
(no JAX there, and tests/conftest.py imports it) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs come from ``np.random.default_rng``; each tolerance is stated with
its reason beside the assertion.
"""

import numpy as np
import pytest
import torch

from mediquery_rag_tpu_torch.ops import attention, ivf_kernel, matvec, quant, scoring

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.parametrize("n_pad,n_valid,b,k,d", [
    (4096, 3000, 5, 10, 64), (2048, 7, 3, 10, 3072), (65536, 65536, 40, 128, 768),
    (8192, 8000, 64, 40, 96)])
def test_flat_topk_f32_matches_plain(dev, n_pad, n_valid, b, k, d):
    """B1 on an f32 corpus (CUDA-core f32 sums, no TF32) against the plain
    f32 product with TF32 off: unit rows, so each score's f32 rounding error
    is at most D * 2^-24 (5e-5 at D = 768); ids equal but for scores closer
    than that; short results (-inf, id 0). D = 96 leaves a partial piece of
    the staged query columns."""
    rng = np.random.default_rng(11)
    c = rng.standard_normal((n_pad, d)).astype(np.float32)
    c = torch.from_numpy(c / np.linalg.norm(c, axis=1, keepdims=True)).to(dev)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = scoring.flat_topk_f32_cuda.launches
    ks, ki = scoring.flat_topk_cuda(q, c, k, n_valid)
    ps, pi = scoring.flat_search_plain(q, c, k, n_valid)
    torch.cuda.synchronize()
    assert scoring.flat_topk_f32_cuda.launches == before + 1
    tol = d * 2.0 ** -24
    fin = torch.isfinite(ps)
    assert torch.equal(torch.isinf(ks), torch.isinf(ps))
    assert (ks[fin] - ps[fin]).abs().max().item() <= tol
    differ = ki != pi
    assert ((ks - ps).abs()[differ] <= 2 * tol).all() or not differ.any()
    if n_valid < k:
        assert torch.isinf(ks[:, n_valid:]).all() and (ki[:, n_valid:] == 0).all()


@pytest.mark.parametrize("n_pad,n_valid,b,k,d", [
    (4096, 3000, 5, 10, 64), (2048, 7, 3, 10, 3072), (65536, 65536, 40, 128, 768)])
def test_flat_topk_matches_plain(dev, n_pad, n_valid, b, k, d):
    rng = np.random.default_rng(0)
    c = _bf16(rng, (n_pad, d), dev)
    q = _bf16(rng, (b, d), dev)
    ks, ki = scoring.flat_topk_cuda(q, c, k, n_valid)
    ps, pi = scoring.flat_search_plain(q, c, k, n_valid)
    torch.cuda.synchronize()
    # f32 sums in another order: scores within 1e-3 relative to |score| ~ sqrt(d)
    assert torch.allclose(ks, ps, rtol=0, atol=1e-3 * d ** 0.5)
    agree = (ki == pi).float().mean().item()
    assert agree >= 0.99
    if n_valid < k:                     # short results: (-inf, id 0)
        assert torch.isinf(ks[:, n_valid:]).all() and (ki[:, n_valid:] == 0).all()


# B2's edge cases for the Hopper scan, held on B1: partly filled 32/64/128-
# query blocks, n_valid ending inside a block's range, two query groups,
# D = 3072, k = 1 and 128, duplicated rows at the k-th boundary, B = 1 (15
# zero-padded query columns, which score 0 on every row)
B1_EDGES = [
    (4096, 3001, 17, 10, 64, 1),        # a partly filled 32-query block
    (20480, 20000, 63, 10, 768, 1),     # a partly filled 64-query block
    (65536, 40000, 65, 10, 768, 1),     # 65 queries; n ends inside a block's range
    (8192, 8192, 128, 40, 768, 1),      # 128 queries streamed in the ring
    (8192, 5000, 64, 10, 3072, 1),      # D = 3072 (f32: 64 queries streamed)
    (4096, 4096, 1, 1, 96, 1),          # k = 1, B = 1
    (16384, 16384, 5, 128, 128, 1),     # k at the cap
    (2048, 2048, 4, 10, 128, 32),       # duplicated rows: ties at the boundary
    (131072, 131072, 1, 10, 768, 1),    # B = 1 over many tiles
    (4000 + 96, 4000, 130, 10, 64, 1),  # 130 queries, the last group nearly empty
    (4096, 4096, 48, 10, 768, 1),       # f32: 48 queries of a 64-query streamed block
]


def _b1_case(rng, n_pad, n_valid, b, d, dup, f32, dev):
    base = rng.standard_normal((n_pad // dup, d)).astype(np.float32)
    c = np.concatenate([base] * dup)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if f32:                             # unit rows: each f32 sum within D 2^-24
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return torch.from_numpy(q).to(dev), torch.from_numpy(c).to(dev)
    return (torch.from_numpy(q).to(dev, torch.bfloat16),
            torch.from_numpy(c).to(dev, torch.bfloat16))


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("n_pad,n_valid,b,k,d,dup", B1_EDGES)
def test_flat_topk_scan_edges(dev, f32, n_pad, n_valid, b, k, d, dup):
    """B1 bf16 within 1e-3 sqrt(D) of plain, ids >= 99% equal; B1 f32 within
    D 2^-24, ids differing only where scores are closer than twice that;
    duplicated rows tie exactly and the lower row wins (both dtypes); short
    results (-inf, id 0)."""
    rng = np.random.default_rng(13)
    q, c = _b1_case(rng, n_pad, n_valid, b, d, dup, f32, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    ks, ki = scoring.flat_topk_cuda(q, c, k, n_valid)
    ps, pi = scoring.flat_search_plain(q, c, k, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(ks), torch.isinf(ps))
    fin = torch.isfinite(ps)
    if f32:
        tol = d * 2.0 ** -24
        assert (ks[fin] - ps[fin]).abs().max().item() <= tol
        differ = ki != pi
        assert not differ.any() or ((ks - ps).abs()[differ] <= 2 * tol).all()
    else:
        assert (ks[fin] - ps[fin]).abs().max().item() <= 1e-3 * d ** 0.5
        assert (ki == pi).float().mean().item() >= 0.99
    if dup > 1:                         # exact duplicates: the lower rows, in order
        assert torch.equal(ki, pi)
    if n_valid < k:
        assert torch.isinf(ks[:, n_valid:]).all() and (ki[:, n_valid:] == 0).all()


def test_flat_topk_tie_rule(dev):
    """Duplicated rows: among equal scores the lower row wins, in order."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((64, 128)).astype(np.float32)
    c = np.concatenate([base] * 32)            # row r == row r % 64
    c = torch.from_numpy(c).to(dev, torch.bfloat16)
    q = _bf16(rng, (4, 128), dev)
    ks, ki = scoring.flat_topk_cuda(q, c, 10, c.shape[0])
    ps, pi = scoring.flat_search_plain(q, c, 10, c.shape[0])
    torch.cuda.synchronize()
    assert (ki == pi).all()                    # exact scores tie exactly


@pytest.mark.parametrize("b,f,d,layer", [
    (1, 4608, 3584, None), (8, 384, 3584, None), (13, 256, 1024, 2),
    (128, 520, 64, None)])
def test_matvec_int8_bit_equal(dev, b, f, d, layer):
    rng = np.random.default_rng(2)
    lead = (3,) if layer is not None else ()
    w8 = torch.from_numpy(rng.integers(-127, 128, lead + (f, d)).astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.random(lead + (f,)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    out = matvec.quant_matvec(x, w8, s, layer=layer)
    x8, qs = matvec.quantize_rows_absmax(x)
    wl, sl = (w8, s) if layer is None else (w8[layer], s[layer])
    ref = matvec.int8_matmul_plain(x8, wl, sl) * qs[:, None]
    torch.cuda.synchronize()
    assert torch.equal(out, ref)               # exact int32 sums, same f32 scaling


# the 7B-class projections (Qwen2.5-7B widths): (in, out)
SHAPES_7B = {"qkv": (3584, 4608), "attn_out": (3584, 3584), "w_gate": (3584, 18944),
             "w_up": (3584, 18944), "w_down": (18944, 3584), "lm_head": (3584, 384)}


def _int4_case(rng, d, f, b, dev):
    w = torch.from_numpy(rng.standard_normal((d, f)).astype(np.float32)).to(dev)
    wq = matvec.quantize_weight_int4(w)
    x = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    return wq, x


def _int4_ref(x, wq):
    x8, qs = matvec.quantize_rows_absmax(x * wq["t"])
    corr = 8.0 * x8.to(torch.int32).sum(dim=-1, keepdim=True).float()
    return matvec.int4_matmul_plain(x8, corr, wq["q4"], wq["s"]) * qs[:, None]


@pytest.mark.parametrize("b", [1, 4, 8, 9, 20, 128])
@pytest.mark.parametrize("name", list(SHAPES_7B))
def test_matvec_int4_bit_equal_at_7b_shapes(dev, name, b):
    """B7 at every 7B projection for decode (1, 4, 8), a 9th row, the
    B=4, gamma=4 verify pass (20) and a short prefill (128): each launch
    reads the weights once for all its rows, split over blocks along D."""
    d, f = SHAPES_7B[name]
    wq, x = _int4_case(np.random.default_rng(9), d, f, b, dev)
    out = matvec.quant_matvec_int4(x, wq)
    ref = _int4_ref(x, wq)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)     # exact int32 dots, the same f32 epilogue


@pytest.mark.parametrize("b", [5, 37, 129])
def test_matvec_int4_ragged_slices(dev, b):
    """D = 400 ends inside a 1 KB slice and F/2 = 500 inside a 16-row tile
    (both zero-filled in the ring); 37 and 129 rows take 2 and 5 blocks of
    x rows per weight tile."""
    wq, x = _int4_case(np.random.default_rng(11), 400, 1000, b, dev)
    before = matvec.matvec_int4_cuda.launches
    out = matvec.quant_matvec_int4(x, wq)
    ref = _int4_ref(x, wq)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert matvec.matvec_int4_cuda.launches - before == 1


@pytest.mark.parametrize("b", [6, 20])
@pytest.mark.parametrize("layer", [0, 2])
def test_matvec_int4_stacked_layer_offset(dev, layer, b):
    """B7s: the first and the last layer of stacked ``[L, F/2, D]`` weights
    by pointer offset."""
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.standard_normal((3, 512, 768)).astype(np.float32))
    parts = [matvec.quantize_weight_int4(w[i]) for i in range(3)]
    wq = {k: torch.stack([p[k] for p in parts]).to(dev) for k in ("q4", "s", "t")}
    x = torch.from_numpy(rng.standard_normal((b, 512)).astype(np.float32)).to(dev)
    out = matvec.quant_matvec_int4(x, wq, layer=layer)
    # the reference quantizes x on the CPU: row scales are the correctly
    # rounded quotient on both devices
    ref = _int4_ref(x.cpu(), {k: v[layer].cpu() for k, v in wq.items()})
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)


def test_matvec_int4_back_to_back_shapes(dev):
    """Launches at different shapes and row counts back to back, each with
    its own plan (ring depth, x tiles, blocks of x rows), read one before
    the next is checked."""
    rng = np.random.default_rng(12)
    cases = [_int4_case(rng, d, f, b, dev)
             for d, f, b in [(3584, 4608, 4), (18944, 3584, 20), (3584, 4608, 4), (768, 256, 1),
                             (3584, 384, 128)]]
    outs = [matvec.quant_matvec_int4(x, wq) for wq, x in cases]
    torch.cuda.synchronize()
    for (wq, x), out in zip(cases, outs):
        assert torch.equal(out, _int4_ref(x, wq))


def _int8_cache(rng, b, kh, c, dh, dev):
    codes = [torch.from_numpy(rng.integers(-127, 128, (b, kh, c, dh)).astype(np.int8)).to(dev)
             for _ in "kv"]
    scales = [torch.from_numpy((rng.random((b, kh, c)) * 0.02 + 0.001).astype(np.float32)).to(dev)
              for _ in "kv"]
    return (*codes, *scales)


@pytest.mark.parametrize("b,c,fresh", [(1, 8192, True), (4, 8192, True), (4, 1000, False),
                                       (2, 300, True)])
def test_flash_decode_int8_fold_matches_plain(dev, b, c, fresh):
    """B5 over an int8 cache, half the columns masked, the fresh column
    folded with lane 1 gated off (and lane 1's cache empty where b > 1):
    per element within the bound, which counts the bf16 rounding of p*vs."""
    rng = np.random.default_rng(11)
    h, kh, dh = 28, 4, 128
    q = _bf16(rng, (b, h, 1, dh), dev)
    k8, v8, ks, vs = _int8_cache(rng, b, kh, c, dh, dev)
    mask = torch.from_numpy((rng.random((b, c)) < 0.8).astype(np.float32)).to(dev)
    mask[:, c // 2:] = 0
    kw = {}
    if fresh:
        gate = torch.ones(b, device=dev)
        if b > 1:
            gate[1] = 0.0
            mask[1] = 0.0
        kw = {"fresh_k": _bf16(rng, (b, kh, 1, dh), dev),
              "fresh_v": _bf16(rng, (b, kh, 1, dh), dev), "fresh_gate": gate}
    before = attention.flash_decode_int8_cuda.launches
    out = attention.flash_attention_cached(q, k8, v8, mask, k_scale=ks, v_scale=vs, **kw)
    assert attention.flash_decode_int8_cuda.launches == before + 1
    ref = attention.flash_plain(q, k8, v8, mask, dh ** -0.5, k_scale=ks, v_scale=vs, **kw)
    bound = attention.attention_error_bound(q, k8, v8, mask, dh ** -0.5, ref, causal=False,
                                            k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    live = torch.ones(b, dtype=torch.bool, device=dev) if fresh else mask.sum(1) > 0
    assert ((out.float() - ref.float()).abs()[live] <= bound[live]).all()


@pytest.mark.parametrize("int8,b,g,c", [(True, 4, 5, 8192), (False, 4, 5, 8192),
                                         (True, 2, 1, 300), (False, 1, 3, 1000)])
def test_flash_decode_ml_matches_plain(dev, int8, b, g, c):
    """B5 with the (m, l) outputs at G query rows per lane (G = 5: 35
    folded rows per KV head at 7B GQA, one block's rows), half the columns
    masked and lane 1's cache empty where b > 1: o per element within the
    bound on lanes with a live column, finite everywhere; m within 1e-5 and
    l within 1e-5 relative there (f32 sums over the splits in another
    order); launches counted once."""
    rng = np.random.default_rng(13)
    h, kh, dh = 28, 4, 128
    q = _bf16(rng, (b, h, g, dh), dev)
    if int8:
        k, v, ks, vs = _int8_cache(rng, b, kh, c, dh, dev)
        kw = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = _bf16(rng, (b, kh, c, dh), dev), _bf16(rng, (b, kh, c, dh), dev)
        kw = {}
    mask = torch.from_numpy((rng.random((b, c)) < 0.8).astype(np.float32)).to(dev)
    mask[:, c // 2:] = 0
    if b > 1:
        mask[1] = 0.0
    before = attention.flash_decode_ml_cuda.launches
    out, m, l = attention.flash_attention_cached(q, k, v, mask, return_ml=True, **kw)
    assert attention.flash_decode_ml_cuda.launches == before + 1
    ref, rm, rl = attention.flash_plain(q, k, v, mask, dh ** -0.5, return_ml=True, **kw)
    bound = attention.attention_error_bound(q, k, v, mask, dh ** -0.5, ref, causal=False, **kw)
    torch.cuda.synchronize()
    live = mask.sum(1) > 0
    assert torch.isfinite(out).all()
    assert ((out.float() - ref.float()).abs()[live] <= bound[live]).all()
    assert torch.allclose(m[live], rm[live], rtol=0, atol=1e-5)
    assert torch.allclose(l[live], rl[live], rtol=1e-5, atol=0)


def test_flash_decode_bf16_fold_matches_plain(dev):
    rng = np.random.default_rng(12)
    b, h, kh, c, dh = 4, 28, 4, 2048, 128
    q = _bf16(rng, (b, h, 1, dh), dev)
    k, v = _bf16(rng, (b, kh, c, dh), dev), _bf16(rng, (b, kh, c, dh), dev)
    mask = torch.zeros((b, c), device=dev)
    mask[:, 7:900] = 1.0
    kw = {"fresh_k": _bf16(rng, (b, kh, 1, dh), dev), "fresh_v": _bf16(rng, (b, kh, 1, dh), dev),
          "fresh_gate": torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)}
    out = attention.flash_attention_cached(q, k, v, mask, **kw)
    ref = attention.flash_plain(q, k, v, mask, dh ** -0.5, **kw)
    bound = attention.attention_error_bound(q, k, v, mask, dh ** -0.5, ref, causal=False, **kw)
    torch.cuda.synchronize()
    assert ((out.float() - ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("b,s,c,col0", [(1, 256, 8192, 2048), (2, 40, 300, 100),
                                        (3, 512, 2048, 700)])
def test_flash_prefill_int8_matches_plain(dev, b, s, c, col0):
    """B6 over an int8 cache: a suffix of ``s`` queries at ``col0`` (with a
    left pad and a dead tail), per element within the bound; the serving
    piece (256 queries, 56 row-tile blocks) splits its key range over 4
    blocks, the 3-lane 512-query suffix fills the card without a split."""
    rng = np.random.default_rng(13)
    h, kh, dh = 28, 4, 128
    q = _bf16(rng, (b, h, s, dh), dev)
    k8, v8, ks, vs = _int8_cache(rng, b, kh, c, dh, dev)
    mask = torch.ones((b, c), device=dev)
    mask[:, :11] = 0
    mask[:, col0 + s:] = 0
    off = torch.full((b,), col0, dtype=torch.int32, device=dev)
    assert attention.prefill_splits(b, kh, h // kh * s, c, True) == {
        256: 4, 40: 2, 512: 1}[s]
    before = attention.flash_prefill_int8_cuda.launches
    out = attention.flash_attention_at(q, k8, v8, mask, off, k_scale=ks, v_scale=vs)
    assert attention.flash_prefill_int8_cuda.launches == before + 1
    ref = attention.flash_plain(q, k8, v8, mask, dh ** -0.5, causal=True, q_offset=off,
                                k_scale=ks, v_scale=vs)
    bound = attention.attention_error_bound(q, k8, v8, mask, dh ** -0.5, ref, causal=True,
                                            q_offset=off, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out.float() - ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("b,s,c,col0", [(2, 48, 1001, 333), (2, 100, 127, 2)])
def test_flash_prefill_int8_dh64(dev, b, s, c, col0):
    """B6 over an int8 cache at dh 64 (8 query heads over 2 KV heads), with
    a cache length that is not a multiple of 4 (its mask and scale rows are
    padded for TMA): split key range (48 queries over a 1001-column cache)
    and unsplit (100 queries over 127 columns, two key tiles), per element
    within the bound."""
    rng = np.random.default_rng(14)
    h, kh, dh = 8, 2, 64
    q = _bf16(rng, (b, h, s, dh), dev)
    k8, v8, ks, vs = _int8_cache(rng, b, kh, c, dh, dev)
    mask = torch.ones((b, c), device=dev)
    mask[:, :5] = 0
    mask[:, col0 + s:] = 0
    off = torch.full((b,), col0, dtype=torch.int32, device=dev)
    assert (attention.prefill_splits(b, kh, h // kh * s, c, True) > 1) == (s == 48)
    before = attention.flash_prefill_int8_cuda.launches
    out = attention.flash_attention_at(q, k8, v8, mask, off, k_scale=ks, v_scale=vs)
    assert attention.flash_prefill_int8_cuda.launches == before + 1
    ref = attention.flash_plain(q, k8, v8, mask, dh ** -0.5, causal=True, q_offset=off,
                                k_scale=ks, v_scale=vs)
    bound = attention.attention_error_bound(q, k8, v8, mask, dh ** -0.5, ref, causal=True,
                                            q_offset=off, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out.float() - ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("b,h,kh,s,dh,pad", [
    (2, 28, 4, 300, 128, 37), (1, 4, 2, 64, 64, 0), (3, 8, 8, 129, 128, 5),
    (1, 8, 2, 1000, 128, 3),     # S not a multiple of the 128-row / 128-key tiles
    (2, 8, 2, 100, 64, 9),       # every 128-row tile spans two folded heads, dh 64
    (1, 28, 4, 2048, 128, 0)])   # 7B-class GQA at 2K
def test_flash_prefill_matches_plain(dev, b, h, kh, s, dh, pad):
    rng = np.random.default_rng(3)
    q, k, v = (_bf16(rng, (b, n, s, dh), dev) for n in (h, kh, kh))
    mask = torch.ones((b, s), device=dev)
    mask[-1, :pad] = 0
    off = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = attention.flash_prefill_cuda(q, k, v, mask, off, dh ** -0.5)
    ref = attention.attention_plain(q, k, v, mask, dh ** -0.5, causal=True)
    # bf16 rounding of P before (kernel) or after (plain) normalizing, then of the output
    bound = attention.attention_error_bound(q, k, v, mask, dh ** -0.5, ref, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    live = mask[:, None, :, None] > 0
    assert ((out.float() - ref.float()).abs() * live <= bound).all()


def test_flash_prefill_query_offset(dev):
    """A suffix of 40 queries at cache column 100 over a 256-key cache."""
    rng = np.random.default_rng(4)
    q = _bf16(rng, (2, 8, 40, 128), dev)
    k, v = _bf16(rng, (2, 2, 256, 128), dev), _bf16(rng, (2, 2, 256, 128), dev)
    mask = torch.ones((2, 256), device=dev)
    off = torch.tensor([100, 3], dtype=torch.int32, device=dev)
    out = attention.flash_prefill_cuda(q, k, v, mask, off, 128 ** -0.5)
    ref = attention.attention_plain(q, k, v, mask, 128 ** -0.5, causal=True,
                                    q_offset=off)
    bound = attention.attention_error_bound(q, k, v, mask, 128 ** -0.5, ref,
                                            causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert ((out.float() - ref.float()).abs() <= bound).all()


def _bwd_case(rng, b, h, kh, s, dh, pad, dev):
    """bf16 q/k/v, a key mask left-padded by ``pad`` in the last row, a
    cotangent that is 0 on pad rows (a masked loss), and B6's output."""
    q, k, v = (_bf16(rng, (b, n, s, dh), dev) for n in (h, kh, kh))
    mask = torch.ones((b, s), device=dev)
    mask[-1, :pad] = 0
    dout = (_bf16(rng, (b, h, s, dh), dev).float() * mask[:, None, :, None]).to(torch.bfloat16)
    off = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = attention.flash_prefill_cuda(q, k, v, mask, off, dh ** -0.5)
    return q, k, v, mask, dout, out


@pytest.mark.parametrize("b,h,kh,s,dh,pad", [
    (1, 28, 4, 1024, 128, 37), (2, 28, 4, 70, 64, 11), (1, 16, 16, 1024, 128, 0),
    (2, 8, 8, 64, 64, 5), (2, 4, 2, 70, 128, 64),
    (1, 28, 4, 2048, 128, 0),    # 7B-class GQA: B10b splits the 7 query heads
    (1, 4, 4, 1000, 64, 3),      # S not a multiple of the tiles, dh 64
    (2, 8, 2, 100, 128, 9)])     # query tiles spanning two folded heads
def test_flash_backward_matches_plain(dev, b, h, kh, s, dh, pad):
    """B10a (dQ, logsumexp) and B10b (dK, dV) against the plain backward,
    per element within ``attention_grad_error_bound`` (bf16 rounding of P
    and dS at other points, then of the outputs); dh 64 and 128, MHA and
    GQA 28/4, S of 64, 70 and 1024. Pad rows (dO = 0) give dQ exactly 0,
    and the logsumexp of every real row equals the plain one within 1e-4
    (f32 sums in another order)."""
    rng = np.random.default_rng(9)
    q, k, v, mask, dout, out = _bwd_case(rng, b, h, kh, s, dh, pad, dev)
    scale = dh ** -0.5
    D = (dout.float() * out.float()).sum(-1)
    before = (attention.flash_dq_cuda.launches, attention.flash_dkv_cuda.launches)
    dq, lse = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
    dk, dv = attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D, scale)
    refs = attention.flash_attention_bwd_plain(q, k, v, mask, out, dout, scale)
    bounds = attention.attention_grad_error_bound(q, k, v, mask, out, dout, scale, refs)
    torch.cuda.synchronize()
    assert (attention.flash_dq_cuda.launches, attention.flash_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for got, ref, bound in zip((dq, dk, dv), refs, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - ref.float()).abs() <= bound).all()
    assert (dq[-1, :, :pad] == 0).all()
    logits = (q.float() @ attention._rep(k, h // kh).transpose(-1, -2)) * scale
    vis = attention._visible(mask, s, s, True, None)
    plain_lse = torch.logsumexp(logits.masked_fill(~vis, -float("inf")), dim=-1)
    real = mask[:, None, :].expand_as(lse) > 0
    assert (lse - plain_lse)[real].abs().max().item() < 1e-4


def test_flash_backward_right_padded_batch(dev):
    """B10a/B10b at a training batch: 8 rows (grid index z up to 7), 16 MHA
    heads, dh 128, each row right-padded to its own length as the LM loader
    pads, a cotangent that is 0 on pad rows; per element within
    ``attention_grad_error_bound``, and pad rows give dQ exactly 0."""
    rng = np.random.default_rng(11)
    b, h, s, dh = 8, 16, 384, 128
    q, k, v = (_bf16(rng, (b, h, s, dh), dev) for _ in "qkv")
    lengths = [384, 1, 200, 383, 64, 65, 129, 300]
    mask = torch.zeros((b, s), device=dev)
    for r, n in enumerate(lengths):
        mask[r, :n] = 1
    dout = (_bf16(rng, (b, h, s, dh), dev).float() * mask[:, None, :, None]).to(torch.bfloat16)
    scale = dh ** -0.5
    out = attention.flash_prefill_cuda(q, k, v, mask, torch.zeros((b,), dtype=torch.int32,
                                                                  device=dev), scale)
    D = (dout.float() * out.float()).sum(-1)
    dq, lse = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
    dk, dv = attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D, scale)
    refs = attention.flash_attention_bwd_plain(q, k, v, mask, out, dout, scale)
    bounds = attention.attention_grad_error_bound(q, k, v, mask, out, dout, scale, refs)
    torch.cuda.synchronize()
    for got, ref, bound in zip((dq, dk, dv), refs, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - ref.float()).abs() <= bound).all()
    for r, n in enumerate(lengths):
        assert (dq[r, :, n:] == 0).all()
        assert (dk[r, :, n:] == 0).all() and (dv[r, :, n:] == 0).all()


def test_flash_attention_training_shape(dev):
    """B6, B10a and B10b at the 1B-class training step's own shape: B=8,
    S=768, 16 MHA heads, dh 128, each row right-padded as the LM loader pads
    and a cotangent that is 0 on pad rows; each output per element within
    its bound, each launch counter moves by one."""
    rng = np.random.default_rng(12)
    b, h, s, dh = 8, 16, 768, 128
    q, k, v = (_bf16(rng, (b, h, s, dh), dev) for _ in "qkv")
    mask = torch.zeros((b, s), device=dev)
    for r, n in enumerate([768, 700, 1, 513, 64, 129, 767, 300]):
        mask[r, :n] = 1
    dout = (_bf16(rng, (b, h, s, dh), dev).float() * mask[:, None, :, None]).to(torch.bfloat16)
    scale = dh ** -0.5
    fns = (attention.flash_prefill_cuda, attention.flash_dq_cuda, attention.flash_dkv_cuda)
    before = [f.launches for f in fns]
    out = attention.flash_prefill_cuda(q, k, v, mask, torch.zeros((b,), dtype=torch.int32,
                                                                  device=dev), scale)
    ref = attention.attention_plain(q, k, v, mask, scale, causal=True)
    bound = attention.attention_error_bound(q, k, v, mask, scale, ref, causal=True)
    D = (dout.float() * out.float()).sum(-1)
    dq, lse = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
    dk, dv = attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D, scale)
    refs = attention.flash_attention_bwd_plain(q, k, v, mask, out, dout, scale)
    bounds = attention.attention_grad_error_bound(q, k, v, mask, out, dout, scale, refs)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1]
    assert ((out.float() - ref.float()).abs() <= bound).all()
    for got, want, bd in zip((dq, dk, dv), refs, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - want.float()).abs() <= bd).all()


def test_flash_attention_autograd_matches_plain_forward(dev):
    """``flash_attention`` under autograd (B6 forward, B10a/B10b backward)
    against autograd of the plain forward run in f32 on the same bf16
    inputs: each gradient within 2% relative L2 (bf16 has 8 significant
    bits; the kernels round P, dS and their outputs to it)."""
    rng = np.random.default_rng(10)
    q, k, v, mask, dout, _ = _bwd_case(rng, 2, 28, 4, 300, 128, 21, dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (attention.flash_attention(*leaves, mask).float() * dout.float()).sum().backward()
    ref = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
    (attention.attention_plain(*ref, mask, 128 ** -0.5, causal=True)
     * dout.float()).sum().backward()
    for got, want in zip(leaves, ref):
        rel = ((got.grad.float() - want.grad).norm() / want.grad.norm()).item()
        assert rel < 2e-2, rel
    with pytest.raises(ValueError, match="dh 64 or 128"):
        x = _bf16(rng, (1, 2, 16, 32), dev)
        attention.flash_dq_cuda(x, x, x, mask[:1, :16], x, torch.zeros((1, 2, 16), device=dev),
                                1.0)


@pytest.mark.parametrize("b,h,kh,s,c,dh", [
    (1, 28, 4, 1, 8192, 128), (8, 28, 4, 1, 1000, 128), (2, 8, 2, 5, 300, 64)])
def test_flash_decode_matches_plain(dev, b, h, kh, s, c, dh):
    """Half the columns masked: left pad, unwritten tail and random holes."""
    rng = np.random.default_rng(5)
    q = _bf16(rng, (b, h, s, dh), dev)
    k, v = _bf16(rng, (b, kh, c, dh), dev), _bf16(rng, (b, kh, c, dh), dev)
    mask = torch.from_numpy((rng.random((b, c)) < 0.8).astype(np.float32)).to(dev)
    mask[:, :3] = 0
    mask[:, c // 2:] = 0
    out = attention.flash_decode_cuda(q, k, v, mask, dh ** -0.5)
    ref = attention.attention_plain(q, k, v, mask, dh ** -0.5, causal=False)
    # bf16 rounding of P before (kernel) or after (plain) normalizing, then of the output
    bound = attention.attention_error_bound(q, k, v, mask, dh ** -0.5, ref, causal=False)
    torch.cuda.synchronize()
    assert ((out.float() - ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("b,h,kh,s,dh,pad", [
    (2, 4, 4, 1, 64, 0),         # S = 1: one row per head, one key
    (2, 4, 2, 129, 64, 7),       # ragged S: TMA rows padded, a 1-row last tile per head
    (1, 4, 4, 4096, 64, 100),    # long rows, left pad
    (1, 28, 4, 200, 64, 13)])    # 7B GQA fold: row tiles straddle two heads
def test_flash_dq_redesign_edges(dev, b, h, kh, s, dh, pad):
    """B10a (wgmma from a TMA ring) at the shapes its design could get wrong,
    with B10b beside it: per element within ``attention_grad_error_bound``,
    finite, pad rows' dQ exactly 0, the same bits on a second run (each
    block owns its rows' dQ: no atomics)."""
    rng = np.random.default_rng(14)
    q, k, v, mask, dout, out = _bwd_case(rng, b, h, kh, s, dh, pad, dev)
    scale = dh ** -0.5
    D = (dout.float() * out.float()).sum(-1)
    dq, lse = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
    dk, dv = attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D, scale)
    dq2, lse2 = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
    refs = attention.flash_attention_bwd_plain(q, k, v, mask, out, dout, scale)
    bounds = attention.attention_grad_error_bound(q, k, v, mask, out, dout, scale, refs)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(lse, lse2)
    for got, ref, bound in zip((dq, dk, dv), refs, bounds):
        assert torch.isfinite(got).all()
        assert ((got.float() - ref.float()).abs() <= bound).all()
    assert (dq[-1, :, :pad] == 0).all()
    assert torch.isfinite(lse).all()


def _decode_inputs(rng, b, h, kh, s, c, dh, int8, dev):
    q = _bf16(rng, (b, h, s, dh), dev)
    if int8:
        k, v, ks, vs = _int8_cache(rng, b, kh, c, dh, dev)
        return q, k, v, {"k_scale": ks, "v_scale": vs}
    return q, _bf16(rng, (b, kh, c, dh), dev), _bf16(rng, (b, kh, c, dh), dev), {}


def _hold_decode(q, k, v, mask, sc, kw, live):
    """B5 through ``flash_attention_cached`` twice against ``flash_plain``:
    finite everywhere, the same bits both times, within the bound on lanes
    ``live``; returns the output."""
    dh = q.shape[-1]
    out = attention.flash_attention_cached(q, k, v, mask, **sc, **kw)
    again = attention.flash_attention_cached(q, k, v, mask, **sc, **kw)
    ref = attention.flash_plain(q, k, v, mask, dh ** -0.5, **sc, **kw)
    bound = attention.attention_error_bound(q, k, v, mask, dh ** -0.5, ref, causal=False,
                                            **sc, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    assert ((out.float() - ref.float()).abs()[live] <= bound[live]).all()
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", ["last_split_last_tile", "cache_last_column",
                                  "one_per_split", "masked_lane", "masked_lane_fold",
                                  "masked_lane_gated_off"])
def test_flash_decode_live_tile_edges(dev, case, int8):
    """B5's dead-tile skipping and split merge at their edges (7B GQA,
    28q/4kv, dh 128): one live column in the last tile of the last split,
    or in the cache's last (partial) tile; one live column per split; a
    lane with no live column, alone (o exactly 0) or with the fresh fold
    (the fresh term alone, or 0 when gated off). Per element within the
    bound on lanes with a live column or the fold, finite everywhere, the
    same bits on a second call."""
    rng = np.random.default_rng(15)
    b, h, kh, dh = 2, 28, 4, 128
    c = 1000 if case == "cache_last_column" else 8192
    q, k, v, sc = _decode_inputs(rng, b, h, kh, 1, c, dh, int8, dev)
    plan = attention.decode_plan(b, kh, c, h // kh)
    mask = torch.zeros((b, c), device=dev)
    if case == "last_split_last_tile":
        t = plan.split_tiles(plan.nsplit - 1)[-1]
        mask[:, min(c, 64 * t + 64) - 1] = 1.0
    elif case == "cache_last_column":
        mask[:, c - 1] = 1.0
    elif case == "one_per_split":
        for s_ in range(plan.nsplit):
            mask[:, 64 * s_ + s_ % 64] = 1.0
    else:
        mask[0, 3:4000] = 1.0                   # lane 1 has no live column
    kw = {}
    if case.startswith("masked_lane_"):
        gate = torch.tensor([1.0, 0.0 if case.endswith("gated_off") else 1.0], device=dev)
        kw = {"fresh_k": _bf16(rng, (b, kh, 1, dh), dev),
              "fresh_v": _bf16(rng, (b, kh, 1, dh), dev), "fresh_gate": gate}
    live = mask.sum(1) > 0
    if kw:
        live = torch.ones_like(live)
    out = _hold_decode(q, k, v, mask, sc, kw, live)
    if case == "masked_lane":
        assert (out[1] == 0).all()
    if case == "masked_lane_gated_off":
        assert (out[1] == 0).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", [1, 5, 8, 9])
def test_flash_decode_ml_verify_rows(dev, G, int8):
    """B5 with (m, l) at G verify rows per lane (7G folded rows per KV head
    at 7B GQA, up to 63: one block's rows), half the columns live and lane
    1 with none: on lane 0 o within the bound, m within 1e-5, l within 1e-5
    relative; lane 1 gives exactly (0, -1e30, 0); finite, the same bits on
    a second call."""
    rng = np.random.default_rng(16 + G)
    b, h, kh, c, dh = 2, 28, 4, 2048, 128
    q, k, v, sc = _decode_inputs(rng, b, h, kh, G, c, dh, int8, dev)
    mask = torch.zeros((b, c), device=dev)
    mask[0, 21:1100] = 1.0
    o, m, l = attention.flash_attention_cached(q, k, v, mask, return_ml=True, **sc)
    o2, m2, l2 = attention.flash_attention_cached(q, k, v, mask, return_ml=True, **sc)
    ro, rm, rl = attention.flash_plain(q, k, v, mask, dh ** -0.5, return_ml=True, **sc)
    bound = attention.attention_error_bound(q, k, v, mask, dh ** -0.5, ro, causal=False, **sc)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all()
    assert torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)
    assert ((o[0].float() - ro[0].float()).abs() <= bound[0]).all()
    assert torch.allclose(m[0], rm[0], rtol=0, atol=1e-5)
    assert torch.allclose(l[0], rl[0], rtol=1e-5, atol=0)
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()


@pytest.mark.parametrize("name", [
    "matvec.quantize_rows_absmax", "matvec.quantize_weight", "matvec.quantize_weight_int4",
    "quant.quantize_rows", "quant.quantize_rows_int4", "quant.int4_codes",
    "decoder._kv_quantize"])
def test_row_scales_bit_equal_on_cpu_and_card(dev, name):
    """Each quantizer's scales and codes on the card equal the CPU's bit for
    bit over 10^5 rows of 64 values at every scale, floors included (the
    divisor is a 0-dim f32 tensor on the input's device, so both take IEEE
    division). quantize_weight_int4's / 7 and codes are held on the card's
    own equalized rows wn = w / t, whose t goes through log and exp."""
    from test_torch_row_scales import QUANTIZERS, scale_rows
    fn = QUANTIZERS[name][0]
    x = torch.from_numpy(scale_rows(width=64))
    gc, gs, gof = fn(x.to(dev))
    torch.cuda.synchronize()
    cc, cs, _ = fn(x) if name != "matvec.quantize_weight_int4" else _wn_quantized(gof.cpu())
    assert torch.equal(gs.cpu().view(torch.int32), cs.view(torch.int32))
    assert torch.equal(gc.cpu(), cc)


def _wn_quantized(wn):
    """quantize_weight_int4's / 7 step and codes of given equalized rows, on the CPU."""
    s = quant.absmax_scale(wn, 7)
    return torch.clamp(torch.round(wn / s[:, None]), -7, 7).to(torch.int32), s, wn


def _quant_corpus(rng, dtype, n, n_pad, d, dev, dup=1):
    """A corpus of ``n`` rows quantized as the index stores it, padded to
    ``n_pad`` logical rows; ``dup`` > 1 repeats ``n / dup`` base rows."""
    x = rng.standard_normal((n // dup, d)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x] * dup))
    if dtype == "int8":
        c, s = quant.quantize_rows(x)
        pad = n_pad - n
        return (torch.nn.functional.pad(c, (0, 0, 0, pad)).to(dev),
                torch.nn.functional.pad(s, (0, pad)).to(dev))
    c, s = quant.quantize_rows_int4(x)
    pad = n_pad // 2 - c.shape[0]
    return (torch.nn.functional.pad(c, (0, 0, 0, pad)).to(dev),
            torch.nn.functional.pad(s, (0, pad)).to(dev))


def _quant_scan(dtype, q, c, s, k, n_valid, cuda):
    q8, _ = quant.quantize_rows(q)
    if dtype == "int8":
        fn = quant.int8_topk_cuda if cuda else quant.int8_flat_search_plain
        return fn(q8, c, s, k, n_valid)
    corr = (8 * q8.to(torch.int32).sum(dim=1)).float()
    fn = quant.int4_topk_cuda if cuda else quant.int4_flat_search_plain
    return fn(q8, corr, c, s, k, n_valid)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("n,n_pad,b,k,d,dup", [
    (3001, 4096, 5, 10, 64, 1),        # odd N, n_valid < N_pad
    (7, 2048, 3, 10, 3072, 1),         # short results: (-inf, id 0)
    (65536, 65536, 64, 128, 768, 1),   # k at the cap
    (16383, 16384, 64, 40, 768, 1),    # the rerank depth at k = 10
    (4096, 4096, 1, 1, 96, 1),         # k = 1, B = 1
    (2048, 2048, 4, 10, 128, 32),      # duplicated rows: ties at the boundary
    (3001, 4096, 17, 10, 64, 1),       # a partly filled 32-query block
    (20000, 20480, 63, 10, 768, 1),    # a partly filled 64-query block
    (40000, 65536, 65, 10, 768, 1),    # 128 queries a block; n ends inside a block's range
    (8192, 8192, 128, 40, 768, 1),     # 128 queries streamed in the ring (int4: two groups)
    (5000, 8192, 64, 10, 3072, 1),     # D = 3072: 64 queries streamed in the ring
    (4000, 4096, 130, 10, 64, 1),      # two groups of 128 queries, the second nearly empty
])
def test_quant_topk_matches_plain(dev, dtype, n, n_pad, b, k, d, dup):
    """B2/B3 against their plain versions: the integer sums are exact and
    every f32 operation is the same, so scores are bit-equal; ids are equal
    too, ties included (both order by score desc, row asc)."""
    rng = np.random.default_rng(6)
    c, s = _quant_corpus(rng, dtype, n, n_pad, d, dev, dup)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    ks, ki = _quant_scan(dtype, q, c, s, k, n, cuda=True)
    ps, pi = _quant_scan(dtype, q, c, s, k, n, cuda=False)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(ki, pi)
    if n < k:
        assert torch.isinf(ks[:, n:]).all() and (ki[:, n:] == 0).all()


def test_quant_flat_search_launches(dev):
    """The public int8/int4 searches launch the kernels on CUDA tensors."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)).to(dev)
    before = (quant.int8_topk_cuda.launches, quant.int4_topk_cuda.launches)
    c8, s8 = _quant_corpus(rng, "int8", 2000, 2048, 64, dev)
    c4, s4 = _quant_corpus(rng, "int4", 2001, 4096, 64, dev)
    quant.int8_flat_search(q, c8, s8, 5, n_valid=2000)
    quant.int4_flat_search(q, c4, s4, 5, n_valid=2001)
    assert (quant.int8_topk_cuda.launches, quant.int4_topk_cuda.launches) == (
        before[0] + 1, before[1] + 1)


def _ivf_case(rng, dtype, nlist, cap, d, live, dev):
    """Unit rows in ``nlist`` buckets of ``cap`` slots stored as the IVF
    index stores them (int4: split-half packed, ``nlist * cap/2`` rows); a
    share ``1 - live`` of the slots holds -1 (empty or deleted), the others
    distinct doc ids in no order."""
    rows = rng.standard_normal((nlist * cap, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    ids = rng.permutation(10 * nlist * cap)[: nlist * cap].astype(np.int32)
    ids[rng.random(nlist * cap) >= live] = -1
    bids = torch.from_numpy(ids.reshape(nlist, cap)).to(dev)
    if dtype == "int8":
        c8, s8 = quant.quantize_rows(torch.from_numpy(rows))
        return c8.to(dev), bids, s8.reshape(nlist, cap).to(dev)
    if dtype == "int4":
        codes, s4 = quant.int4_codes(torch.from_numpy(rows))
        return (quant.ivf_pack_slots_int4(codes, nlist, cap).to(dev), bids,
                s4.reshape(nlist, cap).to(dev))
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    return torch.from_numpy(rows).to(dev, dt), bids, None


def _ivf_scan(layout, pid, q, buckets, bids, scales, k, cuda):
    """One of the six kernels (``cuda``) or its plain version on the same
    inputs; int8/int4 scores carry no query scale. int4 buckets are told
    apart by their ``nlist * cap/2`` rows."""
    nlist, cap = bids.shape
    if buckets.shape[0] == nlist * cap // 2:
        q8, corr, _ = ivf_kernel.int4_query(q)
        if layout == "batch":
            uniq = ivf_kernel.unique_probes(pid, nlist)
            fn = (ivf_kernel.ivf_batch_topk_int4_cuda if cuda
                  else ivf_kernel.ivf_batch_search_int4_plain)
            return fn(pid, uniq, q8, corr, buckets, bids, scales, k)
        fn = (ivf_kernel.ivf_probe_topk_int4_cuda if cuda
              else ivf_kernel.ivf_probe_search_int4_plain)
        return fn(pid, q8, corr, buckets, bids, scales, k)
    q = quant.quantize_rows(q)[0] if scales is not None else q.to(buckets.dtype)
    f32 = buckets.dtype == torch.float32
    if layout == "batch":
        uniq = ivf_kernel.unique_probes(pid, nlist)
        if cuda:
            fn = (ivf_kernel.ivf_batch_topk_int8_cuda if scales is not None
                  else ivf_kernel.ivf_batch_topk_f32_cuda if f32
                  else ivf_kernel.ivf_batch_topk_cuda)
            return fn(pid, uniq, q, buckets, bids, *([scales] if scales is not None else []), k)
        return ivf_kernel.ivf_batch_search_plain(pid, uniq, q, buckets, bids, scales, k)
    if scales is not None:
        fn = (ivf_kernel.ivf_probe_topk_int8_cuda if cuda
              else ivf_kernel.ivf_probe_search_int8_plain)
        return fn(pid, q, buckets, bids, scales, k)
    fn = ((ivf_kernel.ivf_probe_topk_f32_cuda if f32 else ivf_kernel.ivf_probe_topk_cuda)
          if cuda else ivf_kernel.ivf_probe_search_plain)
    return fn(pid, q, buckets, bids, k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
@pytest.mark.parametrize("b,k,nlist,cap,nprobe,d,live", [
    (1, 10, 16, 2048, 8, 768, 0.8),     # the serving cap, B = 1
    (7, 1, 32, 96, 32, 64, 0.8),        # nprobe = nlist (exact), k = 1
    (64, 128, 64, 32, 8, 128, 0.8),     # k at the cap, the smallest cap
    (64, 10, 256, 96, 32, 768, 0.7),    # probes shared across the batch
    (7, 128, 8, 32, 4, 64, 0.1),        # fewer live rows than k: (-inf, id 0)
    (1, 40, 64, 2048, 32, 256, 0.8),    # B = 1, k = 40: 1,024 lists into the k-way merge
    (1, 20, 1024, 32, 1024, 64, 0.8),   # nprobe = nlist = 1,024: four lists per merge thread
])
def test_ivf_kernels_match_plain(dev, dtype, b, k, nlist, cap, nprobe, d, live):
    """B8a/B8b/B8c/B9a/B9b/B9c against their plain versions. int8 and
    int4: exact integer sums and the same f32 operations, so scores and ids
    are bit-equal, and the two layouts bit-identical (int4 with cap 32 and
    96: 16 and 48 packed rows, partial warps and sub-tiles). bf16: f32 sums
    in another order, scores within B1's 1e-3 on unit rows, ids equal but
    for near ties. f32 (B8a/B9a over f32 buckets, fmaf on the CUDA cores):
    the same with B1 f32's 5e-5 (the f32 sum bound D 2^-24 at D = 768)."""
    rng = np.random.default_rng(8)
    buckets, bids, scales = _ivf_case(rng, dtype, nlist, cap, d, live, dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q /= q.norm(dim=1, keepdim=True)
    pid = torch.from_numpy(np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)])
                           .astype(np.int32)).to(dev)
    outs = {}
    for layout in ("probe", "batch"):
        ks, ki = _ivf_scan(layout, pid, q, buckets, bids, scales, k, cuda=True)
        ps, pi = _ivf_scan(layout, pid, q, buckets, bids, scales, k, cuda=False)
        torch.cuda.synchronize()
        outs[layout] = (ks, ki)
        assert torch.equal(torch.isinf(ks), torch.isinf(ps))
        assert (ki[torch.isinf(ks)] == 0).all()
        if dtype in ("int8", "int4"):
            assert torch.equal(ks, ps) and torch.equal(ki, pi), layout
        else:
            tol = 5e-5 if dtype == "float32" else 1e-3
            assert torch.allclose(ks, ps, rtol=0, atol=tol), layout
            assert (ki == pi).float().mean().item() >= 0.99, layout
        finite = ki[torch.isfinite(ks)]
        assert (finite >= 0).all() and bool(torch.isin(finite, bids[bids >= 0]).all())
    if dtype in ("int8", "int4"):
        assert torch.equal(outs["probe"][0], outs["batch"][0])
        assert torch.equal(outs["probe"][1], outs["batch"][1])
    if live < 0.5:
        assert torch.isinf(outs["probe"][0][:, -1]).all()


def _packed_bucket_ids(rng, nlist, cap):
    """Bucket ids as an index holds them: each bucket's docs packed at its
    front to its own count (bucket 0 empty, bucket 1 full, bucket 2 one past
    a 128-slot tile, the rest ragged), holes from deletes inside the
    extents, distinct doc ids in no order. At cap 96 every bucket's last
    tile reaches into the next bucket's live rows."""
    counts = rng.integers(1, cap + 1, nlist)
    counts[:3] = 0, cap, min(cap, 129)
    ids = np.full((nlist, cap), -1, dtype=np.int32)
    docs = rng.permutation(10 * nlist * cap).astype(np.int32)
    for u, c in enumerate(counts):
        ids[u, :c] = docs[u * cap:u * cap + c]
    holes = rng.random((nlist, cap)) < 0.15
    ids[holes & (np.arange(cap)[None, :] < counts[:, None] - 1)] = -1
    return ids


def _agree_but_near_ties(ks, ki, ps, pi, tol):
    """Scores within ``tol``; an id that only one side returns scores
    within ``tol`` of the other side's k-th."""
    assert torch.equal(torch.isinf(ks), torch.isinf(ps))
    assert torch.allclose(ks, ps, rtol=0, atol=tol)
    for a_s, a_i, b_s, b_i in zip(ks.tolist(), ki.tolist(), ps.tolist(), pi.tolist()):
        for s, i, other_i, other_kth in ((a_s, a_i, b_i, b_s[-1]), (b_s, b_i, a_i, a_s[-1])):
            for sj, ij in zip(s, i):
                if sj != float("-inf") and ij not in other_i:
                    assert abs(sj - other_kth) <= tol, (sj, other_kth)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cap", [96, 2048])
@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("k", [1, 10, 40, 128])
def test_ivf_float_scans_on_packed_buckets(dev, dtype, cap, b, k):
    """B8a and B9a (bf16, f32) over buckets laid out as an index lays them
    out (packed fronts, empty/full/ragged buckets, holes, a last tile that
    reaches into the next bucket's live rows, probes shared across the
    batch so that B = 256 splits a bucket's probers into chunks): both
    layouts against their plain versions, and against each other: bf16
    within B1's 1e-3 and f32 within 5e-5 (D 2^-24 at D = 768) on unit
    rows, ids equal but for near ties; short results (-inf, 0). The
    wrappers compute the extent themselves here."""
    rng = np.random.default_rng(15)
    nlist, d, nprobe = 24, 64, 8
    ids = _packed_bucket_ids(rng, nlist, cap)
    rows = rng.standard_normal((nlist * cap, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    buckets = torch.from_numpy(rows).to(dev, dt)
    bids = torch.from_numpy(ids).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q = (q / q.norm(dim=1, keepdim=True)).to(dt)
    hot = rng.permutation(nlist)[:12]
    pid = torch.from_numpy(np.stack([rng.permutation(hot)[:nprobe] for _ in range(b)])
                           .astype(np.int32)).to(dev)
    tol = 5e-5 if dtype == "float32" else 1e-3
    f32 = dtype == "float32"
    uniq = ivf_kernel.unique_probes(pid, nlist)
    probe = ivf_kernel.ivf_probe_topk_f32_cuda if f32 else ivf_kernel.ivf_probe_topk_cuda
    batch = ivf_kernel.ivf_batch_topk_f32_cuda if f32 else ivf_kernel.ivf_batch_topk_cuda
    out = {"probe": probe(pid, q, buckets, bids, k),
           "batch": batch(pid, uniq, q, buckets, bids, k)}
    plain = {"probe": ivf_kernel.ivf_probe_search_plain(pid, q, buckets, bids, k),
             "batch": ivf_kernel.ivf_batch_search_plain(pid, uniq, q, buckets, bids, None, k)}
    torch.cuda.synchronize()
    for layout in ("probe", "batch"):
        (ks, ki), (ps, pi) = out[layout], plain[layout]
        _agree_but_near_ties(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), tol)
        assert (ki[torch.isinf(ks)] == 0).all()
        finite = ki[torch.isfinite(ks)]
        assert bool(torch.isin(finite, bids[bids >= 0]).all())
    _agree_but_near_ties(*(t.cpu() for t in out["probe"]), *(t.cpu() for t in out["batch"]),
                         tol)


def _int_buckets(rng, dtype, ids, d, dev):
    """Unit rows in the slots of ``ids`` [nlist, cap] stored as the IVF index
    stores them: int8 rows, or int4 split-half packed (``nlist * cap/2``
    rows); the slot scales ``[nlist, cap]``."""
    nlist, cap = ids.shape
    rows = rng.standard_normal((nlist * cap, d)).astype(np.float32)
    rows = torch.from_numpy(rows / np.linalg.norm(rows, axis=1, keepdims=True))
    if dtype == "int8":
        codes, scales = quant.quantize_rows(rows)
    else:
        codes, scales = quant.int4_codes(rows)
        codes = quant.ivf_pack_slots_int4(codes, nlist, cap)
    return codes.to(dev), scales.reshape(nlist, cap).to(dev)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("cap", [96, 2048])
@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("k", [1, 10, 40, 128])
def test_ivf_int_scans_on_packed_buckets(dev, dtype, cap, b, k):
    """B8b/B9b and B8c/B9c (the Hopper IVF scan over int8 and split-half
    packed int4 buckets, query-major and bucket-major) over buckets laid out
    as an index lays them out (packed fronts, empty/full/ragged buckets,
    holes, a last tile that reaches into the next bucket's rows; int4 at cap
    96: 48 packed rows a bucket, extents above and below them; at B = 256
    the 12 hot buckets' probers span several chunks): each layout bit-equal
    to its plain version (exact integer sums, the same f32 operations) and
    the two layouts bit-identical; short results (-inf, 0). The wrappers
    compute the extent themselves here."""
    rng = np.random.default_rng(15)
    nlist, d, nprobe = 24, 64, 8
    ids = _packed_bucket_ids(rng, nlist, cap)
    buckets, scales = _int_buckets(rng, dtype, ids, d, dev)
    bids = torch.from_numpy(ids).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q /= q.norm(dim=1, keepdim=True)
    hot = rng.permutation(nlist)[:12]
    pid = torch.from_numpy(np.stack([rng.permutation(hot)[:nprobe] for _ in range(b)])
                           .astype(np.int32)).to(dev)
    out = {layout: _ivf_scan(layout, pid, q, buckets, bids, scales, k, cuda=True)
           for layout in ("probe", "batch")}
    plain = {layout: _ivf_scan(layout, pid, q, buckets, bids, scales, k, cuda=False)
             for layout in ("probe", "batch")}
    torch.cuda.synchronize()
    for layout in ("probe", "batch"):
        assert torch.equal(out[layout][0], plain[layout][0]), layout
        assert torch.equal(out[layout][1], plain[layout][1]), layout
    ks, ki = out["probe"]
    assert torch.equal(ks, out["batch"][0]) and torch.equal(ki, out["batch"][1])
    assert (ki[torch.isinf(ks)] == 0).all()
    finite = ki[torch.isfinite(ks)]
    assert bool(torch.isin(finite, bids[bids >= 0]).all())


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("b,k", [(1, 10), (7, 40), (64, 128)])
def test_ivf_int_scans_d80_and_given_extent(dev, dtype, b, k):
    """B8b/B9b and B8c/B9c at D = 80 (rows of a multiple of 16 bytes, not of
    32: TMA reads the last 128-byte panel past D as zeros, which add 0 to
    the integer sums) bit-equal to their plain versions in both layouts; the
    same results whether the wrapper is handed the index's extent or
    computes it, and through the public ``ivf_probe_search_int8``/``_int4``
    and ``ivf_batch_search`` (query scale included) bit-equal to the plain
    path on the CPU."""
    rng = np.random.default_rng(17)
    nlist, cap, d, nprobe = 16, 96, 80, 6
    ids = _packed_bucket_ids(rng, nlist, cap)
    buckets, scales = _int_buckets(rng, dtype, ids, d, dev)
    bids = torch.from_numpy(ids).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q /= q.norm(dim=1, keepdim=True)
    pid = torch.from_numpy(np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)])
                           .astype(np.int32)).to(dev)
    extent = ivf_kernel.ivf_extent(bids)
    q8, corr, _ = ivf_kernel.int4_query(q)
    uniq = ivf_kernel.unique_probes(pid, nlist)
    if dtype == "int8":
        kerns = {
            "probe": lambda **kw: ivf_kernel.ivf_probe_topk_int8_cuda(pid, q8, buckets, bids,
                                                                      scales, k, **kw),
            "batch": lambda **kw: ivf_kernel.ivf_batch_topk_int8_cuda(pid, uniq, q8, buckets,
                                                                      bids, scales, k, **kw)}
        plain = {"probe": ivf_kernel.ivf_probe_search_int8_plain(pid, q8, buckets, bids,
                                                                 scales, k),
                 "batch": ivf_kernel.ivf_batch_search_plain(pid, uniq, q8, buckets, bids,
                                                            scales, k)}
        search = {"probe": ivf_kernel.ivf_probe_search_int8}
    else:
        kerns = {
            "probe": lambda **kw: ivf_kernel.ivf_probe_topk_int4_cuda(pid, q8, corr, buckets,
                                                                      bids, scales, k, **kw),
            "batch": lambda **kw: ivf_kernel.ivf_batch_topk_int4_cuda(
                pid, uniq, q8, corr, buckets, bids, scales, k, **kw)}
        plain = {"probe": ivf_kernel.ivf_probe_search_int4_plain(pid, q8, corr, buckets, bids,
                                                                 scales, k),
                 "batch": ivf_kernel.ivf_batch_search_int4_plain(pid, uniq, q8, corr, buckets,
                                                                 bids, scales, k)}
        search = {"probe": ivf_kernel.ivf_probe_search_int4}
    search["batch"] = lambda *a, **kw: ivf_kernel.ivf_batch_search(
        *a[:4], bucket_scales=a[4], quant=dtype, **kw)
    for layout, kern in kerns.items():
        computed, given = kern(), kern(extent=extent)
        pub = search[layout](pid, q, buckets, bids, scales, k=k, extent=extent)
        cpu = search[layout](pid.cpu(), q.cpu(), buckets.cpu(), bids.cpu(), scales.cpu(), k=k)
        torch.cuda.synchronize()
        for (ks, ki), (ps, pi) in ((computed, plain[layout]), (given, plain[layout]),
                                   (pub, cpu)):
            assert torch.equal(ks.cpu(), ps.cpu()), layout
            assert torch.equal(ki.cpu(), pi.cpu()), layout
        with pytest.raises(ValueError):
            kern(extent=extent.long())


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("b,k", [(256, 10), (200, 40), (256, 128)])
def test_ivf_int_batch_scans_past_one_chunk(dev, dtype, b, k):
    """B9b and B9c where one bucket has more probers than a chunk holds
    (nlist 8, nprobe 6: every bucket probed by about 3B/4 queries, so int8's
    128-prober and int4's 64-prober chunks split each bucket's run, and
    every chunk past a bucket's first reads queries and int4 corr far from
    its start), D = 80: bit-equal to the plain bucket-major version and to
    B8b/B8c."""
    rng = np.random.default_rng(18)
    nlist, cap, d, nprobe = 8, 96, 80, 6
    ids = _packed_bucket_ids(rng, nlist, cap)
    buckets, scales = _int_buckets(rng, dtype, ids, d, dev)
    bids = torch.from_numpy(ids).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q /= q.norm(dim=1, keepdim=True)
    pid = torch.from_numpy(np.stack([rng.permutation(nlist)[:nprobe] for _ in range(b)])
                           .astype(np.int32)).to(dev)
    plan = ivf_kernel.ivf_scan_plan(dtype, b, nprobe, d, cap, k, True, nlist)
    runs = torch.bincount(pid.reshape(-1).long().cpu(), minlength=nlist)
    assert plan.qb <= ivf_kernel._QB_MAX[dtype] and int(runs.min()) > plan.qb
    out = {layout: _ivf_scan(layout, pid, q, buckets, bids, scales, k, cuda=True)
           for layout in ("probe", "batch")}
    ps, pi = _ivf_scan("batch", pid, q, buckets, bids, scales, k, cuda=False)
    torch.cuda.synchronize()
    for layout in ("batch", "probe"):
        assert torch.equal(out[layout][0], ps) and torch.equal(out[layout][1], pi), layout


@pytest.mark.parametrize("n_pos,qb", [(1, 16), (32, 16), (2048, 64), (5000, 128), (8192, 1)])
def test_ivf_chunk_plan_on_card_equals_plain(dev, n_pos, qb):
    """The bucket-major chunk plan on the card (one block, 1,024 positions
    at a time with carries) gives the plain version's chunk starts and
    count."""
    rng = np.random.default_rng(16)
    sb = torch.from_numpy(np.sort(rng.integers(0, 40, n_pos)).astype(np.int32))
    e0, n = ivf_kernel.ivf_chunks_cuda(sb.to(dev), qb)
    pe0, pn = ivf_kernel.ivf_chunks_plain(sb, qb)
    assert int(n) == pn and torch.equal(e0.cpu()[:pn], pe0[:pn])


def test_ivf_index_on_card(dev, tmp_path):
    """IVFIndex on the card: one seed builds one index; the public searches
    launch the kernels; int8 layouts are bit-identical and give the same
    index loaded on the CPU (plain versions)."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((32, 128))
    x = (centers[rng.integers(0, 32, 8000)] + 0.3 * rng.standard_normal((8000, 128)))
    x = x.astype(np.float32)
    q = x[:40] + 0.05 * rng.standard_normal((40, 128)).astype(np.float32)
    for dtype in ("bfloat16", "int8"):
        cfg = EngineConfig(dim=128, dtype=dtype, ivf_nlist=64, ivf_kmeans_iters=4)
        a, b2 = IVFIndex.build(x, cfg), IVFIndex.build(x, cfg)
        assert a.buckets.is_cuda
        assert torch.equal(a.centroids, b2.centroids) and torch.equal(a.bucket_ids, b2.bucket_ids)
        before = (ivf_kernel.ivf_probe_topk_cuda.launches + ivf_kernel.ivf_probe_topk_int8_cuda.launches,
                  ivf_kernel.ivf_batch_topk_cuda.launches + ivf_kernel.ivf_batch_topk_int8_cuda.launches)
        s1, i1 = a.search(q, k=10, nprobe=8, batched=False)
        s2, i2 = a.search(q, k=10, nprobe=8, batched=True)
        after = (ivf_kernel.ivf_probe_topk_cuda.launches + ivf_kernel.ivf_probe_topk_int8_cuda.launches,
                 ivf_kernel.ivf_batch_topk_cuda.launches + ivf_kernel.ivf_batch_topk_int8_cuda.launches)
        assert after == (before[0] + 1, before[1] + 1)
        a.save(str(tmp_path / dtype))
        cpu = IVFIndex.load(str(tmp_path / dtype), device="cpu")
        cs, ci = cpu.search(q, k=10, nprobe=8, batched=False)
        if dtype == "int8":
            # each device normalizes and quantizes the queries: last-ulp query scales
            assert torch.equal(s1, s2) and torch.equal(i1, i2)
            assert torch.equal(i1, ci) and torch.allclose(s1, cs, rtol=1e-6, atol=0)
        else:
            assert torch.allclose(s1, s2, rtol=0, atol=1e-3)
            assert (i1 == ci).float().mean().item() >= 0.99


def test_f32_ivf_index_on_card(dev, tmp_path):
    """An f32 IVF index built on the card: the public searches launch f32
    B8a and B9a, the layouts agree within 5e-5, the index loaded on the
    CPU (plain versions) gives the same ids but for near ties, and ``add``
    and ``delete`` keep new rows findable."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    rng = np.random.default_rng(14)
    centers = rng.standard_normal((32, 128))
    x = (centers[rng.integers(0, 32, 8000)] + 0.3 * rng.standard_normal((8000, 128)))
    x = x.astype(np.float32)
    q = x[:40] + 0.05 * rng.standard_normal((40, 128)).astype(np.float32)
    a = IVFIndex.build(x, EngineConfig(dim=128, dtype="float32", ivf_nlist=64,
                                       ivf_kmeans_iters=4))
    assert a.buckets.is_cuda and a.buckets.dtype == torch.float32
    fns = (ivf_kernel.ivf_probe_topk_f32_cuda, ivf_kernel.ivf_batch_topk_f32_cuda)
    before = [fn.launches for fn in fns]
    s1, i1 = a.search(q, k=10, nprobe=8, batched=False)
    s2, i2 = a.search(q, k=10, nprobe=8, batched=True)
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    assert torch.allclose(s1, s2, rtol=0, atol=5e-5)
    a.save(str(tmp_path / "f32"))
    cs, ci = IVFIndex.load(str(tmp_path / "f32"), device="cpu").search(q, k=10, nprobe=8)
    assert torch.allclose(s1, cs, rtol=0, atol=5e-5)
    assert (i1 == ci).float().mean().item() >= 0.99
    b = a.add(q[:5]).delete([0, 1])
    _, ib = b.search(q[:5], k=1, nprobe=8)
    assert (ib[:, 0] >= 8000).float().mean().item() >= 0.8


def test_int4_ivf_index_on_card(dev, tmp_path):
    """An int4 IVF index with the rerank on the card: the public searches
    launch B8c and B9c, both layouts are bit-identical, and the index
    loaded on the CPU (plain versions) gives the same ids; ``add`` and
    ``delete`` keep new rows findable."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((32, 128))
    x = (centers[rng.integers(0, 32, 8000)] + 0.3 * rng.standard_normal((8000, 128)))
    x = x.astype(np.float32)
    q = x[:40] + 0.05 * rng.standard_normal((40, 128)).astype(np.float32)
    cfg = EngineConfig(dim=128, dtype="int4", ivf_nlist=64, ivf_kmeans_iters=4,
                       rerank_factor=4)
    a = IVFIndex.build(x, cfg)
    assert a.buckets.is_cuda and a.buckets.shape[0] == 64 * a.cap // 2
    fns = (ivf_kernel.ivf_probe_topk_int4_cuda, ivf_kernel.ivf_batch_topk_int4_cuda)
    before = [fn.launches for fn in fns]
    s1, i1 = a.search(q, k=10, nprobe=8, batched=False)
    s2, i2 = a.search(q, k=10, nprobe=8, batched=True)
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    a.save(str(tmp_path / "i4"))
    cpu = IVFIndex.load(str(tmp_path / "i4"), device="cpu")
    cs, ci = cpu.search(q, k=10, nprobe=8, batched=False)
    assert torch.equal(i1, ci)       # reranked in f32 on the host from one refine copy
    b = a.add(q[:5]).delete([0, 1])
    _, ib = b.search(q[:5], k=1, nprobe=8)
    assert (ib[:, 0] >= 8000).float().mean().item() >= 0.8


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_ivf_search_takes_the_card_layout_rule(dev, dtype):
    """``IVFIndex.search(batched=None)`` on the card takes the bucket-major
    layout from ``ivf_layout_threshold``'s batch on (nlist 64, nprobe 8),
    launches that layout's kernel once, and returns what that layout
    returns when asked for explicitly."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    rng = np.random.default_rng(19)
    centers = rng.standard_normal((32, 128))
    x = (centers[rng.integers(0, 32, 8000)] + 0.3 * rng.standard_normal((8000, 128)))
    x = x.astype(np.float32)
    ix = IVFIndex.build(x, EngineConfig(dim=128, dtype=dtype, ivf_nlist=64, ivf_kmeans_iters=4,
                                        rerank_factor=4 if dtype == "int4" else 0))
    kind = {"bfloat16": "bf16", "float32": "f32"}.get(dtype, dtype)
    sfx = "" if kind == "bf16" else "_" + kind
    fns = {False: getattr(ivf_kernel, f"ivf_probe_topk{sfx}_cuda"),
           True: getattr(ivf_kernel, f"ivf_batch_topk{sfx}_cuda")}
    thr = ivf_kernel.ivf_layout_threshold(kind, 8, ix.nlist)
    for b in (1, thr - 1, thr, 2 * thr):
        if b < 1:
            continue
        q = x[:b] + 0.05 * rng.standard_normal((b, 128)).astype(np.float32)
        want = b >= thr
        before = {lay: fn.launches for lay, fn in fns.items()}
        s, i = ix.search(q, k=10, nprobe=8)
        assert {lay: fn.launches - before[lay] for lay, fn in fns.items()} == {
            want: 1, not want: 0}, b
        es, ei = ix.search(q, k=10, nprobe=8, batched=want)
        assert torch.equal(s, es) and torch.equal(i, ei), b


def test_build_streaming_on_card_equals_build(dev):
    """``build_streaming`` on the card from two 65,536-row chunks (the block
    the in-memory build assigns in, so the matrix products have the same
    shapes): the in-memory build's index bucket for bucket, bf16, int8 and
    int4 from host chunks (pinned staging) and int8 again from chunks
    already on the card (no staging)."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    rng = np.random.default_rng(13)
    centers = rng.standard_normal((64, 64))
    x = (centers[rng.integers(0, 64, 131072)]
         + 0.3 * rng.standard_normal((131072, 64))).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    for dtype, src in (("bfloat16", x), ("int8", x), ("int4", x), ("int8", xd)):
        cfg = EngineConfig(dim=64, dtype=dtype, ivf_nlist=64, ivf_kmeans_iters=4)
        mem = IVFIndex.build(x, cfg, seed=1)
        st = IVFIndex.build_streaming(lambda: (src[i:i + 65536] for i in (0, 65536)), 131072,
                                      cfg, seed=1, chunk_rows=65536)
        rows = mem.buckets.shape[0]
        assert st.cap == mem.cap and torch.equal(st.bucket_ids, mem.bucket_ids), dtype
        assert torch.equal(st.buckets[:rows], mem.buckets), dtype
        assert (mem.bucket_scales is None) or torch.equal(st.bucket_scales, mem.bucket_scales)


def test_streaming_flat_int8_equals_resident_on_card(dev):
    """The host-streaming int8 index (three chunks through the pinned
    staging buffers, with and without prefetch) against the resident int8
    ``FlatIndex``: the same scan per chunk and the same quantization, so
    ids and scores are equal; B2 launches once per chunk."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import FlatIndex, StreamingFlatIndex
    rng = np.random.default_rng(14)
    x = rng.standard_normal((20000, 128)).astype(np.float32)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    cfg = EngineConfig(dim=128, dtype="int8", corpus_tile=2048)
    st = StreamingFlatIndex.build(x, cfg, chunk_rows=8192)
    res = FlatIndex.build(x, cfg)
    before = quant.int8_topk_cuda.launches
    s1, i1 = st.search(q, k=10)
    assert quant.int8_topk_cuda.launches == before + 3
    s2, i2 = st.search(q, k=10, prefetch=False)
    rs, ri = res.search(q, k=10)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert torch.equal(i1, ri) and torch.equal(s1, rs)


def test_llm_server_on_card(dev):
    """The continuous-batching server on a small int4-weight, int8-KV model
    (dh 64) on the card: a two-turn session extends its lane, every request
    gets finite text, and the three kernels of the path launch."""
    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models import Generator
    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.serve.llm import ChatSession, LLMServer
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=2, heads=4, kv_heads=2,
                        mlp_dim=512, max_len=1024, qkv_bias=True, dtype="bfloat16",
                        attn_impl="flash", kv_dtype="int8")
    gen = Generator(cfg, init_params(cfg, seed=3, device=dev, bits=4), device=dev)
    fns = (matvec.matvec_int4_cuda, attention.flash_decode_int8_cuda,
           attention.flash_prefill_int8_cuda)
    before = [fn.launches for fn in fns]
    with LLMServer(gen, slots=4, chunk=8) as srv:
        outs = srv.complete_batch(["头痛", "高血压的饮食建议"], max_new_tokens=12, timeout=300)
        s = ChatSession(srv, max_new_tokens=12)
        s.ask("咳嗽")
        s.ask("需要吃药吗")
        assert srv.stats["extends"] >= 1 and srv.stats["errors"] == 0
    assert all(isinstance(o, str) for o in outs)
    assert all(fn.launches > b for fn, b in zip(fns, before))


def test_decoder_apply_remat_launches_on_card(dev):
    """``Decoder.apply`` with flash attention on the card, 2 layers: per
    forward + backward B6 launches once per layer for remat False and
    "names" (its output is kept) and twice for True and "dots", B10a and
    B10b once per layer; every mode gives the same gradients (the
    recompute runs the same kernels on the same inputs; 1e-3 of each
    gradient's largest entry for cuBLAS's choice of algorithm)."""
    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models import optim
    from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params
    from mediquery_rag_tpu_torch.models.train_lm import _leaves_on, lm_loss

    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=2, heads=4, kv_heads=2,
                        mlp_dim=512, max_len=256, dtype="bfloat16", attn_impl="flash")
    params = _leaves_on(init_params(cfg, seed=0, device=dev), dev)
    ids = torch.randint(3, 259, (2, 200), generator=torch.Generator().manual_seed(1))
    mask = torch.ones((2, 200))
    mask[0, -30:] = 0
    mask[1, :17] = 0
    fns = (attention.flash_prefill_cuda, attention.flash_dq_cuda, attention.flash_dkv_cuda)
    grads = {}
    for remat, b6 in ((False, 2), (True, 4), ("dots", 4), ("names", 2)):
        for fn in fns:
            fn.launches = 0
        loss = lm_loss(Decoder(cfg, params).apply(ids, mask, remat=remat), ids, mask)
        grads[remat] = torch.autograd.grad(loss, optim.tree_leaves(params))
        torch.cuda.synchronize()
        assert [fn.launches for fn in fns] == [b6, 2, 2], remat
    for remat in (True, "dots", "names"):
        for a, b in zip(grads[False], grads[remat]):
            assert torch.isfinite(b).all()
            assert (a - b).abs().max() <= 1e-3 * a.abs().max()


# -- the HF checkpoint path ---------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_tiny(tmp_path_factory):
    """A tiny Qwen2 checkpoint (3 shards, untied, q/k/v biases, GQA, head
    dim 64: the attention kernels take 64 or 128) and a tiny BERT, written
    by chip_smoke.py's writers from the corpus."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    with open(os.path.join(root, "data", "medical_data.txt"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    base = tmp_path_factory.mktemp("hf_card")
    qwen = dict(cs.QWEN25_7B, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=None,
                max_position_embeddings=4096)
    bert = dict(cs.BERT_BASE_ZH, hidden_size=96, intermediate_size=192, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=256)
    cs.write_qwen2_checkpoint(str(base / "qwen"), qwen, lines, seed=4, device="cpu", shards=3,
                              merges=300, specials=None)
    cs.write_bert_checkpoint(str(base / "bert"), bert, lines, seed=5, device="cpu")
    return {"qwen": str(base / "qwen"), "bert": str(base / "bert")}


def test_hf_qwen2_loads_on_card_bit_equal_to_cpu(dev, hf_tiny):
    """``load_qwen2`` onto the card (each tensor moved, converted and placed
    there) gives the CPU load's tree bit for bit, bf16 and f32."""
    from mediquery_rag_tpu_torch.models.hf_import import load_qwen2
    for pdt in ("bfloat16", "float32"):
        _, card = load_qwen2(hf_tiny["qwen"], param_dtype=pdt, device=dev)
        _, cpu = load_qwen2(hf_tiny["qwen"], param_dtype=pdt, device="cpu")
        flat = [(card[k], cpu[k]) for k in ("tok_embed", "rms_f", "lm_head")]
        flat += [(card["blocks"][k], cpu["blocks"][k]) for k in cpu["blocks"]]
        for a, b in flat:
            assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_hf_int4_greedy_on_card_matches_cpu(dev, hf_tiny):
    """``TorchLLMClient.from_hf(quantize=4, kv_dtype="int8")`` on the card
    (B7, B6, B5 int8) against the same on the CPU (plain versions): 16
    greedy tokens of the card, fed to both, are each the CPU's argmax or
    within a near tie of it (its CPU logit within twice the step's largest
    |card - CPU| logit of the CPU maximum); the int4 equalizer t rounds
    differently on the two devices (ROADMAP Queue C 4), so the bound is
    measured, not zero. The card's reply is a string."""
    from mediquery_rag_tpu_torch.llm import TorchLLMClient
    from mediquery_rag_tpu_torch.llm.torch_client import render_chat
    card = TorchLLMClient.from_hf(hf_tiny["qwen"], quantize=4, kv_dtype="int8", device=dev,
                                  max_new_tokens=8)
    cpu = TorchLLMClient.from_hf(hf_tiny["qwen"], quantize=4, kv_dtype="int8", device="cpu")
    assert isinstance(card.complete("高血压患者平时饮食需要注意什么？"), str)
    ids, mask = cpu.generator.tokenizer.batch_encode(
        [render_chat("头痛怎么办", template="chatml")])
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    before = matvec.matvec_int4_cuda.launches
    tl, tc = card.generator.model.prefill(ids, mask, 256)
    cl, cc = cpu.generator.model.prefill(ids, mask, 256)
    for _ in range(16):
        t, c = tl.float().cpu()[0], cl.float()[0]
        noise = (t - c).abs().max().item()
        tok = int(t.argmax())
        assert c[tok].item() >= c.max().item() - 2 * noise
        assert (t - c).norm() <= 0.05 * c.norm()
        tl = card.generator.model.decode_step(tc, torch.tensor([tok]))
        cl = cpu.generator.model.decode_step(cc, torch.tensor([tok]))
    assert matvec.matvec_int4_cuda.launches > before


def test_hf_bert_embedder_on_card_matches_cpu(dev, hf_tiny):
    """``BertTextEmbedder`` on the card against the same on the CPU: unit
    rows within 2e-2 (bf16 activations; a sum rounded to bf16 in another
    order can land one bf16 ulp, 2^-8 relative, away and carry through the
    layers)."""
    from mediquery_rag_tpu_torch.models.hf_import import BertTextEmbedder
    texts = ["高血压患者的饮食建议", "糖尿病的早期症状", "头痛", "儿童咳嗽用药注意什么"]
    card = BertTextEmbedder.from_hf(hf_tiny["bert"], device=dev).embed(texts)
    cpu = BertTextEmbedder.from_hf(hf_tiny["bert"], device="cpu").embed(texts)
    np.testing.assert_allclose(np.linalg.norm(card, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=2e-2)


@pytest.mark.parametrize("shape", [(1, 96, 80), (200, 3584, 4608), (3, 4, 7, 64, 48)])
def test_mm_f32_keeps_the_f32_sum_on_card(dev, shape):
    """``ops.matmul.mm_f32``/``bmm_f32`` on bf16 operands (cuBLAS, f32
    output) against the f64 product of the same rounded operands, per
    element within the f32 sum-order bound K 2^-24 sum|a w| (a product
    rounded to bf16 misses it by ~2^-9 relative); the backward equals the
    widened product's gradient of the incoming gradient rounded to bf16,
    within that bound (then rounded to bf16: one bf16 ulp)."""
    from mediquery_rag_tpu_torch.ops.matmul import bmm_f32, mm_f32
    rng = np.random.default_rng(sum(shape))
    *lead, m, k, n = shape
    a = _bf16(rng, (*lead, m, k), dev)
    w = _bf16(rng, (*lead, k, n), dev)
    fn = bmm_f32 if lead else mm_f32
    a.requires_grad_(True)
    w.requires_grad_(True)
    out = fn(a, w, torch.bfloat16)
    assert out.dtype == torch.float32
    ref = a.detach().double() @ w.detach().double()
    kk = a.shape[-1]
    bound = kk * 2.0 ** -24 * (a.detach().double().abs() @ w.detach().double().abs())
    assert ((out.double() - ref).abs() <= bound + 1e-30).all()
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).to(dev)
    ga, gw = torch.autograd.grad(out, (a, w), g)
    gb = g.to(torch.bfloat16).double()
    ad, wd = a.detach().double(), w.detach().double()
    for got, x, y in ((ga, gb, wd.transpose(-1, -2)), (gw, ad.transpose(-1, -2), gb)):
        want = x @ y
        order = x.shape[-1] * 2.0 ** -24 * (x.abs() @ y.abs())
        assert got.dtype == torch.bfloat16
        assert ((got.double() - want).abs() <= 2.0 ** -8 * want.abs() + 2 * order).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4"])
def test_sharded_flat_four_shards_on_one_card(dev, dtype):
    """A ``ShardedFlatIndex`` of four shards that share the card (3,000 rows
    in tiles of 512: the last shard holds none) launches the scan once a
    shard and returns the one-card ``FlatIndex``'s scan bit for bit; the
    sharded IVF index over the same card equals its ``IVFIndex`` in both
    layouts."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import (
        FlatIndex, IVFIndex, ShardedFlatIndex, ShardedIVFIndex)
    from mediquery_rag_tpu_torch.parallel import corpus_mesh

    rng = np.random.default_rng(17)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    q = rng.standard_normal((9, 64)).astype(np.float32)
    mesh = corpus_mesh(4, devices=[dev] * 4)
    cfg = EngineConfig(dim=64, dtype=dtype, corpus_tile=512)
    kern = {"bfloat16": scoring.flat_topk_cuda, "float32": scoring.flat_topk_f32_cuda,
            "int8": quant.int8_topk_cuda, "int4": quant.int4_topk_cuda}[dtype]
    idx = ShardedFlatIndex.build(x, mesh, cfg)
    before = kern.launches
    s, i = idx.search(q, k=10)
    assert kern.launches == before + 4
    one_s, one_i = FlatIndex.build(x, cfg, device=dev).search(q, k=10)
    assert torch.equal(s.cpu(), one_s) and torch.equal(i.cpu(), one_i)
    if dtype == "float32":
        return
    base = IVFIndex.build(x, EngineConfig(dim=64, dtype=dtype, ivf_nlist=16), device=dev)
    sharded = ShardedIVFIndex.from_single(base, mesh)
    for batched in (False, True):
        got = sharded.search(q, k=10, nprobe=4, batched=batched)
        want = base.search(q, k=10, nprobe=4, batched=batched)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_world_size_one_mesh_step_matches_one_process(dev, tmp_path):
    """``LMTrainer`` over a world-size-1 NCCL training mesh (B6, B10a and
    B10b on the card) against ``LMTrainer(mesh=None)`` from the same init,
    2 steps over a right-padded batch: equal losses, launches and
    parameters (one rank runs the one-process step's operations; the size-1
    groups take no collective)."""
    import torch.distributed as tdist

    from mediquery_rag_tpu_torch.config import DecoderConfig, TrainConfig
    from mediquery_rag_tpu_torch.models import optim
    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.models.train_lm import LMBatch, LMTrainer
    from mediquery_rag_tpu_torch.parallel.dist import init_train_mesh

    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=2, heads=4, kv_heads=2, mlp_dim=512,
                        max_len=256, dtype="bfloat16", attn_impl="flash")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 259, (4, 128)))
    mask = torch.ones((4, 128))
    mask[1, 100:] = 0
    mask[3, 7:] = 0
    mesh = init_train_mesh(1, 1, init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    runs = []
    try:
        for m in (None, mesh):
            tr = LMTrainer(cfg, TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=10), mesh=m,
                           device=dev)
            state = tr.init_state(params=params)
            before = attention.flash_prefill_cuda.launches
            losses = []
            for _ in range(2):
                state, met = tr.train_step(state, LMBatch(ids, mask))
                losses.append(float(met["loss"]))
            launches = attention.flash_prefill_cuda.launches - before
            runs.append((losses, optim.tree_leaves(tr.gather_params(state.params)), launches))
    finally:
        tdist.destroy_process_group()
    (l0, p0, n0), (l1, p1, n1) = runs
    assert l0 == l1 and n0 == n1 > 0
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
