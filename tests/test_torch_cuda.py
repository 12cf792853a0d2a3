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

from mediquery_rag_tpu_torch.ops import attention, matvec, quant, scoring

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


@pytest.mark.parametrize("b,h,kh,s,dh,pad", [
    (2, 28, 4, 300, 128, 37), (1, 4, 2, 64, 64, 0), (3, 8, 8, 129, 128, 5)])
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
