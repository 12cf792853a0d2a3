"""The port's seven absmax row quantizers against numpy, on the CPU.

Each quantizer's scale must be the correctly rounded f32 quotient
``max(max|x|, floor) / levels`` (numpy's f32 division) and its codes
``clip(rint(x / scale))``, bit for bit, over 10^5 rows at every scale
they meet: standard normal rows, rows scaled from the subnormals to 2^123,
and rows at, just above and just below the floors (1e-12; 1e-6 for the
KV cache). ``tests/test_torch_cuda.py`` holds the card to the CPU on the
same kinds of rows.
"""

import numpy as np
import pytest
import torch

from mediquery_rag_tpu_torch.models import decoder
from mediquery_rag_tpu_torch.ops import matvec, quant

N, WIDTH = 100_000, 8


def scale_rows(n: int = N, width: int = WIDTH, seed: int = 0) -> np.ndarray:
    """``[n, width]`` f32: a quarter standard normal, half scaled by 2^u
    (u uniform in [-140, 120]), a quarter at the floors (zero, 1e-12, 1e-6
    and their neighbours)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, width)).astype(np.float32)
    q = n // 4
    x[q:3 * q] *= np.exp2(rng.uniform(-140, 120, (2 * q, 1))).astype(np.float32)
    floors = np.float32([0.0, 1e-12, 1e-6])
    floors = np.concatenate([floors, np.nextafter(floors, np.float32(1)),
                             np.nextafter(floors, np.float32(0))])
    tail = x[3 * q:]
    tail /= np.abs(tail).max(axis=1, keepdims=True)
    tail *= floors[np.arange(len(tail)) % len(floors)][:, None]
    return x


def _unpack_channels(q4: torch.Tensor) -> torch.Tensor:
    """quantize_weight_int4's byte row r: channel r low (+8), r + F/2 high."""
    p = q4.to(torch.int32)
    return torch.cat([(p & 15) - 8, p >> 4])


def _weight_int4(x):
    w = matvec.quantize_weight_int4(x.T.contiguous())
    return _unpack_channels(w["q4"]), w["s"].reshape(-1), x / w["t"]


# name -> (x -> (codes [n, width], scales [n], the rows the scales are of), levels, floor)
QUANTIZERS = {
    "matvec.quantize_rows_absmax": (lambda x: (*matvec.quantize_rows_absmax(x), x), 127, 1e-12),
    "matvec.quantize_weight": (
        lambda x: (*matvec.quantize_weight(x.T.contiguous()), x), 127, 1e-12),
    "matvec.quantize_weight_int4": (_weight_int4, 7, 1e-12),
    "quant.quantize_rows": (lambda x: (*quant.quantize_rows(x), x), 127, 1e-12),
    "quant.quantize_rows_int4": (
        lambda x: (quant.unpack_int4(quant.quantize_rows_int4(x)[0]),
                   quant.quantize_rows_int4(x)[1].T.reshape(-1), x), 7, 1e-12),
    "quant.int4_codes": (lambda x: (*quant.int4_codes(x), x), 7, 1e-12),
    "decoder._kv_quantize": (lambda x: (*decoder._kv_quantize(x), x), 127, 1e-6),
}


@pytest.mark.parametrize("name", list(QUANTIZERS))
def test_row_scales_are_the_correctly_rounded_quotient(name):
    fn, levels, floor = QUANTIZERS[name]
    x = torch.from_numpy(scale_rows())
    codes, scale, of = fn(x)
    of = of.numpy()
    want = np.maximum(np.abs(of).max(axis=1), np.float32(floor)) / np.float32(levels)
    got = scale.reshape(-1)[:N].numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    want_codes = np.clip(np.rint(of / want[:, None]), -levels, levels)
    assert np.array_equal(codes[:N].numpy().astype(np.int64), want_codes.astype(np.int64))
