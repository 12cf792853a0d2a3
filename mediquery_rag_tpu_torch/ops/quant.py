"""Int8 / int4 quantized scoring (port of ``mediquery_rag_tpu/ops/quant.py``).

The flat scan is bound by reading the corpus, so the storage type sets its
speed: an int8 corpus with per-row scales reads about half the bytes of
bf16, the row-pair-packed int4 corpus about a quarter. Quantization is
symmetric per row (scale = max|x| / 127 or / 7, floored at 1e-12); queries
are quantized to int8 outside the kernel, and the query scale multiplies
only the k returned scores (a positive per-row constant never changes a
row's order).

int4 packs two LOGICAL rows per byte-row: byte ``[r, j]`` holds row
``2r``'s code biased +8 in the low nibble and row ``2r+1``'s code signed in
the high nibble, with ``[2, P]`` scale planes (plane 0 even rows, plane 1
odd rows) and a zero phantom row of scale 1.0 for odd N. With
``ulo = byte & 15``, ``dotU = q8 . ulo`` and ``dotP = q8 . byte``:
``even = (dotU - 8 sum(q8)) * s0`` and ``odd = (dotP - dotU) * (s1 / 16)``.

On CUDA tensors the scans launch the hand-written kernels of
``csrc/quant_topk.cu`` (replacing the Pallas ``_int8_topk_kernel`` and
``_int4_topk_kernel``; cut by :func:`int8_scan_plan` and
:func:`int4_scan_plan`); on CPU
tensors they run the plain versions, which do the same f32 arithmetic over
the full ``[B, N]`` score matrix followed by a stable top-k.
"""

from __future__ import annotations

import functools

import torch

from mediquery_rag_tpu_torch.ops import _build
from mediquery_rag_tpu_torch.ops.scoring import (
    LANE, ScanPlan, _round_up, check_stats, pad_short, scan_lists, scan_plan)
from mediquery_rag_tpu_torch.ops.topk import exact_topk

_PLAIN_ROWS = 8192      # corpus rows per f64 product in the plain versions


@functools.lru_cache(maxsize=None)
def _divisor(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def absmax_scale(x: torch.Tensor, levels: float, floor: float = 1e-12) -> torch.Tensor:
    """Row scales ``max(max|x|, floor) / levels`` over the last dim of f32
    ``x``: the correctly rounded f32 quotient on every device. The divisor is
    a 0-dim f32 tensor on ``x``'s device (cached): ATen's CUDA division by a
    Python float multiplies by its reciprocal, which can land one bit off
    the quotient the CPU and JAX compute."""
    return torch.clamp(x.abs().amax(dim=-1), min=floor) / _divisor(float(levels), x.device)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (codes ``[N, D]`` i8, scales ``[N]`` f32)."""
    xf = x.float()
    scale = absmax_scale(xf, 127)
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4, two logical rows per byte-row.
    Returns (packed ``[P, D]`` i8, scale planes ``[2, P]`` f32), ``P = ceil(N/2)``."""
    xf = x.float()
    scale = absmax_scale(xf, 7)
    q = torch.clamp(torch.round(xf / scale[:, None]), -7, 7).to(torch.int32)
    if xf.shape[0] % 2:                      # zero phantom row, scale 1.0
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
        scale = torch.cat([scale, scale.new_ones(1)])
    lo, hi = q[0::2], q[1::2]
    packed = (hi * 16 + (lo + 8)).to(torch.int8)
    return packed, torch.stack([scale[0::2], scale[1::2]])


def int4_codes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4 CODES, one per byte (unpacked), and scales
    ``[N]`` f32: the IVF build scatters them into bucket slots like int8
    rows, then :func:`ivf_pack_slots_int4` pairs them."""
    xf = x.float()
    scale = absmax_scale(xf, 7)
    codes = torch.clamp(torch.round(xf / scale[:, None]), -7, 7).to(torch.int8)
    return codes, scale


def ivf_pack_slots_int4(codes: torch.Tensor, nlist: int, cap: int) -> torch.Tensor:
    """Bucket-local split-half packing: slot ``j`` of a bucket goes to the
    low nibble (biased +8) of packed row ``j``, slot ``j + cap/2`` to the
    high nibble, so the probe kernels' ``[even | odd]`` scores line up with
    the slot-ordered ``bucket_ids`` and scales. ``codes`` ``[nlist*cap, D]``
    i8 in slot order -> ``[nlist*cap/2, D]`` i8. The arithmetic stays in
    int8 (``hi*16`` in [-112, 112], plus ``lo+8`` <= 127): an int32 upcast
    would take four times the buffer (3.2 GB at 1M x 768)."""
    if cap % 2:
        raise ValueError(f"int4 IVF needs even cap, got {cap}")
    d = codes.shape[1]
    c3 = codes.reshape(nlist, cap, d)
    caph = cap // 2
    out = c3[:, caph:] * 16
    out += c3[:, :caph]
    out += 8
    return out.reshape(nlist * caph, d)


def ivf_unpack_slots_int4(packed: torch.Tensor, nlist: int, cap: int) -> torch.Tensor:
    """Inverse of :func:`ivf_pack_slots_int4`: ``[nlist*cap/2, D]`` i8 ->
    slot-ordered codes ``[nlist*cap, D]`` i8 (in int8, as the packing)."""
    d = packed.shape[1]
    p = packed.reshape(nlist, cap // 2, d)
    lo = (p & 15) - 8                        # low nibble is biased unsigned
    hi = p >> 4                              # arithmetic shift
    return torch.cat([lo, hi], dim=1).reshape(nlist * cap, d)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of the row-pair packing: ``[P, D]`` i8 -> ``[2P, D]`` i32."""
    p = packed.to(torch.int32)
    lo = (p & 15) - 8                        # low nibble is biased unsigned
    hi = p >> 4                              # arithmetic shift
    return torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1])


def dequantize_int4(packed: torch.Tensor, scale2: torch.Tensor,
                    n: int | None = None) -> torch.Tensor:
    """``[P, D]`` i8 + ``[2, P]`` scale planes -> ``[n, D]`` f32."""
    n = 2 * packed.shape[0] if n is None else n
    scale = scale2.T.reshape(-1)             # logical per-row order
    return unpack_int4(packed)[:n].float() * scale[:n, None]


def _int_dot(q8: torch.Tensor, c8: torch.Tensor) -> torch.Tensor:
    """Exact ``q8 @ c8^T`` of int8 operands as f32 (f64 holds every
    partial sum exactly; the one rounding is the int -> f32 conversion the
    kernels do too)."""
    return (q8.double() @ c8.double().T).float()


def int8_flat_search_plain(q8: torch.Tensor, c8: torch.Tensor, cscale: torch.Tensor,
                           k: int, n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the int8 kernel: ``float(q8 . c8) * cscale`` over
    every row, rows >= ``n_valid`` masked, stable descending top-k, short
    results (-inf, id 0). Scores carry no query scale."""
    n_pad = c8.shape[0]
    scores = torch.empty((q8.shape[0], n_pad), dtype=torch.float32, device=c8.device)
    for r in range(0, n_pad, _PLAIN_ROWS):
        e = min(n_pad, r + _PLAIN_ROWS)
        scores[:, r:e] = _int_dot(q8, c8[r:e]) * cscale[None, r:e]
    scores[:, n_valid:] = float("-inf")
    return pad_short(*exact_topk(scores, k), k)


def int4_flat_search_plain(q8: torch.Tensor, corr: torch.Tensor, c4: torch.Tensor,
                           planes: torch.Tensor, k: int,
                           n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the int4 kernel over the ``2P`` logical rows, in the
    kernel's f32 operation order; ``corr`` is ``8 * sum(q8)`` per query."""
    p_rows = c4.shape[0]
    scores = torch.empty((q8.shape[0], 2 * p_rows), dtype=torch.float32,
                         device=c4.device)
    for r in range(0, p_rows, _PLAIN_ROWS):
        e = min(p_rows, r + _PLAIN_ROWS)
        du = _int_dot(q8, c4[r:e] & 15)
        dp = _int_dot(q8, c4[r:e])
        scores[:, 2 * r:2 * e:2] = (du - corr[:, None]) * planes[0, None, r:e]
        scores[:, 2 * r + 1:2 * e:2] = (dp - du) * (planes[1, None, r:e] * 0.0625)
    scores[:, n_valid:] = float("-inf")
    return pad_short(*exact_topk(scores, k), k)


def _check(what: str, k: int, q8: torch.Tensor, rows: torch.Tensor, *f32s) -> None:
    d = q8.shape[1]
    if not 1 <= k <= LANE:
        raise ValueError(f"{what} takes 1 <= k <= {LANE}, got {k}")
    if d % 32 or rows.shape[1] != d or rows.shape[0] % 64:
        raise ValueError(f"{what} needs D % 32 == 0 and byte-rows % 64 == 0, "
                         f"got query D={d}, corpus {tuple(rows.shape)}")
    if q8.dtype != torch.int8 or rows.dtype != torch.int8:
        raise ValueError(f"{what} takes int8 queries and corpus codes")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{what} takes float32 scales")
    for t in (q8, rows, *f32s):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} operands must be contiguous, 16-byte "
                             "aligned CUDA tensors")


def int8_scan_plan(b_pad: int, d: int, n_pad: int, k: int) -> ScanPlan:
    """B2's plan (``scoring.scan_plan``): at D=768, k <= 32 one pass over
    the corpus serves up to 128 queries, 32 at D=3072."""
    return scan_plan("int8", b_pad, d, n_pad, k)


def int4_scan_plan(b_pad: int, d: int, p_rows: int, k: int) -> ScanPlan:
    """B3's plan over ``p_rows`` packed byte-rows (``scoring.scan_plan``):
    up to 64 queries a block (two int32 sums a score)."""
    return scan_plan("int4", b_pad, d, p_rows, k)


def _pad_queries(q8: torch.Tensor, corr) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Queries (and int4's corrections) padded with zero rows to a multiple of 16."""
    b, d = q8.shape
    b_pad = _round_up(max(b, 1), 16)
    q = torch.zeros((b_pad, d), dtype=torch.int8, device=q8.device)
    q[:b] = q8
    if corr is None:
        return q, None
    cp = torch.zeros((b_pad,), dtype=torch.float32, device=q8.device)
    cp[:b] = corr
    return q, cp


def int8_topk_cuda(q8: torch.Tensor, c8: torch.Tensor, cscale: torch.Tensor, k: int,
                   n_valid: int, *, stats: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``int8_topk`` of ``csrc/quant_topk.cu``: q8 ``[B, D]`` i8,
    c8 ``[N_pad, D]`` i8, cscale ``[N_pad]`` f32 -> (scores, ids) ``[B, k]``.
    ``stats``, an int32 CUDA tensor of 2, gains the scores that passed the
    in-register filter and the blocks' merge rounds (a measurement hook)."""
    _check("int8_topk", k, q8, c8, cscale)
    check_stats("int8_topk", stats, c8.device)
    lib = _build.load("quant_topk")
    b, d = q8.shape
    q, _ = _pad_queries(q8, None)
    plan = int8_scan_plan(q.shape[0], d, c8.shape[0], k)
    bufs = scan_lists(q.shape[0], plan.ranges, k, c8.device)
    _build.launch("int8_topk", lib.int8_topk, c8, q.data_ptr(), c8.data_ptr(),
                  cscale.data_ptr(), q.shape[0], d, c8.shape[0], int(n_valid), plan.qb,
                  int(plan.qstream), plan.stages, plan.ranges, k,
                  *[t.data_ptr() for t in bufs], None if stats is None else stats.data_ptr())
    int8_topk_cuda.launches += 1
    return bufs[2][:b], bufs[3][:b]


int8_topk_cuda.launches = 0


def int4_topk_cuda(q8: torch.Tensor, corr: torch.Tensor, c4: torch.Tensor,
                   planes: torch.Tensor, k: int, n_valid: int, *,
                   stats: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``int4_topk`` of ``csrc/quant_topk.cu``: q8 ``[B, D]`` i8,
    corr ``[B]`` f32, c4 ``[P, D]`` i8 packed, planes ``[2, P]`` f32 ->
    (scores, logical ids) ``[B, k]``; ``stats`` as :func:`int8_topk_cuda`'s."""
    _check("int4_topk", k, q8, c4, corr, planes)
    if planes.shape != (2, c4.shape[0]):
        raise ValueError(f"scale planes {tuple(planes.shape)} != (2, {c4.shape[0]})")
    check_stats("int4_topk", stats, c4.device)
    lib = _build.load("quant_topk")
    b, d = q8.shape
    q, cp = _pad_queries(q8, corr)
    b_pad = q.shape[0]
    plan = int4_scan_plan(b_pad, d, c4.shape[0], k)
    bufs = scan_lists(b_pad, plan.ranges, k, c4.device)
    _build.launch("int4_topk", lib.int4_topk, c4, q.data_ptr(), cp.data_ptr(), c4.data_ptr(),
                  planes.data_ptr(), b_pad, d, c4.shape[0], int(n_valid), plan.qb,
                  int(plan.qstream), plan.stages, plan.ranges, k,
                  *[t.data_ptr() for t in bufs], None if stats is None else stats.data_ptr())
    int4_topk_cuda.launches += 1
    return bufs[2][:b], bufs[3][:b]


int4_topk_cuda.launches = 0


def int8_flat_search(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,       # [N_pad, D] int8 (pad rows zero)
    corpus_scale: torch.Tensor,   # [N_pad] f32
    k: int,
    *,
    n_valid: int | None = None,
    query_tile: int = 128,
    corpus_tile: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an int8 corpus; queries are quantized here.
    ``query_tile`` is accepted for signature parity (the kernel tiles by 16)."""
    del query_tile
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    n_pad = corpus_q.shape[0]
    if n_pad % corpus_tile:
        raise ValueError(f"corpus rows {n_pad} % tile {corpus_tile} != 0")
    n_valid = n_pad if n_valid is None else int(n_valid)
    q8, qs = quantize_rows(queries)
    if corpus_q.is_cuda:
        s, i = int8_topk_cuda(q8, corpus_q, corpus_scale, k, n_valid)
    else:
        s, i = int8_flat_search_plain(q8, corpus_q, corpus_scale, k, n_valid)
    return s * qs[:, None], i


def int4_flat_search(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,       # [N_pad/2, D] i8 row-pair packed (pads zero)
    corpus_scale: torch.Tensor,   # [2, N_pad/2] f32 scale planes (even, odd)
    k: int,
    *,
    n_valid: int | None = None,
    query_tile: int = 128,
    corpus_tile: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-pair-packed int4 corpus; ``corpus_tile``
    counts logical rows and must be even."""
    del query_tile
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    nph, dc = corpus_q.shape
    n_pad = 2 * nph
    if dc != queries.shape[1]:
        raise ValueError(f"query dim {queries.shape[1]} != packed corpus dim {dc}")
    if corpus_tile % 2:
        raise ValueError(f"int4 corpus_tile must be even, got {corpus_tile}")
    if n_pad % corpus_tile:
        raise ValueError(f"corpus rows {n_pad} % tile {corpus_tile} != 0")
    if tuple(corpus_scale.shape) != (2, nph):
        raise ValueError(f"scale planes {tuple(corpus_scale.shape)} != (2, {nph})")
    n_valid = n_pad if n_valid is None else int(n_valid)
    q8, qs = quantize_rows(queries)
    # bias correction 8*sum(q8): <= 8*127*D, exact in f32 for D < 16K
    corr = (8 * q8.to(torch.int32).sum(dim=1)).float()
    if corpus_q.is_cuda:
        s, i = int4_topk_cuda(q8, corr, corpus_q, corpus_scale, k, n_valid)
    else:
        s, i = int4_flat_search_plain(q8, corr, corpus_q, corpus_scale, k, n_valid)
    return s * qs[:, None], i
