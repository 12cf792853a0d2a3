"""Quantized weight-streaming matvecs for LM decode (port of ``mediquery_rag_tpu/ops/matvec.py``).

int8: weights are stored transposed ``[out, in]`` int8 with
per-output-channel f32 scales; activations are int8-quantized per row on
the fly (absmax/127, plain PyTorch, as the JAX package does outside its
Pallas body). The integer product runs in the hand-written kernel
``csrc/matvec_int8.cu`` on CUDA tensors and in :func:`int8_matmul_plain` on
CPU tensors; the two agree bit for bit (the int32 sum is exact either way).

int4: output channels ``r`` (low nibble, code + 8) and ``r + F/2`` (high
nibble, signed) share byte row ``r`` of a ``[F/2, D]`` int8 matrix, with
scale planes ``s [2, F/2]`` and a per-input-dim activation equalizer ``t
[1, D]`` (the JAX package's layout, ``quantize_weight_int4``). Two integer
dots per row, ``dotU = x8 . (byte & 15)`` and ``dotP = x8 . byte``, give
both halves: ``lo = (dotU - 8 sum x8) s0`` and ``hi = (dotP - dotU) / 16
s1``. ``csrc/matvec_int4.cu`` on CUDA tensors, :func:`int4_matmul_plain`
on CPU tensors, bit-equal.

Over a tensor-parallel shard a row-parallel layer (attn_out, w_down) holds
a slice of the input dim. Its caller passes ``row_max``, which maxes each
row's local absmax over the ranks (``QLinear`` passes the model group's
MAX all-reduce), so the absmax is over the whole input dim, as JAX's GSPMD
program takes it: each rank's int8 codes are the single-device codes of
its slice and the ranks' partial products sum to the single-device
product. ``corr = 8 sum x8`` is linear over the slice and stays local. The
kernels themselves do not change.
"""

from __future__ import annotations

import functools
from collections.abc import Callable
from typing import NamedTuple

import torch

from mediquery_rag_tpu_torch.ops import _build
from mediquery_rag_tpu_torch.ops.quant import absmax_scale


def quantize_rows_absmax(x: torch.Tensor, row_max: Callable | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, D]`` float -> (int8 codes, ``[B]`` f32 scales): absmax/127 with
    a 1e-12 floor, round half to even, clip to +-127. ``row_max`` maps the
    ``[B, 1]`` absmax over this slice of D to the absmax over all of D."""
    xf = x.float()
    amax = xf if row_max is None else row_max(xf.abs().amax(dim=-1, keepdim=True))
    qs = absmax_scale(amax, 127)
    x8 = torch.clamp(torch.round(xf / qs[:, None]), -127, 127).to(torch.int8)
    return x8, qs


def int8_matmul_plain(x8: torch.Tensor, w8: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``float(x8 @ w8^T) * s`` with an exact
    integer sum (f64 holds every partial sum of int8 products exactly)."""
    raw = (x8.double() @ w8.double().T).to(torch.int32)
    return raw.float() * s[None, :]


def matvec_int8_cuda(x8: torch.Tensor, w8: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/matvec_int8.cu``: x8 ``[B, D]`` i8, w8 ``[F, D]`` i8
    (a view into stacked weights is fine), s ``[F]`` f32 -> ``[B, F]`` f32."""
    b, d = x8.shape
    f = w8.shape[0]
    if d % 16:
        raise ValueError(f"matvec_int8 needs D % 16 == 0, got D={d}")
    for t in (x8, w8, s):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("matvec_int8 operands must be contiguous and "
                             "16-byte aligned")
    if w8.dtype != torch.int8 or x8.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError("matvec_int8 takes int8 x/w and float32 scales")
    lib = _build.load("matvec_int8")
    out = torch.empty((b, f), dtype=torch.float32, device=x8.device)
    _build.launch("matvec_int8", lib.matvec_int8, x8, x8.data_ptr(), w8.data_ptr(),
                  s.data_ptr(), out.data_ptr(), b, f, d)
    matvec_int8_cuda.launches += 1
    return out


matvec_int8_cuda.launches = 0


def quant_matvec(
    x: torch.Tensor,           # [B, D] activations (any float dtype)
    w8: torch.Tensor,          # [F, D] int8 (out, in), or [L, F, D] with layer
    scales: torch.Tensor,      # [F] f32 ([L, F] stacked)
    *,
    layer: int | None = None,  # selects one layer of stacked weights
    row_max: Callable | None = None,   # a row-parallel shard's absmax over the ranks
) -> torch.Tensor:
    """``x @ W`` with int8-streamed weights. Returns ``[B, F]`` f32."""
    if layer is not None:
        w8, scales = w8[layer], scales[layer]     # views: a pointer offset
    x8, qs = quantize_rows_absmax(x, row_max)
    if x8.is_cuda:
        out = matvec_int8_cuda(x8, w8, scales)
    else:
        out = int8_matmul_plain(x8, w8, scales)
    return out * qs[:, None]


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` float -> (``[out, in]`` i8, ``[out]`` f32 scales).
    Symmetric per-output-channel; the transpose bakes the kernel layout."""
    wt = w.float().T
    s = absmax_scale(wt, 127)
    q = torch.clamp(torch.round(wt / s[:, None]), -127, 127).to(torch.int8)
    return q.contiguous(), s


def _quantize_stacked(w: torch.Tensor) -> dict:
    """``[L, in, out]`` -> {"q": [L, out, in] i8, "s": [L, out] f32}, one
    layer at a time so the f32 transient is one layer."""
    pairs = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return {"q": torch.stack([p[0] for p in pairs]),
            "s": torch.stack([p[1] for p in pairs])}


def quantize_weight_int4(w: torch.Tensor, *, alpha: float = 0.5) -> dict:
    """``[in, out]`` float -> ``{"q4": [out/2, in] i8, "s": [2, out/2] f32,
    "t": [1, in] f32}``: the equalizer ``t = amax_d^alpha`` made
    scale-neutral (geometric mean 1) is divided out of the weights, codes
    are per-output-channel absmax/7 clipped to +-7, and byte row ``r``
    packs channel ``r`` (low nibble, code + 8) with channel ``r + F/2``
    (high nibble, signed): ``16 hi + (lo + 8)``."""
    wt = w.float().T                                     # [F, D]
    f, d = wt.shape
    if f % 2:
        raise ValueError(f"int4 packing needs an even out dim, got {f}")
    amax = torch.clamp(wt.abs().amax(dim=0), min=1e-12)
    # XLA rewrites x ** 0.5 as sqrt; torch's pow(x, 0.5) rounds differently
    t = amax.sqrt() if alpha == 0.5 else amax ** alpha
    t = t / torch.exp(torch.log(t).mean())
    wn = wt / t[None, :]
    s = absmax_scale(wn, 7)
    c = torch.clamp(torch.round(wn / s[:, None]), -7, 7)
    f2 = f // 2
    return {"q4": pack_int4(c), "s": torch.stack([s[:f2], s[f2:]]), "t": t.reshape(1, d)}


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., F/2, D]`` -> signed codes ``[..., F, D]`` int32,
    channel ``r`` from byte row ``r``'s low nibble and channel ``r + F/2``
    from its high nibble."""
    p = q4.to(torch.int32)
    lo = (p & 15) - 8
    hi = torch.div(p - (lo + 8), 16, rounding_mode="floor")   # exact
    return torch.cat([lo, hi], dim=-2)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Codes ``[..., F, D]`` in -7..7 -> packed ``[..., F/2, D]`` int8 (the
    inverse of :func:`unpack_int4`): ``16 hi + (lo + 8)``."""
    c = codes.to(torch.int32)
    f2 = c.shape[-2] // 2
    return (c[..., f2:, :] * 16 + (c[..., :f2, :] + 8)).to(torch.int8).contiguous()


def dequantize_weight_int4(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int4 serving form -> dense ``[out, in]`` weights (prefill, where the
    product is compute-bound)."""
    codes = unpack_int4(wq["q4"]).float()
    return (codes * wq["s"].reshape(-1)[:, None] * wq["t"]).to(dtype)


def int4_matmul_plain(x8: torch.Tensor, corr: torch.Tensor, q4: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Plain version of the int4 kernel: x8 ``[B, D]`` i8, corr ``[B, 1]``
    f32 (8 sum x8), q4 ``[F/2, D]`` i8, s ``[2, F/2]`` f32 -> ``[B, F]`` f32
    ``[lo | hi]`` with exact integer dots (f64 holds them) and the JAX f32
    order ``(dotU - corr) s0`` and ``(dotP - dotU) 0.0625 s1``."""
    xd = x8.double()
    p = q4.to(torch.int32)
    dot_u = (xd @ (p & 15).double().T).to(torch.int32)
    dot_p = (xd @ p.double().T).to(torch.int32)
    lo = (dot_u.float() - corr) * s[0][None, :]
    hi = (dot_p - dot_u).float() * 0.0625 * s[1][None, :]
    return torch.cat([lo, hi], dim=-1)


MV4_TILE_ROWS = 16        # packed weight rows per B7 block (one mma M tile)
MV4_SLICE = 1024          # bytes of D per B7 ring stage, 256 a warp
MV4_GROUP = 32            # x rows per B7 block; more rows take more blocks (grid.y)
MV4_IN_FLIGHT = 8 << 20   # weight bytes B7's plan aims to keep in flight on the card


class Matvec4Plan(NamedTuple):
    """How B7 cuts one launch (:func:`matvec4_plan`): ``row_tiles x
    groups`` blocks, each 16 packed weight rows against up to 32 rows of x
    in ``ntiles`` tiles of 8, walking D in ``slices`` 1 KB slices through a
    ring of ``stages`` shared-memory stages."""
    ntiles: int
    stages: int
    row_tiles: int
    groups: int
    slices: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.groups

    def smem_bytes(self) -> int:
        """The ring (weights and x) and the warps' partial dots."""
        return (self.stages * MV4_SLICE * (MV4_TILE_ROWS + 8 * self.ntiles)
                + 4 * 2 * 8 * self.ntiles * MV4_TILE_ROWS * 4)

    def resident(self) -> int:
        """Blocks on the card at once, as shared memory allows."""
        per_sm = _build.SMEM_PER_SM // (self.smem_bytes() + 1024)
        return min(self.blocks, per_sm * _build.SMS)

    def waves(self) -> int:
        return -(-self.blocks // self.resident())

    def in_flight(self) -> int:
        """Weight bytes in flight when every resident block has its ring full."""
        return self.resident() * (self.stages - 1) * MV4_TILE_ROWS * MV4_SLICE


@functools.lru_cache(maxsize=None)
def matvec4_plan(rows: int, f2: int, d: int) -> Matvec4Plan:
    """B7's plan for ``rows`` rows of x against ``[f2, d]`` packed weights:
    the fewest 8-row tiles that hold a block's rows (up to 32), and the ring
    depth (2 to 8 stages, at most the slices of D, within a block's shared
    memory) that runs the blocks in the fewest waves, then keeps the most
    weight bytes in flight up to ``MV4_IN_FLIGHT``, then is shallowest (a
    deeper ring that costs a block per SM or a wave was slower at every
    7B shape on an H100)."""
    if rows < 1 or f2 < 1 or d < 16:
        raise ValueError(f"matvec4_plan: rows={rows}, F/2={f2}, D={d}")
    nt = -(-min(rows, MV4_GROUP) // 8)
    slices = -(-d // MV4_SLICE)
    fits = [Matvec4Plan(nt, st, -(-f2 // MV4_TILE_ROWS), -(-rows // MV4_GROUP), slices)
            for st in range(2, max(2, min(8, slices)) + 1)]
    fits = [p for p in fits if p.smem_bytes() <= _build.SMEM_PER_BLOCK]
    return min(fits, key=lambda p: (p.waves(), -min(p.in_flight(), MV4_IN_FLIGHT), p.stages))


def matvec_int4_cuda(x8: torch.Tensor, corr: torch.Tensor, q4: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/matvec_int4.cu``: x8 ``[B, D]`` i8, corr ``[B, 1]``
    f32, q4 ``[F/2, D]`` i8 (a view into stacked weights is fine), s ``[2,
    F/2]`` f32 -> ``[B, F]`` f32 ``[lo | hi]``, cut by :func:`matvec4_plan`."""
    b, d = x8.shape
    f2 = q4.shape[0]
    if d % 16:
        raise ValueError(f"matvec_int4 needs D % 16 == 0, got D={d}")
    if q4.dtype != torch.int8 or x8.dtype != torch.int8 or s.dtype != torch.float32 \
            or corr.dtype != torch.float32:
        raise ValueError("matvec_int4 takes int8 x/q4 and float32 corr/scales")
    if tuple(s.shape) != (2, f2) or corr.numel() != b:
        raise ValueError(f"matvec_int4: s {tuple(s.shape)}, corr {tuple(corr.shape)} "
                         f"for F/2={f2}, B={b}")
    for t in (x8, corr, q4, s):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("matvec_int4 operands must be contiguous and "
                             "16-byte aligned")
    lib = _build.load("matvec_int4")
    out = torch.empty((b, 2 * f2), dtype=torch.float32, device=x8.device)
    plan = matvec4_plan(b, f2, d)
    _build.launch("matvec_int4", lib.matvec_int4, x8, x8.data_ptr(), corr.data_ptr(),
                  q4.data_ptr(), s.data_ptr(), out.data_ptr(), b, f2, d, plan.ntiles,
                  plan.stages)
    matvec_int4_cuda.launches += 1
    return out


matvec_int4_cuda.launches = 0


def quant_matvec_int4(
    x: torch.Tensor,           # [B, D] activations (any float dtype)
    wq: dict,                  # quantize_weight_int4 output ([L, ...] with layer)
    *,
    layer: int | None = None,
    row_max: Callable | None = None,   # a row-parallel shard's absmax over the ranks
) -> torch.Tensor:
    """``x @ W`` with int4-streamed weights: ``x t`` quantized per row to
    int8 (absmax/127), ``corr = 8 sum x8``, the two-dot kernel, times the
    row scale. Returns ``[B, F]`` f32 in channel order ``[lo | hi]``."""
    q4, s, t = wq["q4"], wq["s"], wq["t"]
    if layer is not None:
        q4, s, t = q4[layer], s[layer], t[layer]     # views: a pointer offset
    x8, qs = quantize_rows_absmax(x.float() * t, row_max)
    corr = 8.0 * x8.to(torch.int32).sum(dim=-1, keepdim=True).float()
    if x8.is_cuda:
        out = matvec_int4_cuda(x8, corr, q4, s)
    else:
        out = int4_matmul_plain(x8, corr, q4, s)
    return out * qs[:, None]


def _quantize_stacked_int4(w: torch.Tensor) -> dict:
    """``[L, in, out]`` -> stacked int4 form, one layer at a time."""
    parts = [quantize_weight_int4(w[i]) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in ("q4", "s", "t")}


def quantize_decoder_params(params: dict, bits: int = 8) -> dict:
    """Weight-only quantization of a decoder parameter tree (the JAX
    layout: ``blocks`` stacked ``[L, in, out]``). ``bits=8``: every big
    matmul weight becomes ``{"q": [.., out, in] i8, "s": [.., out] f32}``
    and gate and up are concatenated along the out axis into one
    ``w_gateup`` matrix first (channel order [gate | up], the JAX default
    at int8). ``bits=4``: the ``{"q4", "s", "t"}`` form, with gate and up
    kept apart (each needs its own equalizer ``t``), as JAX does at int4."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = dict(params)
    blocks = dict(params["blocks"])
    if bits == 8:
        blocks["w_gateup"] = _quantize_stacked(
            torch.cat([blocks.pop("w_gate"), blocks.pop("w_up")], dim=-1))
        for k in ("qkv", "attn_out", "w_down"):
            blocks[k] = _quantize_stacked(blocks[k])
        q, s = quantize_weight(params["lm_head"])
        out["lm_head"] = {"q": q, "s": s}
    else:
        for k in ("qkv", "attn_out", "w_gate", "w_up", "w_down"):
            blocks[k] = _quantize_stacked_int4(blocks[k])
        out["lm_head"] = quantize_weight_int4(params["lm_head"])
    out["blocks"] = blocks
    return out
