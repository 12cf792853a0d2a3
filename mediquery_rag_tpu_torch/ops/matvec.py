"""Int8 weight-streaming matvec for LM decode (port of ``mediquery_rag_tpu/ops/matvec.py``).

Weights are stored transposed ``[out, in]`` int8 with per-output-channel
f32 scales; activations are int8-quantized per row on the fly (absmax/127,
plain PyTorch, as the JAX package does outside its Pallas body). The
integer product runs in the hand-written kernel ``csrc/matvec_int8.cu`` on
CUDA tensors and in :func:`int8_matmul_plain` on CPU tensors; the two agree
bit for bit (the int32 sum is exact either way).
"""

from __future__ import annotations

import torch

from mediquery_rag_tpu_torch.ops import _build


def quantize_rows_absmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, D]`` float -> (int8 codes, ``[B]`` f32 scales): absmax/127 with
    a 1e-12 floor, round half to even, clip to +-127."""
    xf = x.float()
    qs = torch.clamp(xf.abs().amax(dim=-1), min=1e-12) / 127.0
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
    _build.check(lib.matvec_int8(x8.data_ptr(), w8.data_ptr(), s.data_ptr(),
                                 out.data_ptr(), b, f, d,
                                 _build.stream_ptr(x8)), "matvec_int8")
    matvec_int8_cuda.launches += 1
    return out


matvec_int8_cuda.launches = 0


def quant_matvec(
    x: torch.Tensor,           # [B, D] activations (any float dtype)
    w8: torch.Tensor,          # [F, D] int8 (out, in), or [L, F, D] with layer
    scales: torch.Tensor,      # [F] f32 ([L, F] stacked)
    *,
    layer: int | None = None,  # selects one layer of stacked weights
) -> torch.Tensor:
    """``x @ W`` with int8-streamed weights. Returns ``[B, F]`` f32."""
    if layer is not None:
        w8, scales = w8[layer], scales[layer]     # views: a pointer offset
    x8, qs = quantize_rows_absmax(x)
    if x8.is_cuda:
        out = matvec_int8_cuda(x8, w8, scales)
    else:
        out = int8_matmul_plain(x8, w8, scales)
    return out * qs[:, None]


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` float -> (``[out, in]`` i8, ``[out]`` f32 scales).
    Symmetric per-output-channel; the transpose bakes the kernel layout."""
    wt = w.float().T
    s = torch.clamp(wt.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(wt / s[:, None]), -127, 127).to(torch.int8)
    return q.contiguous(), s


def _quantize_stacked(w: torch.Tensor) -> dict:
    """``[L, in, out]`` -> {"q": [L, out, in] i8, "s": [L, out] f32}, one
    layer at a time so the f32 transient is one layer."""
    pairs = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return {"q": torch.stack([p[0] for p in pairs]),
            "s": torch.stack([p[1] for p in pairs])}


def quantize_decoder_params(params: dict, bits: int = 8) -> dict:
    """Weight-only int8 quantization of a decoder parameter tree (the JAX
    layout: ``blocks`` stacked ``[L, in, out]``). Every big matmul weight
    becomes ``{"q": [.., out, in] i8, "s": [.., out] f32}``; gate and up are
    concatenated along the out axis into one ``w_gateup`` matrix first
    (channel order [gate | up], the JAX default at int8). int4 is a later
    port (ROADMAP Queue B, B7)."""
    if bits != 8:
        raise NotImplementedError(
            f"bits={bits}: only int8 is ported; int4 (B7) is a ROADMAP "
            "Queue B item")
    out = dict(params)
    blocks = dict(params["blocks"])
    blocks["w_gateup"] = _quantize_stacked(
        torch.cat([blocks.pop("w_gate"), blocks.pop("w_up")], dim=-1))
    for k in ("qkv", "attn_out", "w_down"):
        blocks[k] = _quantize_stacked(blocks[k])
    out["blocks"] = blocks
    q, s = quantize_weight(params["lm_head"])
    out["lm_head"] = {"q": q, "s": s}
    return out
