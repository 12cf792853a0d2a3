"""Products of ``adt`` operands whose sum stays in f32.

The counterpart of JAX's ``einsum(..., preferred_element_type=jnp.float32)``
over operands cast to the activation dtype (``mediquery_rag_tpu/models/
decoder.py:_mm``, ``embedder.py:_block``): both operands are rounded to
``adt``, multiplied, and summed in f32; the sum is returned unrounded.

On the CPU both rounded operands are widened to f32 first: the product of
two bf16 (or f16) values is exact in f32, so only the order of the sum
differs from JAX. On the card a bf16/f16 product runs as one cuBLAS call
with f32 output (``torch.mm(..., out_dtype=torch.float32)``, ``aten::mm.dtype``;
``bmm`` for batched ones) on the tensor cores. XLA computes these einsums
outside any Pallas kernel, so a library product is the port's as well.

The card's backward rounds the f32 incoming gradient to ``adt`` and runs
the same f32-output products, as the TPU's default precision does; the
CPU's backward differentiates the widened product, as JAX does on the CPU.
Either way each operand's gradient is rounded to ``adt``, as JAX's is.
"""

from __future__ import annotations

import torch

_LOW = (torch.bfloat16, torch.float16)


class _CardMm(torch.autograd.Function):
    """``a @ b`` -> f32 for 2-D (``mm``) or 3-D (``bmm``) ``adt`` operands
    on the card."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _mm(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm(a.transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fn = torch.mm if a.dim() == 2 else torch.bmm
    return fn(a, b, out_dtype=torch.float32)


def _rounded(a: torch.Tensor, b: torch.Tensor, adt: torch.dtype):
    return a.to(adt), b.to(adt)


def mm_f32(x: torch.Tensor, w: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` -> f32 ``[..., N]``: operands rounded to
    ``adt``, the sum in f32."""
    x, w = _rounded(x, w, adt)
    if adt not in _LOW or not x.is_cuda:
        return x.float() @ w.float()
    out = _CardMm.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    """Batched ``a [..., M, K] @ b [..., K, N]`` (the same leading dims) ->
    f32 ``[..., M, N]``: operands rounded to ``adt``, the sum in f32."""
    a, b = _rounded(a, b, adt)
    if adt not in _LOW or not a.is_cuda:
        return a.float() @ b.float()
    lead = a.shape[:-2]
    out = _CardMm.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    return out.reshape(*lead, *out.shape[-2:])
