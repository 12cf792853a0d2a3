"""Flash attention forward for prefill and decode (port of ``mediquery_rag_tpu/ops/attention.py``).

Both entry points keep the JAX layout (q ``[B, H, S, dh]``, k/v
``[B, KH, Sk, dh]`` with heads ``kh*g .. kh*g+g-1`` sharing KV head ``kh``)
and the JAX visibility rule: invisible logits get a -1e9 bias, so a query
row with no visible key yields finite output, never NaN.

- :func:`flash_attention`: causal prefill. CUDA tensors launch
  ``csrc/flash_prefill.cu`` (replaces the Pallas ``_flash_kernel``).
- :func:`flash_attention_cached`: mask-only decode attention over the
  cache. CUDA tensors launch ``csrc/flash_decode.cu`` (replaces the Pallas
  ``_flash_cached_kernel``).

CPU tensors run :func:`attention_plain`, the op sequence of the JAX
package's ``mha_reference``. Only a bf16 KV cache is ported; int8 KV, the
fresh-column fold, ``return_ml`` and the backward are ROADMAP Queue B.
"""

from __future__ import annotations

import torch

from mediquery_rag_tpu_torch.ops import _build

_TARGET_BLOCKS = 264   # two blocks per SM of an H100


def _softmax_weights(q, k, v, key_mask, scale, causal, q_offset):
    """f32 softmax weights ``[B, H, S, Sk]`` (-1e9 bias on invisible keys)
    and v in f32 with its KV heads repeated over their query heads."""
    B, H, S, _ = q.shape
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    vis = (key_mask.float() > 0)[:, None, None, :]
    if causal:
        sk = k.shape[2]
        off = (torch.zeros(B, dtype=torch.int64, device=q.device)
               if q_offset is None else q_offset.long())
        rows = torch.arange(S, device=q.device)[None, :] + off[:, None]
        cols = torch.arange(sk, device=q.device)
        vis = vis & (cols[None, None, :] <= rows[:, :, None])[:, None]
    logits = logits + (vis.float() - 1.0) * 1e9
    return torch.softmax(logits, dim=-1), vf


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor, scale: float, *, causal: bool,
                    q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of both kernels: f32 logits, -1e9 bias on invisible
    keys (key c visible to query row r iff ``key_mask[b, c] > 0`` and, if
    ``causal``, ``c <= q_offset[b] + r``), softmax, weights cast to q's
    dtype, f32 P.V. Returns q's dtype."""
    w, vf = _softmax_weights(q, k, v, key_mask, scale, causal, q_offset)
    return (w.to(q.dtype).float() @ vf).to(q.dtype)


def attention_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor, scale: float, ref: torch.Tensor,
                          *, causal: bool,
                          q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Per-element bound on ``|kernel - ref|`` for the bf16 kernels, where
    ``ref`` is :func:`attention_plain` on the same inputs. Both round the
    softmax weights w to bf16 (the kernels before normalizing, the plain
    version after): each weight differs by at most 2^-7 relative, so the
    gap is at most ``2^-7 sum w|v|``; the roundings are independent, so it
    stays within ``2^-5 sqrt(sum w^2 v^2)`` (about 13 standard deviations).
    Both results are then rounded to bf16: up to 2 ulp of ``|ref|``."""
    w, vf = _softmax_weights(q, k, v, key_mask, scale, causal, q_offset)
    worst = w @ vf.abs()
    spread = ((w * w) @ (vf * vf)).sqrt()
    del w
    _, e = torch.frexp(ref.float())
    ulp = torch.where(ref != 0, torch.ldexp(torch.ones_like(worst), e - 8),
                      torch.zeros_like(worst))
    return 2 * ulp + torch.minimum(worst * 2.0 ** -7, spread * 2.0 ** -5)


def _check_cuda(q, k, v):
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA attention kernels take a bfloat16 cache; int8 KV is "
                "a ROADMAP Queue B item")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention operands must be contiguous and "
                             "16-byte aligned")
    dh = q.shape[-1]
    if dh not in (64, 128):
        raise ValueError(f"the CUDA attention kernels take dh 64 or 128, got {dh}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_mask: torch.Tensor, q_offset: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Launch ``csrc/flash_prefill.cu`` (causal, per-row query offset)."""
    _check_cuda(q, k, v)
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    lib = _build.load("flash_prefill")
    mask = key_mask.float().contiguous()
    off = q_offset.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _build.check(lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        off.data_ptr(), out.data_ptr(), B, H, KH, S, Sk, dh, float(scale),
        _build.stream_ptr(q)), "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch ``csrc/flash_decode.cu`` (mask-only, split over the cache)."""
    _check_cuda(q, k, v)
    B, H, S, dh = q.shape
    KH, C = k.shape[1], k.shape[2]
    lib = _build.load("flash_decode")
    nsplit = max(1, min(-(-C // 64), -(-_TARGET_BLOCKS // (B * KH))))
    per_split = -(-C // nsplit)
    chunk = -(-per_split // 64) * 64          # whole 64-key tiles per split
    nsplit = -(-C // chunk)
    rpad = -(-(H // KH) * S // 16) * 16
    dev = q.device
    part_m = torch.empty((B * KH, nsplit, rpad), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * KH, nsplit, rpad, dh), dtype=torch.float32,
                           device=dev)
    mask = key_mask.float().contiguous()
    out = torch.empty_like(q)
    _build.check(lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, H, KH, S, C, dh, nsplit, chunk, float(scale),
        _build.stream_ptr(q)), "flash_decode")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_attention(
    q: torch.Tensor,            # [B, H, S, dh]
    k: torch.Tensor,            # [B, KH, S, dh] — KH divides H (GQA)
    v: torch.Tensor,            # [B, KH, S, dh]
    key_mask: torch.Tensor,     # [B, S], 1.0 = real token
    *,
    scale: float | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Causal attention without materializing ``[S, S]`` (forward only).
    Query position ``r`` attends to keys ``c <= r`` with ``key_mask[b, c]
    == 1``. Returns ``[B, H, S, dh]`` in q's dtype."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")
    if not causal:
        raise NotImplementedError(
            "non-causal flash_attention: use flash_attention_cached")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    off = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return flash_prefill_cuda(q, k, v, key_mask, off, scale)
    return attention_plain(q, k, v, key_mask, scale, causal=True, q_offset=off)


def flash_attention_cached(
    q: torch.Tensor,            # [B, H, S, dh] — decode-step queries
    k: torch.Tensor,            # [B, KH, C, dh] — one layer of the cache
    v: torch.Tensor,            # [B, KH, C, dh]
    key_mask: torch.Tensor,     # [B, C] — 1.0 = live cache column
    *,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    return_ml: bool = False,
    fresh_k: torch.Tensor | None = None,
    fresh_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mask-only cache attention (``Decoder.decode_step`` visibility: the
    key mask alone says what each lane sees). Returns ``[B, H, S, dh]`` in
    q's dtype. The int8 cache (``k_scale``/``v_scale``), ``return_ml`` and
    the fresh-column fold are not ported yet and raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV cache: ROADMAP Queue B (B5/B6 int8)")
    if return_ml:
        raise NotImplementedError("return_ml: ROADMAP Queue B (B5 variants)")
    if fresh_k is not None or fresh_v is not None:
        raise NotImplementedError(
            "fresh-column fold: ROADMAP Queue B (B5 variants)")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return flash_decode_cuda(q, k, v, key_mask, scale)
    return attention_plain(q, k, v, key_mask, scale, causal=False)
