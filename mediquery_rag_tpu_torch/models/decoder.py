"""Causal decoder LM (port of ``mediquery_rag_tpu/models/decoder.py``).

The qwen2-class architecture of the JAX package (RMSNorm, split-half RoPE,
SwiGLU, GQA attention, optional q/k/v bias) as an ``nn.Module`` over the
JAX parameter layout: per-layer weights stacked ``[L, ...]``, float
matmul weights ``[in, out]``, int8 ones ``{"q": [out, in] i8, "s": [out]
f32}`` (``ops.matvec.quantize_decoder_params``). Batches are LEFT-padded,
so every sequence's last prompt token sits at column S-1 and decode
appends at one shared cursor.

One decode path is ported (the JAX package's scan-xs form): write the
fresh K/V column into the cache IN PLACE, then attend over the whole
cache with the key mask. The stacked/fresh-fold twin exists in JAX only
to dodge ``lax.scan`` copies, which eager PyTorch does not make.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mediquery_rag_tpu_torch.config import DecoderConfig
from mediquery_rag_tpu_torch.ops.attention import (
    attention_plain, flash_attention, flash_attention_cached)
from mediquery_rag_tpu_torch.ops.matvec import quant_matvec, quantize_weight

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
MATVEC_MAX_ROWS = 128      # _mm streams int8 weights up to this many rows


@dataclass
class KVCache:
    """Decode state, updated in place by ``Decoder.decode_step``.
    ``k``/``v``: [L, B, KH, C, dh] in the activation dtype; ``key_mask``:
    [B, C] f32 (1 = column holds a real token); ``cursor``: next write
    column (shared: left padding aligns all sequences); ``next_pos``: [B]
    i32 RoPE position of each sequence's next token."""

    k: torch.Tensor
    v: torch.Tensor
    key_mask: torch.Tensor
    cursor: int
    next_pos: torch.Tensor


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over split halves. x: [B, H, S, dh]; pos: [B, S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos[:, None, :, None].float() * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _split_qkv(qkv: torch.Tensor, B: int, S: int, heads: int, kv_heads: int,
               dh: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, S, (H + 2 KH) dh] -> q [B, H, S, dh], k/v [B, KH, S, dh]."""
    qd, kvd = heads * dh, kv_heads * dh
    q = qkv[..., :qd].reshape(B, S, heads, dh).transpose(1, 2)
    k = qkv[..., qd:qd + kvd].reshape(B, S, kv_heads, dh).transpose(1, 2)
    v = qkv[..., qd + kvd:].reshape(B, S, kv_heads, dh).transpose(1, 2)
    return q.contiguous(), k.contiguous(), v.contiguous()


class QLinear(nn.Module):
    """``x @ W`` for a float ``[.., in, out]`` weight or an int8
    ``(q [.., out, in], s [.., out])`` pair, optionally stacked ``[L, ...]``
    with ``layer`` choosing one. Returns f32 (the JAX ``_mm``): quantized
    weights stream through the int8 matvec for up to 128 rows (decode);
    more rows (prefill) dequantize into a plain product."""

    def __init__(self, weight: torch.Tensor | dict):
        super().__init__()
        self.quantized = isinstance(weight, dict)
        if self.quantized:
            self.register_buffer("q", weight["q"])
            self.register_buffer("s", weight["s"])
        else:
            self.register_buffer("weight", weight)

    def forward(self, x: torch.Tensor, adt: torch.dtype,
                layer: int | None = None) -> torch.Tensor:
        if not self.quantized:
            w = self.weight if layer is None else self.weight[layer]
            return (x.to(adt) @ w.to(adt)).float()
        rows = x.numel() // x.shape[-1]
        if rows <= MATVEC_MAX_ROWS:
            out = quant_matvec(x.reshape(rows, x.shape[-1]), self.q, self.s,
                               layer=layer)
            return out.reshape(*x.shape[:-1], out.shape[-1])
        q, s = (self.q, self.s) if layer is None else (self.q[layer], self.s[layer])
        wd = q.to(adt) * s[:, None].to(adt)
        return (x.to(adt) @ wd.T).float()


class Decoder(nn.Module):
    """Causal LM over a JAX-layout parameter tree (torch tensors)."""

    def __init__(self, cfg: DecoderConfig, params: dict):
        super().__init__()
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")
        if (cfg.hidden // cfg.heads) % 2:
            raise ValueError("head dim must be even for RoPE")
        kvh = cfg.kv_heads or cfg.heads
        if cfg.heads % kvh:
            raise ValueError(f"heads {cfg.heads} % kv_heads {kvh} != 0")
        if cfg.kv_dtype != "":
            raise NotImplementedError(
                f"kv_dtype={cfg.kv_dtype!r}: the int8 KV cache is a ROADMAP "
                "Queue B item of the port")
        if cfg.attn_impl not in ("einsum", "flash"):
            raise ValueError(
                f"attn_impl must be 'einsum' or 'flash', got {cfg.attn_impl!r}")
        self.cfg = cfg
        self.kv_heads = kvh
        self.dh = cfg.hidden // cfg.heads
        self.adt = _DTYPES[cfg.dtype]
        blocks = params["blocks"]
        self.register_buffer("tok_embed", params["tok_embed"])
        self.register_buffer("rms_f", params["rms_f"])
        self.register_buffer("rms1", blocks["rms1"])
        self.register_buffer("rms2", blocks["rms2"])
        self.register_buffer("qkv_b", blocks.get("qkv_b"))
        self.qkv = QLinear(blocks["qkv"])
        self.attn_out = QLinear(blocks["attn_out"])
        self.w_down = QLinear(blocks["w_down"])
        if "w_gateup" in blocks:
            self.w_gateup = QLinear(blocks["w_gateup"])
        else:
            self.w_gate = QLinear(blocks["w_gate"])
            self.w_up = QLinear(blocks["w_up"])
        self.lm_head = QLinear(params["lm_head"])

    # -- layer pieces --------------------------------------------------------

    def _qkv(self, x: torch.Tensor, layer: int, pos: torch.Tensor):
        c, adt = self.cfg, self.adt
        B, S, _ = x.shape
        h = _rmsnorm(x, self.rms1[layer], c.rms_eps)
        qkv = self.qkv(h, adt, layer)
        if self.qkv_b is not None:
            qkv = qkv + self.qkv_b[layer].float()
        q, k, v = _split_qkv(qkv.to(adt), B, S, c.heads, self.kv_heads, self.dh)
        return _rope(q, pos, c.rope_theta), _rope(k, pos, c.rope_theta), v

    def _finish_layer(self, x: torch.Tensor, ctx: torch.Tensor,
                      layer: int) -> torch.Tensor:
        """Attention output projection + residual, then the SwiGLU MLP."""
        c, adt = self.cfg, self.adt
        B, _, S, _ = ctx.shape
        ctx = ctx.to(adt).transpose(1, 2).reshape(B, S, c.hidden)
        x = x + self.attn_out(ctx, adt, layer).to(adt)
        h = _rmsnorm(x, self.rms2[layer], c.rms_eps)
        if hasattr(self, "w_gateup"):
            gate, up = self.w_gateup(h, adt, layer).chunk(2, dim=-1)
        else:
            gate, up = self.w_gate(h, adt, layer), self.w_up(h, adt, layer)
        ff = (F.silu(gate) * up).to(adt)
        return x + self.w_down(ff, adt, layer).to(adt)

    def _logits(self, x_last: torch.Tensor) -> torch.Tensor:
        return self.lm_head(_rmsnorm(x_last, self.rms_f, self.cfg.rms_eps),
                            self.adt)

    # -- serving -------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, ids: torch.Tensor, mask: torch.Tensor,
                cache_len: int) -> tuple[torch.Tensor, KVCache]:
        """Process the LEFT-padded prompt batch (ids [B, S] int, mask [B, S]
        f32) and allocate the cache. Returns (last-token logits [B, V] f32,
        cache)."""
        c, adt = self.cfg, self.adt
        B, S = ids.shape
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        dev = self.tok_embed.device
        ids, mask = ids.to(dev).long(), mask.to(dev).float()
        pos = torch.clamp(torch.cumsum(mask, 1).to(torch.int32) - 1, min=0)
        shape = (c.layers, B, self.kv_heads, cache_len, self.dh)
        kc = torch.zeros(shape, dtype=adt, device=dev)
        vc = torch.zeros(shape, dtype=adt, device=dev)
        scale = self.dh ** -0.5
        x = self.tok_embed[ids].to(adt)
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, pos)
            if c.attn_impl == "flash":
                ctx = flash_attention(q, k, v, mask, scale=scale)
            else:
                ctx = attention_plain(q, k, v, mask, scale, causal=True)
            kc[li, :, :, :S] = k
            vc[li, :, :, :S] = v
            x = self._finish_layer(x, ctx, li)
        key_mask = torch.zeros((B, cache_len), dtype=torch.float32, device=dev)
        key_mask[:, :S] = mask
        cache = KVCache(k=kc, v=vc, key_mask=key_mask, cursor=S,
                        next_pos=torch.cumsum(mask, 1)[:, -1].to(torch.int32))
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: KVCache, token: torch.Tensor) -> torch.Tensor:
        """Append ``token`` ([B] int) at ``cache.cursor`` and return the
        next-token logits [B, V] f32. Updates ``cache`` IN PLACE: the fresh
        K/V column and key-mask column are written into the preallocated
        tensors, then cursor and positions advance."""
        c, adt = self.cfg, self.adt
        col = cache.cursor
        if col >= cache.k.shape[3]:
            raise ValueError(f"cache full ({cache.k.shape[3]} columns)")
        cache.key_mask[:, col] = 1.0
        pos = cache.next_pos[:, None]
        scale = self.dh ** -0.5
        x = self.tok_embed[token.to(self.tok_embed.device).long()[:, None]].to(adt)
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, pos)
            cache.k[li, :, :, col] = k[:, :, 0]
            cache.v[li, :, :, col] = v[:, :, 0]
            if c.attn_impl == "flash":
                ctx = flash_attention_cached(q, cache.k[li], cache.v[li],
                                             cache.key_mask, scale=scale)
            else:
                ctx = attention_plain(q, cache.k[li], cache.v[li],
                                      cache.key_mask, scale, causal=False)
            x = self._finish_layer(x, ctx, li)
        cache.cursor = col + 1
        cache.next_pos += 1
        return self._logits(x[:, 0])


def init_params(cfg: DecoderConfig, *, seed: int = 0,
                device: str | torch.device = "cuda", bits: int | None = None) -> dict:
    """Random parameters in the JAX layout, drawn from ``torch.Generator``
    seeded with ``seed`` (the JAX init's distributions: N(0, 1/fan_in)
    matmuls, N(0, 0.02^2) embeddings, unit norms, zero biases; not its
    numbers). ``bits=8`` quantizes layer by layer as it draws (gate|up
    fused), so a 7B-class model never holds its float weights at once."""
    if bits not in (None, 8):
        raise NotImplementedError(f"bits={bits}: only int8 is ported")
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, Fd = cfg.layers, cfg.hidden, cfg.mlp_dim
    kvh = cfg.kv_heads or cfg.heads
    dh = D // cfg.heads
    qkv_out = (cfg.heads + 2 * kvh) * dh
    pdt = _DTYPES[cfg.param_dtype]

    def dense(fan_in, shape):
        return torch.randn(shape, generator=gen, device=device) * fan_in ** -0.5

    def stack(fan_in, in_out, fuse=False):
        layers = []
        for _ in range(L):
            w = (torch.cat([dense(fan_in, in_out), dense(fan_in, in_out)], -1)
                 if fuse else dense(fan_in, in_out))
            layers.append(quantize_weight(w) if bits else w.to(pdt))
        if bits:
            return {"q": torch.stack([p[0] for p in layers]),
                    "s": torch.stack([p[1] for p in layers])}
        return torch.stack(layers)

    blocks = {
        "rms1": torch.ones((L, D), dtype=pdt, device=device),
        "rms2": torch.ones((L, D), dtype=pdt, device=device),
        "qkv": stack(D, (D, qkv_out)),
        "attn_out": stack(D, (D, D)),
        "w_down": stack(Fd, (Fd, D)),
    }
    if bits:
        blocks["w_gateup"] = stack(D, (D, Fd), fuse=True)
    else:
        blocks["w_gate"] = stack(D, (D, Fd))
        blocks["w_up"] = stack(D, (D, Fd))
    if cfg.qkv_bias:
        blocks["qkv_b"] = torch.zeros((L, qkv_out), dtype=pdt, device=device)
    head = dense(D, (D, cfg.vocab_size))
    if bits:
        q, s = quantize_weight(head)
        head = {"q": q, "s": s}
    else:
        head = head.to(pdt)
    return {
        "tok_embed": (torch.randn((cfg.vocab_size, D), generator=gen,
                                  device=device) * 0.02).to(pdt),
        "blocks": blocks,
        "rms_f": torch.ones((D,), dtype=pdt, device=device),
        "lm_head": head,
    }
