"""Causal decoder LM (port of ``mediquery_rag_tpu/models/decoder.py``).

The qwen2-class architecture of the JAX package (RMSNorm, split-half RoPE,
SwiGLU, GQA attention, optional q/k/v bias) as an ``nn.Module`` over the
JAX parameter layout: per-layer weights stacked ``[L, ...]``, float
matmul weights ``[in, out]``, int8 ones ``{"q": [out, in] i8, "s": [out]
f32}`` and int4 ones ``{"q4": [out/2, in] i8, "s": [2, out/2] f32, "t":
[1, in] f32}`` (``ops.matvec.quantize_decoder_params``). With
``kv_dtype="int8"`` the cache holds int8 codes and per-column-per-head
absmax scales, quantized when written (after RoPE).

Two decode paths, as in the JAX package:

- ``decode_step`` (lockstep generation, LEFT-padded batches sharing one
  cursor): write the fresh K/V column into the cache IN PLACE, then attend
  over the whole cache with the key mask.
- ``decode_step_slots`` (continuous batching, one cursor per lane): JAX's
  stacked form, the one it runs at every serving-size cache. Each layer
  attends over the cache with the step's fresh column folded into the
  softmax and gated by ``active``, then writes the (quantized) column at
  the lane's cursor; the key mask and cursors advance for active lanes.

``prefill_extend`` prefills a right-padded suffix into one lane at
``col0`` (chunked prefill, chat-session prefix reuse, and with
``all_logits`` the verify pass of ``models/speculative.py``).
``extend_slots`` feeds G tokens to every lane at its own cursor (the
propose and verify passes of speculative serving): the cache part through
``flash_attention_cached(return_ml=True)``, the G x G fresh block in f32
beside it, joined by the (o, m, l) combine.

With ``attn_impl="einsum"`` every cached attention takes JAX's einsum
route instead (its ``_*_xs`` methods): the fresh columns are written and
made live first, then the queries attend over the whole cache in plain
PyTorch (``attention_plain``, ``attention_plain_int8`` for an int8 cache).

``apply`` is the full causal training forward (JAX ``Decoder.apply``):
einsum attention with JAX's bias, or ``flash_attention`` (B6 forward, B10a
and B10b backward), with per-block recompute (``remat``) through
``torch.utils.checkpoint``. Gradients reach the float params the module was
built on, which stay the caller's leaf tensors.

Over a training mesh (``Decoder(cfg, params, mesh=)``, ``parallel/dist.py``)
``apply`` runs on this rank's shard of the params in Megatron's layout
(``partition_specs``, JAX's axes): qkv (and its bias) column-parallel by
heads, each rank holding its ``heads / tp`` query heads and the KV heads
they read, so B6/B10a/B10b run on the local heads; attn_out and w_down
row-parallel, their f32 outputs all-reduced over "model"; w_gate/w_up
column-parallel; lm_head vocab-sharded, its logits gathered. JAX splits
the fused qkv columns evenly instead, which does not follow heads:
``decoder_layout`` shards and gathers JAX's fused order.

Every serving method runs over such a shard too (generation over a
tensor-parallel mesh): the cache holds the rank's KV heads, B5/B6 attend
over its local heads, and every rank computes the same gathered logits. A
quantized tree is quantized whole and then cut (``parallel.dist.Layout``;
int8 ``w_gateup`` as ``[gate_r | up_r]``), and the row-parallel matvecs
(attn_out, w_down) take each row's activation absmax over the whole input
dim (``ops.matvec``'s ``group``), so their int8 codes are the single-device
codes of the rank's slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from mediquery_rag_tpu_torch.config import DecoderConfig
from mediquery_rag_tpu_torch.ops.attention import (
    attention_plain, attention_plain_int8, flash_attention, flash_attention_at,
    flash_attention_cached)
from mediquery_rag_tpu_torch.ops.matmul import mm_f32
from mediquery_rag_tpu_torch.ops.matvec import (
    dequantize_weight_int4, quant_matvec, quant_matvec_int4, quantize_weight,
    quantize_weight_int4)
from mediquery_rag_tpu_torch.ops.quant import absmax_scale
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import Layout, contiguous_parts, head_parts

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
MATVEC_MAX_ROWS = 128      # _mm streams quantized weights up to this many rows
REMAT_MODES = (False, True, "dots", "names")


def _remat_policy(save_flash: bool):
    """Selective-checkpoint policy: keep the 2-D matmul outputs (the block's
    projections; JAX ``dots_with_no_batch_dims_saveable``) and, when
    ``save_flash``, the flash forward's output; recompute the rest."""
    keep = {torch.ops.aten.mm.default, torch.ops.aten.mm.dtype}
    if save_flash:
        keep.add(torch.ops.mediquery_torch.flash_attention.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


@dataclass
class KVCache:
    """Decode state, updated in place by the ``Decoder`` step methods.
    ``k``/``v``: [L, B, KH, C, dh] in the activation dtype, or int8 codes
    with ``k_scale``/``v_scale`` [L, B, KH, C] f32; ``key_mask``: [B, C]
    f32 (1 = column holds a real token); ``cursor``: next write column,
    an int shared by a left-padded batch (``decode_step``) or a [B] int64
    tensor, one per lane (``decode_step_slots``); ``next_pos``: [B] i32
    RoPE position of each sequence's next token."""

    k: torch.Tensor
    v: torch.Tensor
    key_mask: torch.Tensor
    cursor: int | torch.Tensor
    next_pos: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., dh] float -> (int8 codes, f32 scales [...]): absmax/127 per
    cache column and KV head, with a 1e-6 floor (no clip needed)."""
    xf = x.float()
    s = absmax_scale(xf, 127, floor=1e-6)
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rope_tables(pos: torch.Tensor, dh: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of the split-half rotary angles for positions ``pos`` [B, S]:
    [B, 1, S, dh/2] f32 each. Positions are the same in every layer, so a
    forward computes them once."""
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    ang = pos[:, None, :, None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def _rope(x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotary embedding over split halves. x: [B, H, S, dh]."""
    cos, sin = rope
    half = x.shape[-1] // 2
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
    """``x @ W`` for a float ``[.., in, out]`` weight, an int8 ``{"q", "s"}``
    or an int4 ``{"q4", "s", "t"}`` tree, optionally stacked ``[L, ...]``
    with ``layer`` choosing one. Returns f32 (the JAX ``_mm``): quantized
    weights stream through their matvec for up to 128 rows (decode); more
    rows (prefill) dequantize into a plain product. Float products keep
    JAX's f32 sum of ``adt`` operands (``ops.matmul.mm_f32``). ``group``:
    the model group of a row-parallel layer's shard, whose matvecs take the
    activation scales over every rank's slice of the input dim (a MAX
    all-reduce of each row's absmax)."""

    def __init__(self, weight: torch.Tensor | dict, group=None):
        super().__init__()
        self.row_max = None if group is None else functools.partial(cc.all_reduce_max,
                                                                    group=group)
        if isinstance(weight, dict):
            self.form = "int4" if "q4" in weight else "int8"
            for name, t in weight.items():
                self.register_buffer(name, t)
        else:
            self.form = "float"
            self.register_buffer("weight", weight)

    def _int4(self, layer: int | None) -> dict:
        wq = {"q4": self.q4, "s": self.s, "t": self.t}
        return wq if layer is None else {k: t[layer] for k, t in wq.items()}

    def forward(self, x: torch.Tensor, adt: torch.dtype, layer: int | None = None,
                weight: torch.Tensor | None = None) -> torch.Tensor:
        """``weight``: the float layer's own tensor, in place of indexing
        the stacked one (``Decoder.apply``)."""
        if self.form == "float":
            w = weight if weight is not None else (
                self.weight if layer is None else self.weight[layer])
            return mm_f32(x, w, adt)
        rows = x.numel() // x.shape[-1]
        if rows <= MATVEC_MAX_ROWS:
            x2 = x.reshape(rows, x.shape[-1])
            out = (quant_matvec_int4(x2, self._int4(None), layer=layer, row_max=self.row_max)
                   if self.form == "int4"
                   else quant_matvec(x2, self.q, self.s, layer=layer, row_max=self.row_max))
            return out.reshape(*x.shape[:-1], out.shape[-1])
        if self.form == "int4":
            wd = dequantize_weight_int4(self._int4(layer), adt)
        else:
            q, s = (self.q, self.s) if layer is None else (self.q[layer], self.s[layer])
            wd = q.to(adt) * s[:, None].to(adt)
        # JAX keeps this product's f32 sum; the port still rounds it to adt
        # (ROADMAP Queue C 7): with the f32 sum, the speculative self-draft of
        # chip_smoke.py 5c accepted fewer proposals (3.942 tokens a lane round
        # against its floor of 4.0)
        return (x.to(adt) @ wd.T).float()


def partition_specs(cfg: DecoderConfig) -> dict:
    """Megatron's layout over mesh axes ("data", "model"): JAX's
    ``Decoder.partition_specs``, each spec a tuple of axis names."""
    blocks = {
        "rms1": (None, None),
        "qkv": (None, None, "model"),       # column parallel
        "attn_out": (None, "model", None),  # row parallel
        "rms2": (None, None),
        "w_gate": (None, None, "model"),    # column parallel
        "w_up": (None, None, "model"),      # column parallel
        "w_down": (None, "model", None),    # row parallel
    }
    if cfg.qkv_bias:
        blocks["qkv_b"] = (None, "model")   # follows qkv columns
    return {"tok_embed": (None, None), "blocks": blocks, "rms_f": (None,),
            "lm_head": (None, "model")}     # vocab-sharded logits


def decoder_layout(cfg: DecoderConfig, params: dict, mesh) -> Layout:
    """This rank's layout of a full float parameter tree: qkv's columns
    (and its bias) by heads (``parallel.dist.head_parts``), every other
    sharded dim in contiguous runs."""
    parts, specs = {}, partition_specs(cfg)
    if mesh is not None and mesh.tp > 1:
        cols = head_parts(cfg.heads, cfg.kv_heads or cfg.heads, cfg.hidden // cfg.heads,
                          mesh.tp)
        parts = {("blocks", "qkv"): cols, ("blocks", "qkv_b"): cols}
        if "w_gateup" in params["blocks"]:
            # int8's fused [gate | up] out axis: rank r holds [gate_r | up_r], so
            # the product's chunk(2) still splits gate from up
            parts[("blocks", "w_gateup")] = [torch.cat([p, cfg.mlp_dim + p])
                                             for p in contiguous_parts(cfg.mlp_dim, mesh.tp)]
            specs["blocks"]["w_gateup"] = specs["blocks"]["w_gate"]
    return Layout(params, specs, mesh, parts)


class Decoder(nn.Module):
    """Causal LM over a JAX-layout parameter tree (torch tensors); with a
    ``mesh`` of model axis > 1, over this rank's shard of it
    (``decoder_layout(cfg, full, mesh).shard(full)``, float or quantized)."""

    def __init__(self, cfg: DecoderConfig, params: dict, mesh=None):
        super().__init__()
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")
        if (cfg.hidden // cfg.heads) % 2:
            raise ValueError("head dim must be even for RoPE")
        kvh = cfg.kv_heads or cfg.heads
        if cfg.heads % kvh:
            raise ValueError(f"heads {cfg.heads} % kv_heads {kvh} != 0")
        if cfg.kv_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_dtype must be '' or 'int8', got {cfg.kv_dtype!r}")
        if cfg.attn_impl not in ("einsum", "flash"):
            raise ValueError(
                f"attn_impl must be 'einsum' or 'flash', got {cfg.attn_impl!r}")
        self.cfg = cfg
        self.quant_kv = cfg.kv_dtype == "int8"
        self.kv_heads = kvh
        self.dh = cfg.hidden // cfg.heads
        self.heads = cfg.heads
        self.tp = None if mesh is None else mesh.model_group
        if self.tp is not None:       # this rank's heads (dist.head_parts)
            self.heads = cfg.heads // mesh.tp
            self.kv_heads = max(kvh // mesh.tp, 1)
        self.adt = _DTYPES[cfg.dtype]
        blocks = params["blocks"]
        self.register_buffer("tok_embed", params["tok_embed"])
        self.register_buffer("rms_f", params["rms_f"])
        self.register_buffer("rms1", blocks["rms1"])
        self.register_buffer("rms2", blocks["rms2"])
        self.register_buffer("qkv_b", blocks.get("qkv_b"))
        self.qkv = QLinear(blocks["qkv"])
        self.attn_out = QLinear(blocks["attn_out"], self.tp)    # row parallel
        self.w_down = QLinear(blocks["w_down"], self.tp)
        if "w_gateup" in blocks:
            self.w_gateup = QLinear(blocks["w_gateup"])
        else:
            self.w_gate = QLinear(blocks["w_gate"])
            self.w_up = QLinear(blocks["w_up"])
        self.lm_head = QLinear(params["lm_head"])

    def partition_specs(self) -> dict:
        return partition_specs(self.cfg)

    # -- layer pieces --------------------------------------------------------

    def _param(self, name: str, layer: int, lw: dict | None) -> torch.Tensor:
        """Layer ``layer`` of a stacked tensor, or its entry of ``lw``."""
        return getattr(self, name)[layer] if lw is None else lw[name]

    def _mm(self, name: str, x: torch.Tensor, layer: int, lw: dict | None) -> torch.Tensor:
        return getattr(self, name)(x, self.adt, layer, None if lw is None else lw[name])

    def _qkv(self, x: torch.Tensor, layer: int, rope: tuple, lw: dict | None = None):
        """``lw``: the layer's float tensors (``apply``), else indexed."""
        c, adt = self.cfg, self.adt
        B, S, _ = x.shape
        h = cc.copy_to_model(_rmsnorm(x, self._param("rms1", layer, lw), c.rms_eps), self.tp)
        qkv = self._mm("qkv", h, layer, lw)
        if self.qkv_b is not None:
            qkv = qkv + self._param("qkv_b", layer, lw).float()
        q, k, v = _split_qkv(qkv.to(adt), B, S, self.heads, self.kv_heads, self.dh)
        return _rope(q, rope), _rope(k, rope), v

    def _finish_layer(self, x: torch.Tensor, ctx: torch.Tensor, layer: int,
                      lw: dict | None = None) -> torch.Tensor:
        """Attention output projection + residual, then the SwiGLU MLP."""
        c, adt = self.cfg, self.adt
        B, H, S, dh = ctx.shape
        ctx = ctx.to(adt).transpose(1, 2).reshape(B, S, H * dh)
        x = x + cc.reduce_from_model(self._mm("attn_out", ctx, layer, lw), self.tp).to(adt)
        h = cc.copy_to_model(_rmsnorm(x, self._param("rms2", layer, lw), c.rms_eps), self.tp)
        if hasattr(self, "w_gateup"):
            gate, up = self._mm("w_gateup", h, layer, lw).chunk(2, dim=-1)
        else:
            gate, up = self._mm("w_gate", h, layer, lw), self._mm("w_up", h, layer, lw)
        ff = (F.silu(gate) * up).to(adt)
        return x + cc.reduce_from_model(self._mm("w_down", ff, layer, lw), self.tp).to(adt)

    def _logits(self, x_last: torch.Tensor) -> torch.Tensor:
        h = cc.copy_to_model(_rmsnorm(x_last, self.rms_f, self.cfg.rms_eps), self.tp)
        return cc.gather_from_model(self.lm_head(h, self.adt), self.tp)

    # -- training forward ----------------------------------------------------

    def _block(self, x: torch.Tensor, lw: dict, rope: tuple,
               mask: torch.Tensor) -> torch.Tensor:
        """One transformer block of ``apply`` (JAX ``_block_kv``) over the
        layer's tensors ``lw``; the einsum path is JAX's ``_attend`` with
        its causal and key-mask bias."""
        q, k, v = self._qkv(x, 0, rope, lw)
        if self.cfg.attn_impl == "flash":
            ctx = flash_attention(q, k, v, mask, scale=self.dh ** -0.5)
        else:
            ctx = attention_plain(q, k, v, mask, self.dh ** -0.5, causal=True)
        return self._finish_layer(x, ctx, 0, lw)

    def apply(self, ids: torch.Tensor, mask: torch.Tensor, *,
              remat: bool | str = False) -> torch.Tensor:
        """Full causal forward over ``ids`` [B, S] with ``mask`` [B, S] (1 =
        real token; left or right padding). Returns logits [B, S, V] f32.

        ``remat``: False saves every block activation; True recomputes each
        block in the backward (``torch.utils.checkpoint``, non-reentrant);
        ``"dots"`` keeps the matmul outputs and recomputes the rest;
        ``"names"`` also keeps the flash forward's output, so neither a
        matmul nor the B6 kernel runs twice (in a bfloat16 model the kept
        matmul outputs are the bf16 ``lm_qkv/lm_attn/lm_gate/lm_up`` JAX
        names, the flash output is ``lm_ctx``; SwiGLU's elementwise product
        is recomputed). Per step B6 launches once per layer for False and
        ``"names"``, twice for True and ``"dots"``. Quantized params raise."""
        c, adt = self.cfg, self.adt
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        if any(m.form != "float" for m in self.modules() if isinstance(m, QLinear)):
            raise ValueError("apply() trains float params; quantized weights are "
                             "for serving (load the float checkpoint)")
        dev = self.tok_embed.device
        ids, mask = ids.to(dev).long(), mask.to(dev).float()
        pos = torch.clamp(torch.cumsum(mask, 1).to(torch.int32) - 1, min=0)
        rope = _rope_tables(pos, self.dh, c.rope_theta)
        # one unbind per stacked tensor: its backward stacks the layers'
        # gradients once, where indexing would add a full-size gradient per layer
        stacked = {name: getattr(self, name) for name in ("rms1", "rms2", "qkv_b")
                   if getattr(self, name) is not None}
        stacked.update((name, m.weight) for name, m in self.named_children()
                       if isinstance(m, QLinear) and name != "lm_head")
        layers = [dict(zip(stacked, parts))
                  for parts in zip(*(t.unbind(0) for t in stacked.values()))]
        x = self.tok_embed[ids].to(adt)
        for lw in layers:
            block = functools.partial(self._block, lw=lw, rope=rope, mask=mask)
            if remat is False:
                x = block(x)
            elif remat is True:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                policy = _remat_policy(save_flash=remat == "names")
                x = checkpoint(block, x, use_reentrant=False, context_fn=functools.partial(
                    create_selective_checkpoint_contexts, policy))
        return self._logits(x)

    # -- serving -------------------------------------------------------------

    def _new_cache(self, B: int, C: int, dev) -> tuple:
        """Zeroed K/V (and scale) tensors for ``B`` lanes of ``C`` columns
        (this rank's KV heads)."""
        c = self.cfg
        shape = (c.layers, B, self.kv_heads, C, self.dh)
        cdt = torch.int8 if self.quant_kv else self.adt
        kc = torch.zeros(shape, dtype=cdt, device=dev)
        vc = torch.zeros(shape, dtype=cdt, device=dev)
        if not self.quant_kv:
            return kc, vc, None, None
        return (kc, vc, torch.zeros(shape[:-1], device=dev),
                torch.zeros(shape[:-1], device=dev))

    def empty_cache(self, B: int, C: int) -> KVCache:
        """An empty per-lane cache (``decode_step_slots``): no live column,
        cursors and positions 0."""
        dev = self.tok_embed.device
        kc, vc, ks, vs = self._new_cache(B, C, dev)
        return KVCache(k=kc, v=vc, key_mask=torch.zeros((B, C), device=dev),
                       cursor=torch.zeros(B, dtype=torch.int64, device=dev),
                       next_pos=torch.zeros(B, dtype=torch.int32, device=dev),
                       k_scale=ks, v_scale=vs)

    def _cached_ctx(self, q, cache: KVCache, li: int, key_mask, **fresh):
        """Layer ``li``'s attention of ``q`` over the cache, mask-only: the
        kernels, or with ``attn_impl="einsum"`` (no fresh fold) JAX's
        einsum route."""
        if self.cfg.attn_impl == "einsum" and not fresh:
            return self._einsum_ctx(q, cache.k[li], cache.v[li], key_mask,
                                    *self._layer_scales(cache, li))
        scales = ({} if cache.k_scale is None else
                  {"k_scale": cache.k_scale[li], "v_scale": cache.v_scale[li]})
        return flash_attention_cached(q, cache.k[li], cache.v[li], key_mask,
                                      scale=self.dh ** -0.5, **scales, **fresh)

    @staticmethod
    def _layer_scales(cache: KVCache, li: int) -> tuple:
        return (None, None) if cache.k_scale is None else (cache.k_scale[li],
                                                           cache.v_scale[li])

    def _einsum_ctx(self, q, k, v, key_mask, k_scale=None, v_scale=None, q_offset=None):
        """JAX's einsum route (``_cached_attn`` without the kernel) over a
        cache layer whose fresh columns are already written and live;
        ``q_offset`` adds the causal term ``col <= q_offset[b] + row``."""
        kw = {"causal": q_offset is not None, "q_offset": q_offset}
        if k_scale is None:
            return attention_plain(q, k, v, key_mask, self.dh ** -0.5, **kw)
        return attention_plain_int8(q, k, v, k_scale, v_scale, key_mask, self.dh ** -0.5, **kw)

    @torch.no_grad()
    def prefill(self, ids: torch.Tensor, mask: torch.Tensor,
                cache_len: int) -> tuple[torch.Tensor, KVCache]:
        """Process the LEFT-padded prompt batch (ids [B, S] int, mask [B, S]
        f32) and allocate the cache. Returns (last-token logits [B, V] f32,
        cache). Attention within the prompt runs at full precision; an int8
        cache quantizes only what it stores."""
        c, adt = self.cfg, self.adt
        B, S = ids.shape
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        dev = self.tok_embed.device
        ids, mask = ids.to(dev).long(), mask.to(dev).float()
        rope = _rope_tables(torch.clamp(torch.cumsum(mask, 1).to(torch.int32) - 1, min=0),
                            self.dh, c.rope_theta)
        kc, vc, ksc, vsc = self._new_cache(B, cache_len, dev)
        scale = self.dh ** -0.5
        x = self.tok_embed[ids].to(adt)
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, rope)
            if c.attn_impl == "flash":
                ctx = flash_attention(q, k, v, mask, scale=scale)
            else:
                ctx = attention_plain(q, k, v, mask, scale, causal=True)
            if self.quant_kv:
                (kc[li, :, :, :S], ksc[li, :, :, :S]) = _kv_quantize(k)
                (vc[li, :, :, :S], vsc[li, :, :, :S]) = _kv_quantize(v)
            else:
                kc[li, :, :, :S] = k
                vc[li, :, :, :S] = v
            x = self._finish_layer(x, ctx, li)
        key_mask = torch.zeros((B, cache_len), dtype=torch.float32, device=dev)
        key_mask[:, :S] = mask
        cache = KVCache(k=kc, v=vc, key_mask=key_mask, cursor=S,
                        next_pos=torch.cumsum(mask, 1)[:, -1].to(torch.int32),
                        k_scale=ksc, v_scale=vsc)
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: KVCache, token: torch.Tensor) -> torch.Tensor:
        """Append ``token`` ([B] int) at ``cache.cursor`` and return the
        next-token logits [B, V] f32. Updates ``cache`` IN PLACE: the fresh
        K/V column (quantized for an int8 cache) and key-mask column are
        written into the preallocated tensors, then the layer attends over
        the cache; cursor and positions advance."""
        c, adt = self.cfg, self.adt
        col = cache.cursor
        if col >= cache.k.shape[3]:
            raise ValueError(f"cache full ({cache.k.shape[3]} columns)")
        cache.key_mask[:, col] = 1.0
        rope = _rope_tables(cache.next_pos[:, None], self.dh, c.rope_theta)
        x = self.tok_embed[token.to(self.tok_embed.device).long()[:, None]].to(adt)
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, rope)
            if self.quant_kv:
                k, cache.k_scale[li, :, :, col] = _kv_quantize(k[:, :, 0])
                v, cache.v_scale[li, :, :, col] = _kv_quantize(v[:, :, 0])
                cache.k[li, :, :, col] = k
                cache.v[li, :, :, col] = v
            else:
                cache.k[li, :, :, col] = k[:, :, 0]
                cache.v[li, :, :, col] = v[:, :, 0]
            ctx = self._cached_ctx(q, cache, li, cache.key_mask)
            x = self._finish_layer(x, ctx, li)
        cache.cursor = col + 1
        cache.next_pos += 1
        return self._logits(x[:, 0])

    @torch.no_grad()
    def decode_step_slots(self, cache: KVCache, token: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
        """One step for every lane at its own cursor (``cache.cursor`` [B]),
        the continuous-batching primitive; returns logits [B, V] f32 and
        updates ``cache`` IN PLACE. Per layer: attend over the cache with
        the fresh column folded in, its term gated by ``active`` ([B] bool:
        an inactive lane attends over its cache alone), then write the
        column (quantized for an int8 cache) at ``cursor[b]``. Inactive
        lanes write too (their key mask stays 0, so nothing sees it). Then
        ``key_mask[b, cursor[b]] = max(.., active)``, and cursor and
        position advance for active lanes (the cursor stops at C-1)."""
        c, adt = self.cfg, self.adt
        C = cache.k.shape[3]
        dev = cache.k.device
        rows = torch.arange(cache.k.shape[1], device=dev)
        cur = cache.cursor
        act = active.to(dev).bool()
        gate = act.float()
        rope = _rope_tables(cache.next_pos[:, None], self.dh, c.rope_theta)
        x = self.tok_embed[token.to(dev).long()[:, None]].to(adt)
        einsum = c.attn_impl == "einsum"
        if einsum:      # JAX's xs route: the column turns live before the layers
            cache.key_mask[rows, cur] = torch.maximum(cache.key_mask[rows, cur], gate)
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, rope)
            if self.quant_kv:
                kc, ksc = _kv_quantize(k)
                vc, vsc = _kv_quantize(v)
                # the fold uses the DEQUANTIZED column, the numbers later
                # steps read back from the cache
                k_new = (kc.float() * ksc[..., None]).to(adt)
                v_new = (vc.float() * vsc[..., None]).to(adt)
            else:
                kc, vc = k.to(cache.k.dtype), v.to(cache.v.dtype)
                k_new, v_new = kc.to(adt), vc.to(adt)
            if not einsum:
                ctx = self._cached_ctx(q, cache, li, cache.key_mask, fresh_k=k_new,
                                       fresh_v=v_new, fresh_gate=gate)
            cache.k[li][rows, :, cur] = kc[:, :, 0]
            cache.v[li][rows, :, cur] = vc[:, :, 0]
            if self.quant_kv:
                cache.k_scale[li][rows, :, cur] = ksc[:, :, 0]
                cache.v_scale[li][rows, :, cur] = vsc[:, :, 0]
            if einsum:
                ctx = self._cached_ctx(q, cache, li, cache.key_mask)
            x = self._finish_layer(x, ctx, li)
        cache.key_mask[rows, cur] = torch.maximum(cache.key_mask[rows, cur], gate)
        cache.cursor = torch.clamp(cur + act.to(cur.dtype), max=C - 1)
        cache.next_pos += act.to(cache.next_pos.dtype)
        return self._logits(x[:, 0])

    @torch.no_grad()
    def prefill_extend(self, k_row: torch.Tensor, v_row: torch.Tensor,
                       key_mask_row: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor, col0: int | torch.Tensor,
                       pos0: int | torch.Tensor, all_logits: bool = False,
                       k_scale_row: torch.Tensor | None = None,
                       v_scale_row: torch.Tensor | None = None) -> tuple:
        """Prefill a continuation into ONE lane's cache rows (``k_row``/
        ``v_row`` [L, KH, C, dh], ``key_mask_row`` [C], scale rows [L, KH,
        C] for an int8 cache; views into a batched cache are updated IN
        PLACE). Columns at/after ``col0`` are first masked dead (a rollback
        point), then the RIGHT-padded suffix ``ids`` [S] (``mask`` [S])
        lands at columns ``col0 ..`` with RoPE positions from ``pos0``; its
        queries see the live prefix and themselves causally
        (``flash_attention_at``). ``col0``/``pos0`` may be 0-dim tensors on
        the cache's device (the speculative loop keeps its cursor there and
        never reads it back); an int ``col0`` is checked against the cache
        end. Returns (last real token's logits [V], or with ``all_logits``
        one distribution per fed token [S, V]; k_row, v_row, key_mask_row,
        k_scale_row, v_scale_row)."""
        c, adt = self.cfg, self.adt
        dev = k_row.device
        ids, mask = ids.to(dev).long(), mask.to(dev).float()
        S = ids.shape[0]
        C = k_row.shape[2]
        if isinstance(col0, int) and col0 + S > C:
            raise ValueError(f"extension of {S} at column {col0} passes the cache end {C}")
        col = torch.as_tensor(col0, device=dev).long().reshape(1)
        cols = col + torch.arange(S, device=dev)               # the suffix's columns
        ext = torch.zeros_like(key_mask_row).index_copy_(0, cols, mask)
        key_mask_row.copy_(torch.where(torch.arange(C, device=dev) < col, key_mask_row, ext))
        pos = torch.as_tensor(pos0, device=dev).reshape(1)
        rope = _rope_tables(
            (pos + torch.clamp(torch.cumsum(mask, 0).to(torch.int32) - 1, min=0))[None],
            self.dh, c.rope_theta)
        x = self.tok_embed[ids[None]].to(adt)
        scale = self.dh ** -0.5
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, rope)
            scales = {}
            if self.quant_kv:
                kc, ksc = _kv_quantize(k[0])
                vc, vsc = _kv_quantize(v[0])
                k_scale_row[li].index_copy_(1, cols, ksc)
                v_scale_row[li].index_copy_(1, cols, vsc)
                k_row[li].index_copy_(1, cols, kc)
                v_row[li].index_copy_(1, cols, vc)
                scales = {"k_scale": k_scale_row[li][None], "v_scale": v_scale_row[li][None]}
            else:
                k_row[li].index_copy_(1, cols, k[0])
                v_row[li].index_copy_(1, cols, v[0])
            if c.attn_impl == "einsum":
                ctx = self._einsum_ctx(q, k_row[li][None], v_row[li][None], key_mask_row[None],
                                       **scales, q_offset=col)
            else:
                ctx = flash_attention_at(q, k_row[li][None], v_row[li][None],
                                         key_mask_row[None], col, scale=scale, **scales)
            x = self._finish_layer(x, ctx, li)
        if all_logits:
            logits = self._logits(x[0])
        else:
            last = torch.clamp(mask.sum().long() - 1, min=0).reshape(1)
            logits = self._logits(x[0].index_select(0, last))[0]
        return logits, k_row, v_row, key_mask_row, k_scale_row, v_scale_row

    @torch.no_grad()
    def extend_slots(self, cache: KVCache, toks: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        """Feed ``toks`` [B, G] to every lane at its own cursor (the
        propose and verify passes of speculative serving) and return one
        next-token distribution per fed token, logits [B, G, V] f32.
        Updates ``cache`` IN PLACE: lane ``b`` writes its G tokens' K/V
        (quantized for an int8 cache) at columns ``cursor[b] ..
        cursor[b]+G-1`` with RoPE positions ``next_pos[b] + i``, and for
        ``active`` ([B] bool) lanes those columns turn live and cursor and
        position advance by G; the caller rolls back what it rejects by
        resetting the cursor and masking the columns at and after it dead,
        the invariant assumed on entry (every live column lies before the
        cursor). Inactive lanes write at their columns too, with the key
        mask left 0. Active lanes need ``cursor + G <= C``.

        Per layer the cache part needs no causal term (every live column
        is visible to all G queries): ``flash_attention_cached`` with
        ``return_ml`` gives (o1, m1, l1); the G x G causal block over the
        fresh columns (their dequantized values for an int8 cache, the
        numbers later steps read back) is computed in f32, and the two
        join in the (o, m, l) combine with the fresh term gated by
        ``active``; the denominator is clamped at 1e-30, so a lane that is
        inactive over an empty cache gives finite output."""
        c, adt = self.cfg, self.adt
        C = cache.k.shape[3]
        dev = cache.k.device
        toks = toks.to(dev).long()
        B, G = toks.shape
        g = self.heads // self.kv_heads
        scale = self.dh ** -0.5
        act = active.to(dev).bool()
        gate = act.float()[:, None, None, None]                    # [B, 1, 1, 1]
        rows = torch.arange(B, device=dev)[:, None]
        cur = cache.cursor
        ccols = torch.clamp(cur[:, None] + torch.arange(G, device=dev), max=C - 1)
        tri = torch.ones(G, G, dtype=torch.bool, device=dev).tril()
        tri_bias = (tri.float() - 1.0) * 1e9                        # [G, G]
        rope = _rope_tables(cache.next_pos[:, None] + torch.arange(G, device=dev),
                            self.dh, c.rope_theta)
        x = self.tok_embed[toks].to(adt)                            # [B, G, D]
        cols = torch.arange(C, device=dev)[None, :]
        fresh = (cols >= cur[:, None]) & (cols < cur[:, None] + G) & act[:, None]
        einsum = c.attn_impl == "einsum"
        if einsum:      # JAX's xs route: the fresh columns turn live before the layers
            cache.key_mask.masked_fill_(fresh, 1.0)
        for li in range(c.layers):
            q, k, v = self._qkv(x, li, rope)
            if einsum:
                if self.quant_kv:
                    (kc, ksc), (vc, vsc) = _kv_quantize(k), _kv_quantize(v)
                    cache.k_scale[li][rows, :, ccols] = ksc.transpose(1, 2)
                    cache.v_scale[li][rows, :, ccols] = vsc.transpose(1, 2)
                    k, v = kc, vc
                cache.k[li][rows, :, ccols] = k.transpose(1, 2)
                cache.v[li][rows, :, ccols] = v.transpose(1, 2)
                ctx = self._einsum_ctx(q, cache.k[li], cache.v[li], cache.key_mask,
                                       *self._layer_scales(cache, li), q_offset=cur)
                x = self._finish_layer(x, ctx, li)
                continue
            if self.quant_kv:
                kc, ksc = _kv_quantize(k)                           # ksc [B, KH, G]
                vc, vsc = _kv_quantize(v)
                k_new = kc.float() * ksc[..., None]
                v_new = vc.float() * vsc[..., None]
            else:
                kc, vc = k.to(cache.k.dtype), v.to(cache.v.dtype)
                k_new, v_new = kc.float(), vc.float()
            scales = ({} if cache.k_scale is None else
                      {"k_scale": cache.k_scale[li], "v_scale": cache.v_scale[li]})
            # the key mask is still the entry one (live columns < cursor[b]):
            # the fresh columns turn live after the last layer
            o1, m1, l1 = flash_attention_cached(q, cache.k[li], cache.v[li], cache.key_mask,
                                                scale=scale, return_ml=True, **scales)
            sf = (q.float() @ k_new.repeat_interleave(g, dim=1).transpose(-1, -2)) * scale
            sf = sf + tri_bias                                      # [B, H, G, G]
            m2 = sf.amax(dim=-1)
            p = torch.exp(sf - m2[..., None])
            l2 = p.sum(dim=-1)
            o2num = p @ v_new.repeat_interleave(g, dim=1)           # un-normalized
            m = torch.maximum(m1, m2)
            a1 = torch.exp(m1 - m) * l1
            e2 = torch.exp(m2 - m)
            num = o1.float() * a1[..., None] + o2num * e2[..., None] * gate
            den = a1 + e2 * l2 * gate[..., 0]
            ctx = num / torch.clamp(den, min=1e-30)[..., None]
            cache.k[li][rows, :, ccols] = kc.transpose(1, 2)
            cache.v[li][rows, :, ccols] = vc.transpose(1, 2)
            if self.quant_kv:
                cache.k_scale[li][rows, :, ccols] = ksc.transpose(1, 2)
                cache.v_scale[li][rows, :, ccols] = vsc.transpose(1, 2)
            x = self._finish_layer(x, ctx, li)
        cache.key_mask.masked_fill_(fresh, 1.0)
        adv = G * act.to(cur.dtype)
        cache.cursor = cur + adv
        cache.next_pos = cache.next_pos + adv.to(cache.next_pos.dtype)
        return self._logits(x)


def init_params(cfg: DecoderConfig, *, seed: int = 0,
                device: str | torch.device = "cuda", bits: int | None = None) -> dict:
    """Random parameters in the JAX layout, drawn from ``torch.Generator``
    seeded with ``seed`` (the JAX init's distributions: N(0, 1/fan_in)
    matmuls, N(0, 0.02^2) embeddings, unit norms, zero biases; not its
    numbers). ``bits=8`` (gate|up fused) and ``bits=4`` (gate and up
    apart) quantize layer by layer as they draw, so a 7B-class model never
    holds its float weights at once."""
    if bits not in (None, 4, 8):
        raise ValueError(f"bits must be None, 4 or 8, got {bits}")
    meta = torch.device(device).type == "meta"        # shapes only (a trainer's layout)
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    L, D, Fd = cfg.layers, cfg.hidden, cfg.mlp_dim
    kvh = cfg.kv_heads or cfg.heads
    dh = D // cfg.heads
    qkv_out = (cfg.heads + 2 * kvh) * dh
    pdt = _DTYPES[cfg.param_dtype]

    def dense(fan_in, shape):
        return torch.randn(shape, generator=gen, device=device) * fan_in ** -0.5

    def quantize(w):
        if bits == 4:
            return quantize_weight_int4(w)
        q, s = quantize_weight(w)
        return {"q": q, "s": s}

    def stack(fan_in, in_out, fuse=False):
        layers = []
        for _ in range(L):
            w = (torch.cat([dense(fan_in, in_out), dense(fan_in, in_out)], -1)
                 if fuse else dense(fan_in, in_out))
            layers.append(quantize(w) if bits else w.to(pdt))
        if bits:
            return {k: torch.stack([p[k] for p in layers]) for k in layers[0]}
        return torch.stack(layers)

    blocks = {
        "rms1": torch.ones((L, D), dtype=pdt, device=device),
        "rms2": torch.ones((L, D), dtype=pdt, device=device),
        "qkv": stack(D, (D, qkv_out)),
        "attn_out": stack(D, (D, D)),
        "w_down": stack(Fd, (Fd, D)),
    }
    if bits == 8:
        blocks["w_gateup"] = stack(D, (D, Fd), fuse=True)
    else:
        blocks["w_gate"] = stack(D, (D, Fd))
        blocks["w_up"] = stack(D, (D, Fd))
    if cfg.qkv_bias:
        blocks["qkv_b"] = torch.zeros((L, qkv_out), dtype=pdt, device=device)
    head = dense(D, (D, cfg.vocab_size))
    head = quantize(head) if bits else head.to(pdt)
    return {
        "tok_embed": (torch.randn((cfg.vocab_size, D), generator=gen,
                                  device=device) * 0.02).to(pdt),
        "blocks": blocks,
        "rms_f": torch.ones((D,), dtype=pdt, device=device),
        "lm_head": head,
    }
