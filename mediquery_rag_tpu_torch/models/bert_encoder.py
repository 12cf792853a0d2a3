"""Post-LN BERT encoder (port of ``mediquery_rag_tpu/models/bert_encoder.py``).

The graph of pretrained BERT embedding checkpoints (the reference embeds
with ``shaw/dmeta-embedding-zh``, a Chinese BERT derivative): token,
position and token-type embeddings with an embedding LayerNorm, then
post-LN blocks with biases everywhere and exact-erf GELU, then mask-weighted
mean (or CLS) pooling, L2-normalized. Parameters keep the JAX layout
(``hf_import.load_bert``): f32 tensors, per-layer weights stacked ``[L,
...]``, matmul weights ``[in, out]``.

The numerics are JAX's: activations in ``cfg.dtype``, every product of
``cfg.dtype`` values summed in f32 (JAX's ``preferred_element_type``; here
``ops.matmul``'s f32-sum products of the rounded operands, so the sum is
never rounded to bf16 on the way), LayerNorm, softmax and GELU in f32. JAX
computes this attention with plain einsums, outside any Pallas kernel, so
the port's is plain PyTorch too. Random initialization is not ported:
weights come from a checkpoint.

``partition_specs`` is JAX's Megatron layout; ``bert_layout(...).shard``
cuts a rank's part of a full tree (qkv and its bias by heads), and
``BertEncoder(cfg, params, mesh=)`` runs over it: the row-parallel
outputs are all-reduced over "model" and their biases (``attn_out_b``,
``bo``, replicated) added once after the reduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mediquery_rag_tpu_torch.config import BertEmbedderConfig
from mediquery_rag_tpu_torch.ops.matmul import bmm_f32, mm_f32
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import Layout, head_parts

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_EMBED = ("tok_embed", "pos_embed", "type_embed", "emb_ln_scale", "emb_ln_bias")
BLOCK_KEYS = ("qkv", "qkv_b", "attn_out", "attn_out_b", "ln1_scale", "ln1_bias",
              "wi", "bi", "wo", "bo", "ln2_scale", "ln2_bias")


def partition_specs(cfg: BertEmbedderConfig | None = None) -> dict:
    """Megatron's layout over mesh axes ("data", "model"): JAX's
    ``BertEncoder.partition_specs``, each spec a tuple of axis names."""
    return {
        "tok_embed": (None, None),
        "pos_embed": (None, None),
        "type_embed": (None, None),
        "emb_ln_scale": (None,),
        "emb_ln_bias": (None,),
        "blocks": {
            "qkv": (None, None, "model"),
            "qkv_b": (None, "model"),
            "attn_out": (None, "model", None),
            "attn_out_b": (None, None),
            "ln1_scale": (None, None),
            "ln1_bias": (None, None),
            "wi": (None, None, "model"),
            "bi": (None, "model"),
            "wo": (None, "model", None),
            "bo": (None, None),
            "ln2_scale": (None, None),
            "ln2_bias": (None, None),
        },
    }


def bert_layout(cfg: BertEmbedderConfig, params: dict, mesh) -> Layout:
    """This rank's layout of a full tree: qkv's ``[q | k | v]`` columns
    and their bias by heads, every other sharded dim in contiguous runs."""
    parts = {}
    if mesh is not None and mesh.tp > 1:
        cols = head_parts(cfg.heads, cfg.heads, cfg.hidden // cfg.heads, mesh.tp)
        parts = {("blocks", "qkv"): cols, ("blocks", "qkv_b"): cols}
    return Layout(params, partition_specs(cfg), mesh, parts)


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           adt: torch.dtype) -> torch.Tensor:
    """``x @ w + b`` in f32 over operands rounded to ``adt``."""
    return mm_f32(x, w, adt) + b.float()


class BertEncoder(nn.Module):
    """Post-LN BERT over a JAX-layout parameter dict (tensors). ``forward``
    returns pooled L2-normalized [B, D] f32 sentence embeddings;
    ``hidden_states`` the last layer's [B, S, D] in ``cfg.dtype``."""

    def __init__(self, cfg: BertEmbedderConfig, params: dict, mesh=None):
        super().__init__()
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")
        self.cfg = cfg
        self.adt = _DTYPES[cfg.dtype]
        self.group = None if mesh is None else mesh.model_group
        self.heads = cfg.heads if self.group is None else cfg.heads // mesh.tp
        for name in _EMBED:
            self.register_buffer(name, params[name])
        for name in BLOCK_KEYS:
            self.register_buffer(name, params["blocks"][name])

    def partition_specs(self) -> dict:
        return partition_specs(self.cfg)

    def _row(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A row-parallel ``x @ w + b``: the partial f32 sums all-reduced
        over "model", the bias added once after."""
        return cc.reduce_from_model(mm_f32(x, w, self.adt), self.group) + b.float()

    def _block(self, x: torch.Tensor, li: int, attn_bias: torch.Tensor) -> torch.Tensor:
        c, adt = self.cfg, self.adt
        B, S, D = x.shape
        dh, heads = D // c.heads, self.heads
        qkv = _dense(cc.copy_to_model(x, self.group), self.qkv[li], self.qkv_b[li], adt).to(adt)
        q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        logits = bmm_f32(q, k.transpose(-1, -2), adt)
        w = torch.softmax(logits * dh ** -0.5 + attn_bias, dim=-1).to(adt)
        ctx = bmm_f32(w, v, adt).to(adt).transpose(1, 2).reshape(B, S, heads * dh)
        attn = self._row(ctx, self.attn_out[li], self.attn_out_b[li])
        x = _layernorm(x.float() + attn, self.ln1_scale[li], self.ln1_bias[li],
                       c.ln_eps).to(adt)
        # HF's default "gelu" is the exact erf form, not tanh-approximate
        h = cc.copy_to_model(x, self.group)
        ff = F.gelu(_dense(h, self.wi[li], self.bi[li], adt)).to(adt)
        ff = self._row(ff, self.wo[li], self.bo[li])
        return _layernorm(x.float() + ff, self.ln2_scale[li], self.ln2_bias[li],
                          c.ln_eps).to(adt)

    @torch.no_grad()
    def hidden_states(self, ids, mask, type_ids=None) -> torch.Tensor:
        """Full encoder stack -> [B, S, D] (dtype ``cfg.dtype``). ``ids``,
        ``mask`` [B, S] (1 = real token, right-padded) and ``type_ids``
        may be numpy arrays or tensors on any device."""
        dev = self.tok_embed.device
        ids = torch.as_tensor(ids).to(dev).long()
        mask = torch.as_tensor(mask).to(dev).float()
        type_ids = (torch.zeros_like(ids) if type_ids is None
                    else torch.as_tensor(type_ids).to(dev).long())
        S = ids.shape[1]
        x = self.tok_embed[ids] + self.pos_embed[:S][None] + self.type_embed[type_ids]
        x = _layernorm(x, self.emb_ln_scale, self.emb_ln_bias, self.cfg.ln_eps).to(self.adt)
        attn_bias = (mask[:, None, None, :] - 1.0) * 1e9
        for li in range(self.cfg.layers):
            x = self._block(x, li, attn_bias)
        return x

    @torch.no_grad()
    def forward(self, ids, mask, type_ids=None) -> torch.Tensor:
        """Pooled L2-normalized [B, D] f32 sentence embeddings."""
        x = self.hidden_states(ids, mask, type_ids)
        if self.cfg.pooling == "cls":
            pooled = x[:, 0].float()
        else:
            m = torch.as_tensor(mask).to(x.device).float()[:, :, None]
            pooled = (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        return pooled / torch.clamp(pooled.norm(dim=-1, keepdim=True), min=1e-12)
