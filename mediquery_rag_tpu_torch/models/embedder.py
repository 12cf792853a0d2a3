"""768-d text-embedding encoder (port of ``mediquery_rag_tpu/models/embedder.py``).

The pre-LN transformer encoder of the JAX package as an ``nn.Module`` over
its parameter layout: per-layer weights stacked ``[L, ...]``, matmul
weights ``[in, out]``, f32 parameters. Every cast sits where JAX puts it:
activations in ``cfg.dtype``; each product of ``cfg.dtype`` operands summed
in f32 (``ops.matmul``); attention logits in f32, scaled by ``dh**-0.5``
plus the ``(mask - 1) * 1e9`` bias, softmax in f32; the MLP's bias and
tanh-approximate GELU (``jax.nn.gelu``'s default) in f32; LayerNorm in f32
with eps 1e-6; masked mean pooling, L2-normalized with a 1e-12 floor.

JAX computes the attention with plain einsums, outside any Pallas kernel,
so the port's is plain PyTorch too. ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``). Residual-branch dropout draws its
masks from a ``torch.Generator``, so they cannot equal JAX's (ROADMAP Queue
C 4); they are drawn before the blocks run, so a recomputed block reuses
them.

Over a training mesh (``Embedder(cfg, params, mesh=)``) the blocks run on
this rank's Megatron shard (``partition_specs``, JAX's axes): qkv
column-parallel by heads (``embedder_layout``), attn_out and wo
row-parallel with their f32 outputs all-reduced over "model" and ``bo``
added once after the reduce, wi/bi column-parallel.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mediquery_rag_tpu_torch.config import EmbedderConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.ops.matmul import bmm_f32, mm_f32
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import Layout, head_parts, tree_paths

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
BLOCK_KEYS = ("ln1_scale", "ln1_bias", "qkv", "attn_out", "ln2_scale",
              "ln2_bias", "wi", "bi", "wo", "bo")
TOP_KEYS = ("tok_embed", "pos_embed", "ln_f_scale", "ln_f_bias")


def partition_specs(cfg: EmbedderConfig | None = None) -> dict:
    """Megatron's layout over mesh axes ("data", "model"): JAX's
    ``Embedder.partition_specs``, each spec a tuple of axis names."""
    return {
        "tok_embed": (None, None),
        "pos_embed": (None, None),
        "blocks": {
            "ln1_scale": (None, None),
            "ln1_bias": (None, None),
            "qkv": (None, None, "model"),      # column parallel
            "attn_out": (None, "model", None),  # row parallel
            "ln2_scale": (None, None),
            "ln2_bias": (None, None),
            "wi": (None, None, "model"),       # column parallel
            "bi": (None, "model"),
            "wo": (None, "model", None),       # row parallel
            "bo": (None, None),
        },
        "ln_f_scale": (None,),
        "ln_f_bias": (None,),
    }


def embedder_layout(cfg: EmbedderConfig, params: dict, mesh) -> Layout:
    """This rank's layout of a full tree: qkv's ``[q | k | v]`` columns by
    heads, every other sharded dim in contiguous runs."""
    parts = {}
    if mesh is not None and mesh.tp > 1:
        parts[("blocks", "qkv")] = head_parts(cfg.heads, cfg.heads, cfg.hidden // cfg.heads,
                                              mesh.tp)
    return Layout(params, partition_specs(cfg), mesh, parts)


def init_params(cfg: EmbedderConfig, *, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters in the JAX layout, drawn from ``generator`` (seed 0
    when None) on ``device``: the JAX init's distributions (N(0, 1/fan_in)
    matmuls, N(0, 0.02^2) embeddings, unit scales, zero biases), not its
    numbers."""
    device = torch.device(device)
    if device.type == "meta":     # shapes only (a trainer's layout)
        gen = None
    else:
        gen = generator or torch.Generator(device=device).manual_seed(0)
    L, D, Fd = cfg.layers, cfg.hidden, cfg.mlp_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def stack(fan_in, *shape):
        return torch.stack([normal(*shape) * fan_in ** -0.5 for _ in range(L)])

    ones, zeros = (functools.partial(f, device=device) for f in (torch.ones, torch.zeros))
    return {
        "tok_embed": normal(cfg.vocab_size, D) * 0.02,
        "pos_embed": normal(cfg.max_len, D) * 0.02,
        "blocks": {
            "ln1_scale": ones((L, D)), "ln1_bias": zeros((L, D)),
            "qkv": stack(D, D, 3 * D), "attn_out": stack(D, D, D),
            "ln2_scale": ones((L, D)), "ln2_bias": zeros((L, D)),
            "wi": stack(D, D, Fd), "bi": zeros((L, Fd)),
            "wo": stack(Fd, Fd, D), "bo": zeros((L, D)),
        },
        "ln_f_scale": ones((D,)),
        "ln_f_bias": zeros((D,)),
    }


# -- checkpoints in the JAX package's params.npz format --------------------------

# key paths in ``jax.tree_util.tree_flatten``'s order: the numbering of ``params.npz``
leaf_paths = tree_paths


def save_params(params: dict, path: str) -> None:
    """Write ``path/params.npz``: leaves keyed ``"0".."n"`` in JAX's flatten
    order, as f32 numpy arrays (what JAX's ``np.asarray`` of its f32 leaves
    writes)."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **{
        str(i): t.detach().float().cpu().numpy()
        for i, t in enumerate(optim.tree_leaves(params))})


def load_params(path: str, skeleton: dict, device: str | torch.device) -> dict:
    """Read ``path/params.npz`` into a tree shaped like ``skeleton`` (any
    nested dict with the checkpoint's keys), each leaf a tensor on
    ``device``. Raises ValueError when the leaf count differs."""
    z = np.load(os.path.join(path, "params.npz"))
    paths = leaf_paths(skeleton)
    if len(z.files) != len(paths):
        raise ValueError(
            f"checkpoint at {path} has {len(z.files)} arrays but this "
            f"architecture has {len(paths)}: build it with from_checkpoint() "
            "or the matching EmbedderConfig")
    tree: dict = {}
    for i, p in enumerate(paths):
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = torch.from_numpy(np.asarray(z[str(i)])).to(device)
    return tree


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))


def tree_to(tree: dict, device: str | torch.device) -> dict:
    """``tree`` with every leaf (a tensor, or an array: copied) a tensor on
    ``device`` (a tensor already there is kept, not copied)."""
    return {k: tree_to(v, device) if isinstance(v, dict) else _tensor(v).to(device)
            for k, v in tree.items()}


def trainable(tree: dict, device: str | torch.device) -> dict:
    """A copy of ``tree`` whose leaves are detached f32 copies on ``device``
    that require grad."""
    return {k: trainable(v, device) if isinstance(v, dict)
            else _tensor(v).detach().to(device, torch.float32).clone()
            .requires_grad_(True) for k, v in tree.items()}


def skeleton(cross: bool = False) -> dict:
    """The key structure of an embedder's tree (``cross``: a CrossEncoder's)."""
    tree = {k: None for k in TOP_KEYS}
    tree["blocks"] = {k: None for k in BLOCK_KEYS}
    if cross:
        tree.update(seg_embed=None, score_w=None, score_b=None)
    return tree


# -- the forward ---------------------------------------------------------------

def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _dropout(x: torch.Tensor, keep_mask: torch.Tensor | None, keep: float) -> torch.Tensor:
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))


def _block(x: torch.Tensor, lp: dict, masks: tuple, *, heads: int, dh: int, adt: torch.dtype,
           attn_bias: torch.Tensor, keep: float, group=None) -> torch.Tensor:
    """One pre-LN block (JAX ``_block``) over ``heads`` heads (this rank's,
    with ``group`` the model group); ``masks``: the (attention, MLP)
    dropout keep masks, or (None, None)."""
    B, S, D = x.shape
    h = cc.copy_to_model(_layernorm(x, lp["ln1_scale"], lp["ln1_bias"]), group)
    qkv = mm_f32(h, lp["qkv"], adt).to(adt)
    q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    logits = bmm_f32(q, k.transpose(-1, -2), adt) * dh ** -0.5 + attn_bias
    w = torch.softmax(logits, dim=-1).to(adt)
    ctx = bmm_f32(w, v, adt).to(adt).transpose(1, 2).reshape(B, S, heads * dh)
    attn = cc.reduce_from_model(mm_f32(ctx, lp["attn_out"], adt), group).to(adt)
    x = x + _dropout(attn, masks[0], keep)
    h = cc.copy_to_model(_layernorm(x, lp["ln2_scale"], lp["ln2_bias"]), group)
    ff = F.gelu(mm_f32(h, lp["wi"], adt) + lp["bi"], approximate="tanh").to(adt)
    ff = (cc.reduce_from_model(mm_f32(ff, lp["wo"], adt), group) + lp["bo"]).to(adt)
    return x + _dropout(ff, masks[1], keep)


class Embedder(nn.Module):
    """The encoder over a JAX-layout parameter tree (tensors, registered as
    buffers: they stay the caller's leaves, so gradients reach them), or
    with a ``mesh`` of model axis > 1 over this rank's shard of it.
    ``forward`` returns L2-normalized [B, hidden] f32 embeddings."""

    def __init__(self, cfg: EmbedderConfig, params: dict, mesh=None):
        super().__init__()
        if cfg.hidden % cfg.heads:
            raise ValueError("hidden must divide heads")
        self.cfg = cfg
        self.adt = _DTYPES[cfg.dtype]
        self.group = None if mesh is None else mesh.model_group
        self.heads = cfg.heads if self.group is None else cfg.heads // mesh.tp
        for name in TOP_KEYS:
            self.register_buffer(name, params[name])
        for name in BLOCK_KEYS:
            self.register_buffer(name, params["blocks"][name])

    def partition_specs(self) -> dict:
        return partition_specs(self.cfg)

    def hidden(self, ids, mask, *, seg=None, seg_embed: torch.Tensor | None = None,
               remat: bool = False, generator: torch.Generator | None = None,
               rows: tuple[int, slice] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Embeddings (plus ``seg_embed[seg]`` for the cross-encoder), the
        blocks and the final LayerNorm. Returns ([B, S, D] in ``cfg.dtype``,
        the mask as f32 on the device). ``generator`` turns on residual
        dropout at ``cfg.dropout`` (training); ``rows`` ``(n, sl)``: these
        rows are rows ``sl`` of a batch of ``n``, and take those rows of the
        masks drawn for all ``n`` (a data rank's part of a global batch)."""
        c, adt = self.cfg, self.adt
        dev = self.tok_embed.device
        ids = torch.as_tensor(ids).to(dev).long()
        mask = torch.as_tensor(mask).to(dev).float()
        B, S = ids.shape
        x = self.tok_embed[ids] + self.pos_embed[:S][None]
        if seg is not None:
            x = x + seg_embed[torch.as_tensor(seg).to(dev).long()]
        x = x.to(adt)
        attn_bias = (mask[:, None, None, :] - 1.0) * 1e9
        keep = 1.0 - c.dropout
        drop = generator is not None and c.dropout > 0.0
        layers = zip(*(getattr(self, k).unbind(0) for k in BLOCK_KEYS))
        block = functools.partial(_block, heads=self.heads, dh=c.hidden // c.heads, adt=adt,
                                  attn_bias=attn_bias, keep=keep, group=self.group)
        n, sl = rows or (B, slice(None))
        for parts in layers:
            lp = dict(zip(BLOCK_KEYS, parts))
            masks = ((torch.rand((n, *x.shape[1:]), generator=generator, device=dev)[sl] < keep,
                      torch.rand((n, *x.shape[1:]), generator=generator, device=dev)[sl] < keep)
                     if drop else (None, None))
            x = (checkpoint(block, x, lp, masks, use_reentrant=False) if remat
                 else block(x, lp, masks))
        return _layernorm(x, self.ln_f_scale, self.ln_f_bias), mask

    @staticmethod
    def pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked mean over the sequence, f32 [B, D]."""
        m = mask[:, :, None]
        return (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)

    def forward(self, ids, mask, *, remat: bool = False,
                generator: torch.Generator | None = None,
                rows: tuple[int, slice] | None = None) -> torch.Tensor:
        x, mask = self.hidden(ids, mask, remat=remat, generator=generator, rows=rows)
        pooled = self.pool(x, mask)
        return pooled / torch.clamp(pooled.norm(dim=-1, keepdim=True), min=1e-12)
