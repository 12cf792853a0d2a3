"""JAX decoder parameters -> the port's torch tensors.

The JAX package keeps decoder params as a nested dict (``blocks`` stacked
``[L, ...]``; float matmul weights ``[in, out]``; int8 ones ``{"q": [out,
in] i8, "s": [out] f32}``). The port keeps that layout, so conversion is
leaf by leaf. Used by the parity tests (a JAX tree turned into numpy) and
by ``Generator.from_checkpoint`` (a JAX ``Generator.save`` directory).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import DecoderConfig


def to_tensor(a, device: str | torch.device = "cuda") -> torch.Tensor:
    """numpy array -> tensor. bfloat16 arrives either as ``ml_dtypes``
    bfloat16 or, read back without ml_dtypes, as raw ``|V2``: both are
    reinterpreted bit for bit."""
    a = np.array(a, order="C")          # own, writable copy
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Nested dict of numpy arrays (a JAX params tree after ``np.asarray``
    on every leaf, float or int8-quantized) -> the same tree of tensors."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else to_tensor(v, device) for k, v in tree.items()}


def checkpoint_leaf_paths(cfg: DecoderConfig) -> list[tuple[str, ...]]:
    """Leaf paths of a float decoder tree in JAX tree-flatten order (dict
    keys sorted at every level) — the order ``Generator.save`` numbers the
    arrays of ``params.npz``."""
    blocks = ["attn_out", "qkv", "rms1", "rms2", "w_down", "w_gate", "w_up"]
    if cfg.qkv_bias:
        blocks.append("qkv_b")
    return ([("blocks", b) for b in sorted(blocks)]
            + [("lm_head",), ("rms_f",), ("tok_embed",)])


def load_jax_checkpoint(path: str, device: str | torch.device = "cuda"
                        ) -> tuple[DecoderConfig, dict]:
    """Read a JAX ``Generator.save`` directory (``config.json`` +
    ``params.npz`` of float params) into (config, tensor tree)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = DecoderConfig(**json.load(f))
    paths = checkpoint_leaf_paths(cfg)
    with np.load(os.path.join(path, "params.npz")) as z:
        if len(z.files) != len(paths):
            raise ValueError(
                f"checkpoint at {path} has {len(z.files)} arrays but this "
                f"architecture has {len(paths)}")
        tree: dict = {"blocks": {}}
        for i, p in enumerate(paths):
            node = tree
            for key in p[:-1]:
                node = node[key]
            node[p[-1]] = to_tensor(z[str(i)], device)
    return cfg, tree
