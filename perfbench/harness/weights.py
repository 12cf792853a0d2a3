"""Seeded model weights and data rows, made on the device.

Each leaf of each layer draws from its own ``torch.Generator`` seeded from
(run seed, leaf, layer), so the reference can make any one layer again,
in any order, without holding the whole tree: the program and the
reference are handed the same numbers. Decoder leaves follow the JAX
layout (``[in, out]`` matmul weights stacked ``[L, ...]``) in the dtype
they are served in; the BERT encoder's are f32, as an HF checkpoint's."""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def generator(seed: int, leaf: str, layer: int, device) -> torch.Generator:
    h = seed * 0x9E3779B97F4A7C15
    for ch in leaf.encode():
        h = (h * 1000003) ^ ch
    h = (h + (layer + 1) * 0xBF58476D1CE4E5B9) & _MASK
    return torch.Generator(device=device).manual_seed(h)


def _normal(shape, std: float, mean: float, g, device, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=g, device=device) * std + mean).to(dtype)


# -- the Qwen2-class decoder ----------------------------------------------------

def qwen2_leaf_spec(shape: dict) -> dict:
    """leaf -> (per-layer shape, std, mean); stacked leaves are marked by
    ``stacked``."""
    D, F, V = shape["hidden"], shape["mlp_dim"], shape["vocab"]
    dh = D // shape["heads"]
    qkv = (shape["heads"] + 2 * shape["kv_heads"]) * dh
    return {
        "tok_embed": ((V, D), 0.02, 0.0, False),
        "rms1": ((D,), 0.1, 1.0, True),
        "rms2": ((D,), 0.1, 1.0, True),
        "qkv": ((D, qkv), D ** -0.5, 0.0, True),
        "qkv_b": ((qkv,), 0.1, 0.0, True),
        "attn_out": ((D, D), D ** -0.5, 0.0, True),
        "w_gate": ((D, F), D ** -0.5, 0.0, True),
        "w_up": ((D, F), D ** -0.5, 0.0, True),
        "w_down": ((F, D), F ** -0.5, 0.0, True),
        "rms_f": ((D,), 0.1, 1.0, False),
        "lm_head": ((D, V), D ** -0.5, 0.0, False),
    }


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def qwen2_leaf(shape: dict, seed: int, leaf: str, layer: int | None, device) -> torch.Tensor:
    """One layer of a stacked leaf (``layer``), or a whole unstacked one, in
    the configuration's dtype (``shape["dtype"]``)."""
    dims, std, mean, stacked = qwen2_leaf_spec(shape)[leaf]
    if stacked != (layer is not None):
        raise ValueError(f"{leaf}: layer {layer} for a {'stacked' if stacked else 'single'} leaf")
    g = generator(seed, leaf, -1 if layer is None else layer, device)
    return _normal(dims, std, mean, g, device, DTYPES[shape["dtype"]])


def qwen2_params(shape: dict, seed: int, device) -> dict:
    """The whole tree in the JAX layout: ``blocks`` stacked ``[L, ...]``."""
    L = shape["layers"]
    blocks = {}
    for leaf, (dims, _, _, stacked) in qwen2_leaf_spec(shape).items():
        if not stacked:
            continue
        t = torch.empty((L, *dims), dtype=DTYPES[shape["dtype"]], device=device)
        for li in range(L):
            t[li] = qwen2_leaf(shape, seed, leaf, li, device)
        blocks[leaf] = t
    return {"tok_embed": qwen2_leaf(shape, seed, "tok_embed", None, device),
            "blocks": blocks,
            "rms_f": qwen2_leaf(shape, seed, "rms_f", None, device),
            "lm_head": qwen2_leaf(shape, seed, "lm_head", None, device)}


# -- the BERT encoder (f32 leaves, as an HF checkpoint holds them) --------------

def bert_params(shape: dict, seed: int, device) -> dict:
    """Post-LN BERT in the JAX layout (``models/hf_import.py:load_bert``):
    N(0, 0.02^2) matrices and embeddings (HF's initializer_range), biases
    N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.05^2)."""
    D, F, L = shape["hidden"], shape["mlp_dim"], shape["layers"]
    f32 = torch.float32

    def leaf(name, dims, std=0.02, mean=0.0):
        return _normal(dims, std, mean, generator(seed, "bert." + name, -1, device), device, f32)

    def stack(name, dims, std=0.02, mean=0.0):
        return torch.stack([_normal(dims, std, mean, generator(seed, "bert." + name, li, device),
                                    device, f32) for li in range(L)])

    return {
        "tok_embed": leaf("tok_embed", (shape["vocab"], D)),
        "pos_embed": leaf("pos_embed", (shape["max_len"], D)),
        "type_embed": leaf("type_embed", (2, D)),
        "emb_ln_scale": leaf("emb_ln_scale", (D,), 0.05, 1.0),
        "emb_ln_bias": leaf("emb_ln_bias", (D,)),
        "blocks": {
            "qkv": stack("qkv", (D, 3 * D)), "qkv_b": stack("qkv_b", (3 * D,)),
            "attn_out": stack("attn_out", (D, D)), "attn_out_b": stack("attn_out_b", (D,)),
            "ln1_scale": stack("ln1_scale", (D,), 0.05, 1.0), "ln1_bias": stack("ln1_bias", (D,)),
            "wi": stack("wi", (D, F)), "bi": stack("bi", (F,)),
            "wo": stack("wo", (F, D)), "bo": stack("bo", (D,)),
            "ln2_scale": stack("ln2_scale", (D,), 0.05, 1.0), "ln2_bias": stack("ln2_bias", (D,)),
        },
    }


# -- retrieval rows ---------------------------------------------------------------

def scattered_rows(centers: torch.Tensor, n: int, spread: float, seed: int) -> torch.Tensor:
    """``n`` unit rows, each a seeded centre plus isotropic noise of norm
    about ``spread`` (per dimension std ``spread / sqrt(D)``), normalized.
    Made in blocks on the centres' device."""
    dev = centers.device
    g = generator(seed, "rows", -1, dev)
    c = torch.randint(0, centers.shape[0], (n,), generator=g, device=dev)
    d = centers.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    for r in range(0, n, 1 << 18):
        e = min(n, r + (1 << 18))
        x = centers[c[r:e]] + torch.randn((e - r, d), generator=g, device=dev) * (spread * d ** -0.5)
        out[r:e] = x / x.norm(dim=1, keepdim=True)
    return out
