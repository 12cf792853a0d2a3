"""Checkpoints of the sharded indexes and of a trainer's state (port of
``mediquery_rag_tpu/engine/checkpoint.py``).

The JAX package writes these with orbax, which the port does not use: its
files are ``meta.json`` with the JAX package's keys (``kind``:
``sharded_flat`` or ``sharded_ivf``, ``n``, ``cfg``, ...) and one ``.npy``
file per shard and array (bf16 as its uint16 bits). ``load`` puts the rows
back together on the host and splits them again over the mesh it is given,
so an index saved on S shards loads onto a mesh of any size. A trainer
state is ``params.npz`` (the leaves in JAX's tree-flatten order, the file
``embedder.save_params`` writes), ``opt_state.npz`` (the optimizer state's
tensors and counts, in the order of its structure) and ``meta.json``
(the step). orbax checkpoints of the JAX package do not load here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine.flat import _round_up
from mediquery_rag_tpu_torch.engine.ivf import _DTYPES as _STORED
from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
from mediquery_rag_tpu_torch.engine.sharded import ShardedFlatIndex, shard_devices
from mediquery_rag_tpu_torch.engine.sharded_ivf import ShardedIVFIndex, _device, _host
from mediquery_rag_tpu_torch.parallel.mesh import Mesh


def _write_meta(path: str, meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _read_meta(path: str, kind: str) -> tuple[dict, EngineConfig]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != kind or "shards" not in meta:
        raise ValueError(f"{path} holds no {kind} checkpoint of this package "
                         f"(kind {meta.get('kind')!r}; orbax checkpoints do not load)")
    return meta, EngineConfig(**{**EngineConfig().__dict__, **meta["cfg"]})


def _save(path: str, name: str, t: torch.Tensor) -> None:
    np.save(os.path.join(path, f"{name}.npy"), _host(t))


def _load_cat(path: str, name: str, shards: int, dim: int = 0) -> np.ndarray:
    return np.concatenate([np.load(os.path.join(path, f"{name}_{s}.npy"))
                           for s in range(shards)], axis=dim)


# -- sharded flat ---------------------------------------------------------------------

def save_sharded_index(index: ShardedFlatIndex, path: str) -> None:
    """Write each shard's rows (and scales) and ``meta.json``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    for s, rows in enumerate(index.shards):
        _save(path, f"corpus_{s}", rows)
        if index.scales is not None:
            _save(path, f"scale_{s}", index.scales[s])
    _write_meta(path, {
        "n": index.n, "n_pad": sum(int(r.shape[0]) for r in index.shards),
        "d": int(index.shards[0].shape[1]), "has_scale": index.scales is not None,
        "cfg": index.cfg.__dict__, "kind": "sharded_flat", "shards": len(index.shards)})


def load_sharded_index(path: str, mesh: Mesh) -> ShardedFlatIndex:
    """Load onto ``mesh``: the stored rows are padded (or cut) to a multiple
    of the new shard count times the corpus tile and split again."""
    path = os.path.abspath(path)
    meta, cfg = _read_meta(path, "sharded_flat")
    s_new = len(shard_devices(cfg, mesh))
    int4 = cfg.dtype == "int4"
    rows = _load_cat(path, "corpus", meta["shards"])
    scale = _load_cat(path, "scale", meta["shards"], dim=1 if int4 else 0) \
        if meta["has_scale"] else None
    n = meta["n"]
    n_pad = _round_up(max(n, s_new * cfg.corpus_tile), s_new * cfg.corpus_tile)
    have = _round_up(n, 2) if int4 else n          # stored rows that hold valid ones
    keep, want = (have // 2, n_pad // 2) if int4 else (have, n_pad)
    rows = np.pad(rows[:keep], ((0, want - keep), (0, 0)))
    if scale is not None:
        scale = np.pad(scale[..., :keep], [(0, 0)] * (scale.ndim - 1) + [(0, want - keep)])
    dev = shard_devices(cfg, mesh)[0]
    return ShardedFlatIndex.from_rows(
        _device(rows, _STORED[cfg.dtype], dev), None if scale is None else
        _device(scale, torch.float32, dev), n, cfg, mesh)


# -- sharded IVF ----------------------------------------------------------------------

def save_sharded_ivf(index: ShardedIVFIndex, path: str) -> None:
    """Write the centroids, each shard's buckets, ids (and scales), and
    ``meta.json``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _save(path, "centroids", index.centroids)
    for s, bk in enumerate(index.buckets):
        _save(path, f"buckets_{s}", bk)
        _save(path, f"bucket_ids_{s}", index.bucket_ids[s])
        if index.bucket_scales is not None:
            _save(path, f"bucket_scales_{s}", index.bucket_scales[s])
    _write_meta(path, {
        "n": index.n, "cap": index.cap, "nlist": index.nlist, "per_shard": index.per_shard,
        "rows": sum(int(b.shape[0]) for b in index.buckets),
        "d": int(index.buckets[0].shape[1]), "has_scales": index.bucket_scales is not None,
        "cfg": index.cfg.__dict__, "kind": "sharded_ivf", "shards": len(index.buckets)})


def load_sharded_ivf(path: str, mesh: Mesh) -> ShardedIVFIndex:
    """Load onto ``mesh``: the shards' buckets, sentinels dropped, make the
    one-device layout again, which is split over the new mesh."""
    path = os.path.abspath(path)
    meta, cfg = _read_meta(path, "sharded_ivf")
    nlist, cap, per, shards = meta["nlist"], meta["cap"], meta["per_shard"], meta["shards"]
    rows = cap // 2 if cfg.dtype == "int4" else cap

    def real(name, width):
        parts = [np.load(os.path.join(path, f"{name}_{s}.npy")).reshape(per + 1, width, -1)
                 [: max(0, min(per, nlist - s * per))] for s in range(shards)]
        return np.concatenate(parts)

    buckets = real("buckets", rows).reshape(nlist * rows, meta["d"])
    ids = real("bucket_ids", cap).reshape(nlist, cap)
    scales = real("bucket_scales", cap).reshape(nlist, cap) if meta["has_scales"] else None
    cpu = torch.device("cpu")
    base = IVFIndex(
        centroids=torch.from_numpy(np.load(os.path.join(path, "centroids.npy"))),
        buckets=_device(buckets, _STORED[cfg.dtype], cpu),
        bucket_ids=torch.from_numpy(ids), n=meta["n"], cap=cap, cfg=cfg,
        bucket_scales=None if scales is None else torch.from_numpy(scales))
    return ShardedIVFIndex.from_single(base, mesh)


# -- trainer state --------------------------------------------------------------------

def _flatten(x) -> list:
    """Leaves of a state in a fixed order: dict values by sorted key,
    list/tuple (NamedTuple) items in order, tensors and numbers as leaves,
    None skipped."""
    if isinstance(x, dict):
        return [leaf for key in sorted(x) for leaf in _flatten(x[key])]
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _flatten(item)]
    return [] if x is None else [x]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in turn from
    ``leaves`` (an iterator of numpy arrays): tensors keep the template's
    dtype, device and ``requires_grad``, numbers its type."""
    if isinstance(template, dict):
        return {key: _unflatten(template[key], leaves) for key in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(item, leaves) for item in template]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    if template is None:
        return None
    a = next(leaves)
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.array(a)).to(template.device, template.dtype)
        return t.requires_grad_(template.requires_grad)
    return type(template)(a.item())


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _over_shards(x, shards, leaf_fn):
    """``x`` (a state tree) with each tensor ``t`` that ``shards`` (the same
    structure, None where whole) pairs with a ``LeafShard`` replaced by
    ``leaf_fn(t, shard)``."""
    if shards is None:
        return x
    if isinstance(x, dict):
        return {k: _over_shards(x[k], shards[k], leaf_fn) for k in x}
    if isinstance(x, (list, tuple)):
        items = [_over_shards(a, b, leaf_fn) for a, b in zip(x, shards)]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return leaf_fn(x, shards) if isinstance(x, torch.Tensor) else x


def _state_shards(state, layout):
    from mediquery_rag_tpu_torch.models import optim
    return optim.state_shards(state.opt_state, optim.tree_leaves(state.params), layout.shards)


def save_train_state(state, path: str, layout=None) -> None:
    """Checkpoint a trainer's state (params, optimizer state, step). Over a
    mesh (``layout``: the trainer's ``parallel.dist.Layout``) every rank
    calls it: the state is gathered whole, in JAX's leaf order, and rank 0
    writes it."""
    from mediquery_rag_tpu_torch.parallel.dist import gather_leaf

    params, opt_state = state.params, state.opt_state
    if layout is not None:
        opt_state = _over_shards(opt_state, _state_shards(state, layout), gather_leaf)
        params = layout.gather(params)
        if layout.mesh is not None and torch.distributed.get_rank() != 0:
            return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    for name, tree in (("params", params), ("opt_state", opt_state)):
        np.savez(os.path.join(path, f"{name}.npz"),
                 **{str(i): _as_numpy(leaf) for i, leaf in enumerate(_flatten(tree))})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"kind": "train_state", "step": int(state.step)}, f)


def load_train_state(path: str, template, layout=None):
    """Restore into the structure, dtypes and devices of ``template`` (a
    trainer's state, e.g. a fresh ``init_state()``). Over a mesh of any
    size (``layout``: the trainer's), each rank keeps its shard of the
    whole saved state, as ``template`` holds."""
    path = os.path.abspath(path)
    parts = {}
    for name in ("params", "opt_state"):
        want = _flatten(getattr(template, name))
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            if len(z.files) != len(want):
                raise ValueError(f"{path}/{name}.npz has {len(z.files)} leaves, the "
                                 f"template {len(want)}")
            leaves = iter([z[str(i)] for i in range(len(want))])
            parts[name] = _unflatten(getattr(template, name), leaves)
    if layout is not None:
        def cut(t, s):
            return t.index_select(s.dim, s.index.to(t.device)).requires_grad_(t.requires_grad)
        parts["opt_state"] = _over_shards(parts["opt_state"], _state_shards(template, layout),
                                          cut)
        parts["params"] = _requires_grad_like(layout.shard(parts["params"]), template.params)
    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    return type(template)(parts["params"], parts["opt_state"], step)


def _requires_grad_like(tree: dict, template: dict) -> dict:
    return {k: _requires_grad_like(v, template[k]) if isinstance(v, dict)
            else v.detach().contiguous().requires_grad_(template[k].requires_grad)
            for k, v in tree.items()}
