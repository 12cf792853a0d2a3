"""Sharded IVF index (port of ``mediquery_rag_tpu/engine/sharded_ivf.py``).

The clusters of an ``IVFIndex`` are split into contiguous ranges, one per
mesh device, and each device holds only its range's buckets, followed by
one empty sentinel bucket (ids -1, live extent 0). The centroids stay on
the mesh's first device: a query's ``nprobe`` probes are chosen there once,
as ``IVFIndex.search`` chooses them, and each shard gets the probes it owns
in local numbering, with every probe it does not own sent to its sentinel
(the JAX package recomputes the same probes on every shard). Each shard
runs the IVF scans of ``ops/ivf_kernel.py`` (query-major B8a/B8b/B8c or
bucket-major B9a/B9b/B9c), and the ``[B, k]`` partial lists, which carry
global doc ids, are merged on the first device (``parallel.collectives``).

A batch whose probes all lie on one shard costs the other shards a scan of
their sentinel alone: latency degrades toward one card's, never the
answer. No host rerank follows, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine.flat import as_query_batch, l2_normalize
from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
from mediquery_rag_tpu_torch.engine.sharded import merge_partials, shard_devices
from mediquery_rag_tpu_torch.ops.ivf_kernel import (
    ivf_batch_search, ivf_bucket_major, ivf_extent, ivf_probe_search, ivf_probe_search_int4,
    ivf_probe_search_int8)
from mediquery_rag_tpu_torch.ops.topk import exact_topk
from mediquery_rag_tpu_torch.parallel.mesh import Mesh


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (bf16 as its uint16 bits)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _device(a: np.ndarray, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """numpy -> a ``dtype`` tensor on ``dev`` (bf16 from its uint16 bits)."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev, dtype)


@dataclass
class ShardedIVFIndex:
    """Shard ``s`` holds buckets ``s*per .. s*per + per - 1`` and its sentinel
    (local bucket ``per``): ``buckets[s]`` ``[(per+1) * rows, D]`` (rows =
    cap, or cap/2 split-half packed int4 rows), ``bucket_ids[s]`` ``[per+1,
    cap]`` global doc ids, ``bucket_scales[s]`` ``[per+1, cap]`` f32 (int8,
    int4) and ``extent[s]`` ``[per+1]`` (the sentinel's is 0), each on the
    shard's device. ``centroids`` ``[nlist, D]`` f32 on the first device."""

    centroids: torch.Tensor
    buckets: list[torch.Tensor]
    bucket_ids: list[torch.Tensor]
    n: int
    cap: int
    nlist: int                 # real clusters
    per_shard: int             # clusters per shard, sentinel excluded
    cfg: EngineConfig
    mesh: Mesh
    bucket_scales: list[torch.Tensor] | None = None
    extent: list[torch.Tensor] = field(init=False, repr=False)

    def __post_init__(self):
        self.extent = [ivf_extent(b) for b in self.bucket_ids]

    @classmethod
    def build(cls, vectors, mesh: Mesh, cfg: EngineConfig = EngineConfig(), *,
              seed: int = 0) -> "ShardedIVFIndex":
        """Build the one-device IVF index on the mesh's first device, then
        split its clusters over the mesh."""
        base = IVFIndex.build(vectors, cfg, seed=seed, device=shard_devices(cfg, mesh)[0])
        return cls.from_single(base, mesh)

    @classmethod
    def from_single(cls, base: IVFIndex, mesh: Mesh) -> "ShardedIVFIndex":
        """Split an existing ``IVFIndex`` (built, streamed or loaded from
        either package's files) over the mesh: a host relayout into ``S``
        ranges of ``per = ceil(nlist / S)`` clusters plus a sentinel each
        (a streaming build's dummy tail bucket is dropped)."""
        cfg = base.cfg
        devices = shard_devices(cfg, mesh)
        s = len(devices)
        nlist, cap = base.bucket_ids.shape
        d = base.buckets.shape[1]
        per = -(-nlist // s)
        rows = cap // 2 if cfg.dtype == "int4" else cap
        src_vecs = _host(base.buckets)[: nlist * rows].reshape(nlist, rows, d)
        src_ids = _host(base.bucket_ids)
        quant = base.bucket_scales is not None
        src_scales = _host(base.bucket_scales) if quant else None
        buckets, ids, scales = [], [], []
        for sh, dev in enumerate(devices):
            lo, hi = min(sh * per, nlist), min((sh + 1) * per, nlist)
            bv = np.zeros((per + 1, rows, d), src_vecs.dtype)
            bi = np.full((per + 1, cap), -1, np.int32)
            bv[: hi - lo] = src_vecs[lo:hi]
            bi[: hi - lo] = src_ids[lo:hi]
            buckets.append(_device(bv.reshape(-1, d), base.buckets.dtype, dev))
            ids.append(_device(bi, torch.int32, dev))
            if quant:
                bs = np.zeros((per + 1, cap), np.float32)
                bs[: hi - lo] = src_scales[lo:hi]
                scales.append(_device(bs, torch.float32, dev))
        return cls(centroids=base.centroids.to(devices[0]).float(), buckets=buckets,
                   bucket_ids=ids, n=base.n, cap=cap, nlist=nlist, per_shard=per, cfg=cfg,
                   mesh=mesh, bucket_scales=scales if quant else None)

    @property
    def kind(self) -> str:
        """The scans' storage kind: ``int8``, ``int4``, ``f32`` or ``bf16``."""
        if self.bucket_scales is not None:
            return self.cfg.dtype
        return "f32" if self.buckets[0].dtype == torch.float32 else "bf16"

    def search(self, queries, k: int | None = None, nprobe: int | None = None, *,
               batched: bool | None = None):
        """Probe search over every shard. Returns (scores ``[B, k]`` f32,
        doc ids ``[B, k]`` i32) on the mesh's first device; a 1-D query gives
        1-D results. ``batched=None`` picks the layout by
        ``ops.ivf_kernel.ivf_bucket_major`` over the global ``nlist``: the
        card's measured crossover on the card, JAX's ``B * nprobe >= 2 *
        nlist`` on the CPU."""
        k = self.cfg.top_k if k is None else k
        if k > 128:
            raise ValueError(f"k={k} > 128 not supported by the fused kernel")
        nprobe = min(self.cfg.ivf_nprobe if nprobe is None else nprobe, self.nlist)
        queries, squeeze = as_query_batch(queries)
        b = queries.shape[0]
        kind = self.kind
        if batched is None:
            batched = ivf_bucket_major(kind, b, nprobe, self.nlist, self.buckets[0].is_cuda)
        q = queries.to(self.centroids.device).float()
        if self.cfg.metric == "cosine":
            q = l2_normalize(q)
        pid = exact_topk(q @ self.centroids.T, nprobe)[1].to(torch.int32)
        parts_s, parts_i = [], []
        for sh, (bk, bids) in enumerate(zip(self.buckets, self.bucket_ids)):
            local = pid - sh * self.per_shard
            mine = (local >= 0) & (local < self.per_shard)
            local = torch.where(mine, local, self.per_shard).to(torch.int32)
            dev = bk.device
            lp, qs = local.to(dev, non_blocking=True).contiguous(), q.to(dev, non_blocking=True)
            sc = None if self.bucket_scales is None else self.bucket_scales[sh]
            ext = self.extent[sh]
            if batched:
                s, i = ivf_batch_search(lp, qs, bk, bids, k=k, bucket_scales=sc,
                                        quant=kind if sc is not None else "none", extent=ext)
            elif kind == "int4":
                s, i = ivf_probe_search_int4(lp, qs, bk, bids, sc, k=k, extent=ext)
            elif kind == "int8":
                s, i = ivf_probe_search_int8(lp, qs, bk, bids, sc, k=k, extent=ext)
            else:
                s, i = ivf_probe_search(lp, qs.to(bk.dtype), bk, bids, k=k, extent=ext)
            parts_s.append(s)
            parts_i.append(i)
        s, i = merge_partials(parts_s, parts_i, k, self.cfg, self.mesh)
        if squeeze:
            return s[0], i[0]
        return s, i

    @property
    def nbytes(self) -> int:
        """Device bytes of the buckets, ids, scales and centroids."""
        nb = self.centroids.numel() * 4
        for sh, bk in enumerate(self.buckets):
            nb += bk.numel() * bk.element_size() + self.bucket_ids[sh].numel() * 4
            if self.bucket_scales is not None:
                nb += self.bucket_scales[sh].numel() * 4
        return nb
