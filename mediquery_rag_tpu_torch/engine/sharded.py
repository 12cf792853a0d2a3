"""Sharded flat index (port of ``mediquery_rag_tpu/engine/sharded.py``).

The corpus rows are split over the devices of a mesh (``parallel.mesh``):
each device holds ``N_pad / S`` rows and scans only its shard with the
flat kernels (``ops.scoring.flat_search``: B1 bf16/f32;
``ops.quant.int8_flat_search``: B2; ``ops.quant.int4_flat_search``: B3),
and the ``[B, k]`` partial lists are merged on the mesh's first device
(``parallel.collectives``). Queries are replicated. One process drives
every shard, as the JAX package's single controller does: all shards are
launched before anything waits for a result.

With ``cfg.dcn_axis`` naming an axis of a ``(dcn, ici)`` mesh
(``parallel.slice_mesh``), rows are split over the product of both axes in
row-major order and the merge is hierarchical.

Unlike ``FlatIndex``, no host rerank follows the scan: the JAX package's
sharded int8/int4 index returns the kernel's scores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine.flat import (
    _DTYPES, _round_up, as_query_batch, bucket_queries, l2_normalize)
from mediquery_rag_tpu_torch.ops.quant import (
    int4_flat_search, int8_flat_search, quantize_rows, quantize_rows_int4)
from mediquery_rag_tpu_torch.ops.scoring import flat_search
from mediquery_rag_tpu_torch.parallel.collectives import grouped_topk_merge
from mediquery_rag_tpu_torch.parallel.mesh import Mesh

_NEG_INF = float("-inf")


def shard_axes(cfg: EngineConfig, mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the rows are split over: ``(ici,)``, or ``(dcn, ici)`` when
    ``cfg.dcn_axis`` names an axis of the mesh."""
    if cfg.dcn_axis:
        if cfg.dcn_axis not in mesh.axis_names:
            raise ValueError(f"cfg.dcn_axis={cfg.dcn_axis!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
        return (cfg.dcn_axis, cfg.mesh_axis)
    return (cfg.mesh_axis,)


def shard_devices(cfg: EngineConfig, mesh: Mesh) -> list[torch.device]:
    """The device of each shard, in shard order (row-major over the axes)."""
    axes = shard_axes(cfg, mesh)
    if set(axes) != set(mesh.axis_names):
        raise ValueError(f"the rows are split over {axes}, but the mesh has the axes "
                         f"{mesh.axis_names}")
    order = [mesh.axis_names.index(a) for a in axes]
    return list(np.transpose(mesh.devices, order).reshape(-1))


def split_rows(t: torch.Tensor, devices: list[torch.device], dim: int = 0) -> list[torch.Tensor]:
    """``t`` cut into ``len(devices)`` equal parts along ``dim``, part ``s``
    on ``devices[s]`` (a view where it already lies there)."""
    parts = torch.chunk(t, len(devices), dim=dim)
    return [p.to(dev).contiguous() for p, dev in zip(parts, devices)]


def merge_partials(scores, idx, k, cfg: EngineConfig, mesh: Mesh):
    return grouped_topk_merge(scores, idx, k, mesh, shard_axes(cfg, mesh))


@dataclass
class ShardedFlatIndex:
    """``shards[s]``: shard ``s``'s ``[N_pad/S, D]`` rows on its device
    (int4: ``[N_pad/2S, D]`` packed byte-rows); ``scales[s]``: its
    ``[N_pad/S]`` f32 row scales (int8) or ``[2, N_pad/2S]`` scale planes
    (int4), None for float dtypes. Pad rows are zero and are never scored
    (each shard's kernel gets its count of valid rows)."""

    shards: list[torch.Tensor]
    n: int                                  # global valid rows
    cfg: EngineConfig
    mesh: Mesh
    scales: list[torch.Tensor] | None = None

    @property
    def per_shard(self) -> int:
        """Logical rows per shard, pad included."""
        return self.shards[0].shape[0] * (2 if self.cfg.dtype == "int4" else 1)

    @classmethod
    def build(cls, vectors, mesh: Mesh, cfg: EngineConfig = EngineConfig()
              ) -> "ShardedFlatIndex":
        """Normalize (cosine), quantize or cast and pad ``[N, D]`` rows on the
        mesh's first device, as ``FlatIndex.build`` does, then split them:
        each shard holds a whole number of corpus tiles, so a small corpus
        leaves whole shards without a valid row. int4 pads before packing,
        so no row pair straddles two shards."""
        devices = shard_devices(cfg, mesh)
        s = len(devices)
        v = vectors if isinstance(vectors, torch.Tensor) else torch.as_tensor(
            np.asarray(vectors))
        v = v.to(devices[0])
        n, d = v.shape
        if d != cfg.dim:
            cfg = EngineConfig(**{**cfg.__dict__, "dim": d})
        cfg = cfg.resolve_corpus_tile(n // max(s, 1))
        if cfg.metric == "cosine":
            v = l2_normalize(v.float())
        n_pad = _round_up(max(n, s * cfg.corpus_tile), s * cfg.corpus_tile)
        scale = None
        if cfg.dtype == "int4":
            if cfg.corpus_tile % 2:
                raise ValueError("int4 needs an even corpus_tile (row-pair packing)")
            v, scale = quantize_rows_int4(torch.nn.functional.pad(v.float(),
                                                                  (0, 0, 0, n_pad - n)))
        elif cfg.dtype == "int8":
            v, scale = quantize_rows(v.float())
            v = torch.nn.functional.pad(v, (0, 0, 0, n_pad - n))
            scale = torch.nn.functional.pad(scale, (0, n_pad - n))
        elif cfg.dtype in _DTYPES:
            v = torch.nn.functional.pad(v.to(_DTYPES[cfg.dtype]), (0, 0, 0, n_pad - n))
        else:
            raise ValueError(f"ShardedFlatIndex dtype {cfg.dtype!r}: one of "
                             f"{[*_DTYPES, 'int8', 'int4']}")
        return cls.from_rows(v, scale, n, cfg, mesh)

    @classmethod
    def from_rows(cls, rows: torch.Tensor, scale: torch.Tensor | None, n: int,
                  cfg: EngineConfig, mesh: Mesh) -> "ShardedFlatIndex":
        """Split stored rows (padded to a multiple of S corpus tiles; int4
        packed, with its ``[2, P]`` planes) over the mesh."""
        devices = shard_devices(cfg, mesh)
        shards = split_rows(rows, devices)
        scales = None
        if scale is not None:
            scales = split_rows(scale, devices, dim=scale.dim() - 1)
        return cls(shards=shards, n=n, cfg=cfg, mesh=mesh, scales=scales)

    def search(self, queries, k: int | None = None):
        """Global top-k over every shard: (scores ``[B, k]`` f32, global ids
        ``[B, k]`` i32) on the mesh's first device; a 1-D query gives 1-D
        results. Short results are (-inf, id 0)."""
        k = self.cfg.top_k if k is None else k
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        q = q_pad.to(self.shards[0].device).float()
        if self.cfg.metric == "cosine":
            q = l2_normalize(q)
        per = self.per_shard
        tiles = {"query_tile": self.cfg.query_tile, "corpus_tile": self.cfg.corpus_tile}
        parts_s, parts_i = [], []
        for sh, rows in enumerate(self.shards):
            offset = sh * per
            local_valid = min(max(self.n - offset, 0), per)
            qs = q.to(rows.device, non_blocking=True)
            if self.cfg.dtype == "int4":
                s, i = int4_flat_search(qs, rows, self.scales[sh], k,
                                        n_valid=local_valid, **tiles)
            elif self.cfg.dtype == "int8":
                s, i = int8_flat_search(qs, rows, self.scales[sh], k,
                                        n_valid=local_valid, **tiles)
            else:
                s, i = flat_search(qs, rows, k, n_valid=local_valid, **tiles)
            parts_s.append(s)
            parts_i.append(torch.where(s > _NEG_INF, i + offset, 0))
        s, i = merge_partials(parts_s, parts_i, k, self.cfg, self.mesh)
        s, i = s[:b], i[:b]
        if squeeze:
            return s[0], i[0]
        return s, i

    @property
    def nbytes(self) -> int:
        """Device bytes of every shard's rows and scales."""
        n = sum(t.numel() * t.element_size() for t in self.shards)
        if self.scales is not None:
            n += sum(t.numel() * 4 for t in self.scales)
        return n
