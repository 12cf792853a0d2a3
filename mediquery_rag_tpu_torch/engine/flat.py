"""Flat (exact brute-force) index (port of ``mediquery_rag_tpu/engine/flat.py``).

The corpus is a device-resident ``[N_pad, D]`` matrix, L2-normalized for
cosine, cast to the storage dtype and padded to a multiple of the corpus
tile; search is one call of ``ops.scoring.flat_search`` (the CUDA top-k
kernel on the card). Float storage only: int8/int4 scans, ``add``,
``delete`` and the host rerank tier are ROADMAP Queue B items.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from mediquery_rag_tpu.config import EngineConfig
from mediquery_rag_tpu_torch.ops.scoring import flat_search

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _storage_dtype(cfg: EngineConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(
            f"FlatIndex dtype {cfg.dtype!r}: the int8/int4 scans (B2/B3) are "
            "ROADMAP Queue B items; use float32 or bfloat16")
    return _DTYPES[cfg.dtype]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(x.float(), dim=-1, keepdim=True)
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def as_query_batch(queries) -> tuple[torch.Tensor, bool]:
    """Any query input (1-D/2-D list, numpy, tensor) -> (2-D tensor, squeeze)."""
    q = queries if isinstance(queries, torch.Tensor) else torch.as_tensor(
        np.asarray(queries))
    squeeze = q.ndim == 1
    return (q[None, :] if squeeze else q), squeeze


def bucket_queries(queries: torch.Tensor, tile: int = 16) -> tuple[torch.Tensor, int]:
    """Pad a query batch to the next bucket size (1, 4, 8, then ``tile``
    multiples), as the JAX package does: the kernel sees a handful of
    batch shapes, so the allocator reuses its output buffers. Returns
    (padded ``[Bp, D]``, real b)."""
    b = queries.shape[0]
    bp = next(s for s in (1, 4, 8) if s >= b) if b <= 8 else _round_up(b, tile)
    if bp != b:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, bp - b))
    return queries, b


@dataclass
class FlatIndex:
    """Exact search over a device-resident, tile-padded corpus matrix."""

    corpus: torch.Tensor                  # [N_pad, D], pad rows zero
    n: int                                # valid rows
    cfg: EngineConfig
    ids: torch.Tensor | None = None       # [N_pad] i32 row -> doc id; None = identity
    _next_id: int | None = None

    @classmethod
    def build(cls, vectors, cfg: EngineConfig = EngineConfig(),
              device: str | torch.device = "cpu") -> "FlatIndex":
        """Build from ``[N, D]`` raw vectors: normalize (cosine), cast, pad."""
        v = torch.as_tensor(np.asarray(vectors)).to(device)
        n, d = v.shape
        if d != cfg.dim:
            cfg = EngineConfig(**{**cfg.__dict__, "dim": d})
        cfg = cfg.resolve_corpus_tile(n)
        dtype = _storage_dtype(cfg)
        if cfg.metric == "cosine":
            v = l2_normalize(v.float())
        n_pad = _round_up(max(n, cfg.corpus_tile), cfg.corpus_tile)
        corpus = torch.zeros((n_pad, d), dtype=dtype, device=device)
        corpus[:n] = v.to(dtype)
        return cls(corpus=corpus, n=n, cfg=cfg)

    @property
    def next_id(self) -> int:
        """First unused doc id (ids are never reused after a delete)."""
        return self.n if self._next_id is None else self._next_id

    def search(self, queries, k: int | None = None):
        """Top-k search. Returns (scores [B, k] f32, indices [B, k] i32),
        tensors on the index's device."""
        k = self.cfg.top_k if k is None else k
        if k > 128:
            raise ValueError(f"k={k} > 128 not supported by the fused kernel")
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        q = q_pad.to(self.corpus.device).float()
        if self.cfg.metric == "cosine":
            q = l2_normalize(q)
        s, i = flat_search(q, self.corpus, k, n_valid=self.n,
                           query_tile=self.cfg.query_tile,
                           corpus_tile=self.cfg.corpus_tile)
        s, i = s[:b], i[:b]
        if self.ids is not None:
            i = torch.where(s > float("-inf"), self.ids[i.long()], i)
        if squeeze:
            return s[0], i[0]
        return s, i

    # -- persistence: the JAX package's format 2 (raw rows + meta.json) ----

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        raw = self.corpus.cpu()
        if raw.dtype == torch.bfloat16:        # numpy has no bfloat16
            raw = raw.view(torch.int16).numpy().view(np.uint16)
        else:
            raw = raw.numpy()
        np.save(os.path.join(path, "corpus_raw.npy"), raw)
        if self.ids is not None:
            np.save(os.path.join(path, "ids.npy"),
                    self.ids[: self.n].cpu().numpy())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "kind": "flat", "cfg": self.cfg.__dict__,
                       "next_id": self.next_id, "format": 2}, f)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cpu") -> "FlatIndex":
        """Load an index saved by this class or by the JAX package."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig(**{**EngineConfig().__dict__, **meta["cfg"]})
        dtype = _storage_dtype(cfg)
        if meta.get("format", 1) >= 2:
            raw = np.load(os.path.join(path, "corpus_raw.npy"))
            if dtype == torch.bfloat16:
                corpus = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            else:
                corpus = torch.from_numpy(raw)
            idx = cls(corpus=corpus.to(device), n=meta["n"], cfg=cfg)
        else:   # legacy format: f32 rows, rebuilt
            idx = cls.build(np.load(os.path.join(path, "corpus.npy")), cfg,
                            device=device)
        ids_path = os.path.join(path, "ids.npy")
        if os.path.exists(ids_path):
            raw_ids = np.load(ids_path)
            n_pad = idx.corpus.shape[0]
            idx.ids = torch.from_numpy(
                np.pad(raw_ids, (0, n_pad - len(raw_ids))).astype(np.int32)
            ).to(device)
        idx._next_id = meta.get("next_id")
        return idx
