"""Flat (exact brute-force) index (port of ``mediquery_rag_tpu/engine/flat.py``).

The corpus is a device-resident matrix, L2-normalized for cosine, padded to
a multiple of the corpus tile and stored as ``float32``/``bfloat16``
(``ops.scoring.flat_search``), ``int8`` with per-row scales
(``ops.quant.int8_flat_search``) or row-pair-packed ``int4`` with ``[2, P]``
scale planes (``ops.quant.int4_flat_search``). With ``rerank_factor`` an
int8/int4 index keeps a float16 copy of the normalized rows in host RAM:
the scan fetches ``kk = max(k, min(128, rerank_factor * k, n))`` candidates
and the host re-scores them exactly (``host_rerank``).

A search is two stages: the scan stage launches the kernel and starts the
copy of its candidates into pinned host memory on a side stream; the finish
stage waits for that copy, reranks on the host and maps rows to stable doc
ids. ``search_stream`` overlaps one batch's finish with the next batch's
scan. ``add`` and ``delete`` return a new index, so a reader holding the
old one never sees a torn mix.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.ops.quant import (
    dequantize_int4, int4_flat_search, int8_flat_search, quantize_rows,
    quantize_rows_int4,
)
from mediquery_rag_tpu_torch.ops.scoring import flat_search

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANT = ("int8", "int4")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_dtype(cfg: EngineConfig) -> None:
    if cfg.dtype not in _DTYPES and cfg.dtype not in _QUANT:
        raise ValueError(f"FlatIndex dtype {cfg.dtype!r}: one of "
                         f"{[*_DTYPES, *_QUANT]}")


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


def host_rerank(refine: np.ndarray, q: np.ndarray, s: np.ndarray,
                cand_ids: np.ndarray, k: int, cosine: bool):
    """Exact host re-score of the scan's candidates against the f16
    refinement copy (``cand_ids`` index ``refine`` rows; ``s`` = -inf marks
    a padded slot). Returns the true top-k (scores, ids) among them.

    Uses the OpenMP C++ kernel (``native/rerank.cpp``, fused f16 convert +
    dot, parallel over queries) when it builds; the numpy path is the
    fallback and the reference (same ids, stable ties)."""
    q32 = np.asarray(q, dtype=np.float32)
    if cosine:
        q32 = q32 / np.maximum(np.linalg.norm(q32, axis=1, keepdims=True),
                               1e-12)
    cand_ids = np.asarray(cand_ids)
    s = np.asarray(s)
    if refine.dtype == np.float16 and cand_ids.shape[1] <= 512:
        from mediquery_rag_tpu_torch.native.rerank import (
            native_rerank, rerank_available)
        if rerank_available():
            return native_rerank(refine, q32, s, cand_ids, k)
    safe = np.clip(cand_ids, 0, len(refine) - 1)
    cand = refine[safe].astype(np.float32)          # [b, kk, d]
    exact = np.einsum("bd,bkd->bk", q32, cand, optimize=True)
    exact = np.where(s > -np.inf, exact, -np.inf)
    top = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(exact, top, axis=1),
            np.take_along_axis(cand_ids, top, axis=1))


def _refine_copy(host_src: np.ndarray | None, v: torch.Tensor,
                 cosine: bool) -> np.ndarray:
    """f16 refinement copy of the normalized rows, made on the host from the
    caller's numpy array when there is one, else pulled from the device."""
    if host_src is not None:
        r = host_src.astype(np.float32)
        if cosine:
            r = r / np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-12)
        return r.astype(np.float16)
    return v.half().cpu().numpy()


_copy_streams: dict[torch.device, torch.cuda.Stream] = {}    # device -> host copies
_h2d_streams: dict[torch.device, torch.cuda.Stream] = {}     # host -> device copies
_copy_lock = threading.Lock()


def _side_stream(table: dict, dev: torch.device) -> torch.cuda.Stream:
    with _copy_lock:
        side = table.get(dev)
        if side is None:
            side = table[dev] = torch.cuda.Stream(dev)
    return side


def _to_host(*tensors: torch.Tensor):
    """Start copying the scan's outputs to the host. On the card: into
    pinned buffers on a side stream that waits for the current one, with an
    event recorded after the copies. Returns (host tensors, event or None)."""
    if not tensors[0].is_cuda:
        return tensors, None
    dev = tensors[0].device
    side = _side_stream(_copy_streams, dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    out = []
    with torch.cuda.stream(side):
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)            # keep t alive until the copy ran
            out.append(h)
        event = torch.cuda.Event()
        event.record(side)
    return tuple(out), event


def stream_to_device(items, device, *, prefetch: bool = True, dtypes=None):
    """Yield each item of ``items`` (a tuple of host tensors, such as a
    corpus chunk and its scales) as a tuple of tensors on ``device``, in
    order.

    On the card each tensor is staged in one of two pinned host buffers and
    copied on a side stream (a copy from pageable memory is synchronous).
    With ``prefetch`` item ``i+1`` is staged and its copy issued before
    item ``i`` is yielded, so the copy overlaps the caller's work on item
    ``i``; the current stream waits on an event for each copy, and before a
    buffer is refilled the host waits for the event of its last copy.
    ``prefetch=False`` is the synchronous ablation: the caller's work on
    one item finishes before the next is staged, and each copy lands before
    its item is yielded. ``dtypes`` (one per position, None = keep) casts on
    the way into the pinned buffers; a tensor already on the card passes
    through. On the CPU the items pass through, cast."""
    dev = torch.device(device)

    def cast(item):
        return tuple(t if dt is None else t.to(dt)
                     for t, dt in zip(item, dtypes or (None,) * len(item)))

    if dev.type != "cuda":
        for item in items:
            yield cast(item)
        return
    side = _side_stream(_h2d_streams, dev)
    cur = torch.cuda.current_stream(dev)
    bufs: list = [None, None]
    reuse: list = [None, None]          # event after the last copy out of each buffer set

    def stage(item, slot):
        if reuse[slot] is not None:
            reuse[slot].synchronize()
        if bufs[slot] is None:
            bufs[slot] = [None] * len(item)
        outs = []
        for pos, (t, dt) in enumerate(zip(item, dtypes or (None,) * len(item))):
            dt = t.dtype if dt is None else dt
            if t.is_cuda:
                outs.append(t.to(dt))
                continue
            h = bufs[slot][pos]
            if h is None or h.shape != t.shape or h.dtype != dt:
                h = bufs[slot][pos] = torch.empty(t.shape, dtype=dt, pin_memory=True)
            h.copy_(t)
            with torch.cuda.stream(side):
                outs.append(h.to(dev, non_blocking=True))
        event = torch.cuda.Event()
        event.record(side)
        reuse[slot] = event
        return outs, event

    def ready(staged):
        outs, event = staged
        cur.wait_event(event)
        for o in outs:
            o.record_stream(cur)        # allocated on the side stream, used on this one
        return tuple(outs)

    pending, slot = None, 0
    for item in items:
        if not prefetch:
            cur.synchronize()
        staged = stage(item, slot)
        slot ^= 1
        if not prefetch:
            staged[1].synchronize()
            yield ready(staged)
            continue
        if pending is not None:
            yield ready(pending)
        pending = staged
    if pending is not None:
        yield ready(pending)


@dataclass
class FlatIndex:
    """Exact search over a device-resident, tile-padded corpus matrix.

    ``corpus`` is ``[N_pad, D]`` (``[N_pad/2, D]`` for int4), pad rows zero;
    ``corpus_scale`` is None for float dtypes, ``[N_pad]`` f32 for int8 and
    ``[2, N_pad/2]`` f32 planes for int4. ``ids`` (host, ``[N_pad]`` i32)
    maps rows to stable doc ids once a delete has compacted the rows; None
    means identity.
    """

    corpus: torch.Tensor
    n: int                                 # valid rows
    cfg: EngineConfig
    corpus_scale: torch.Tensor | None = None
    ids: torch.Tensor | None = None
    _next_id: int | None = None            # None = n (no deletes yet)
    refine: np.ndarray | None = None       # [n, D] f16 host copy (rerank)

    @classmethod
    def build(cls, vectors, cfg: EngineConfig = EngineConfig(),
              device: str | torch.device = "cuda") -> "FlatIndex":
        """Build from ``[N, D]`` raw vectors: normalize (cosine), quantize or
        cast, pad."""
        host_src = vectors if isinstance(vectors, np.ndarray) else None
        v = vectors if isinstance(vectors, torch.Tensor) else torch.as_tensor(
            np.asarray(vectors))
        v = v.to(device)
        n, d = v.shape
        if d != cfg.dim:
            cfg = EngineConfig(**{**cfg.__dict__, "dim": d})
        cfg = cfg.resolve_corpus_tile(n)
        _check_dtype(cfg)
        cosine = cfg.metric == "cosine"
        if cosine:
            v = l2_normalize(v.float())
        if cfg.dtype == "int4" and cfg.corpus_tile % 2:
            raise ValueError("int4 needs an even corpus_tile (row-pair packing)")
        scale = refine = None
        if cfg.dtype in _QUANT:
            if cfg.rerank_factor:
                refine = _refine_copy(host_src, v, cosine)
            quant = quantize_rows if cfg.dtype == "int8" else quantize_rows_int4
            v, scale = quant(v)
        else:
            v = v.to(_DTYPES[cfg.dtype])
        return cls(corpus=v, n=n, cfg=cfg)._repad(v, n, scale, None, None, refine)

    @property
    def next_id(self) -> int:
        """First unused doc id (ids are never reused after a delete)."""
        return self.n if self._next_id is None else self._next_id

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int | None = None):
        """Top-k search. Returns (scores [B, k] f32, doc ids [B, k] i32) as
        host tensors; a 1-D query gives 1-D results."""
        return self._finish_stage(*self._scan_stage(queries, k))

    def search_stream(self, batches, k: int | None = None, depth: int = 2):
        """Pipelined two-stage search over an iterable of query batches:
        batch ``i+1``'s scan is launched before batch ``i`` is reranked on
        the host, so the card scans while the host reranks. ``depth`` bounds
        the scans in flight. Yields one ``(scores, ids)`` pair per batch, in
        order, bit-identical to :meth:`search`."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        pending: deque = deque()
        for qb in batches:
            pending.append(self._scan_stage(qb, k))
            if len(pending) > depth:
                yield self._finish_stage(*pending.popleft())
        while pending:
            yield self._finish_stage(*pending.popleft())

    def _scan_stage(self, queries, k: int | None):
        """Launch the scan and the copy of its candidates to the host."""
        k = self.cfg.top_k if k is None else k
        if k > 128:
            raise ValueError(f"k={k} > 128 not supported by the fused kernel")
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        cosine = self.cfg.metric == "cosine"
        rerank = self.refine is not None and self.cfg.rerank_factor > 0
        kk = max(k, min(128, self.cfg.rerank_factor * k, self.n)) if rerank else k
        q = q_pad.to(self.corpus.device).float()
        if cosine:
            q = l2_normalize(q)
        tiles = {"query_tile": self.cfg.query_tile, "corpus_tile": self.cfg.corpus_tile}
        if self.cfg.dtype == "int4":
            s, i = int4_flat_search(q, self.corpus, self.corpus_scale, kk,
                                    n_valid=self.n, **tiles)
        elif self.cfg.dtype == "int8":
            s, i = int8_flat_search(q, self.corpus, self.corpus_scale, kk,
                                    n_valid=self.n, **tiles)
        else:
            s, i = flat_search(q, self.corpus, kk, n_valid=self.n, **tiles)
        (s, i), event = _to_host(s[:b], i[:b])
        return queries, s, i, event, squeeze, rerank, k, cosine

    def _finish_stage(self, queries, s, i, event, squeeze, rerank, k, cosine):
        """Wait for the candidates, rerank exactly on the host, map doc ids."""
        if event is not None:
            event.synchronize()
        if rerank:
            # even at kk == k the exact re-score corrects the quantized order
            rs, ri = host_rerank(self.refine, queries.cpu().numpy(), s.numpy(),
                                 i.numpy(), k, cosine)
            s = torch.from_numpy(np.ascontiguousarray(rs, np.float32))
            i = torch.from_numpy(np.ascontiguousarray(ri, np.int32))
        if self.ids is not None:
            i = torch.where(s > float("-inf"), self.ids[i.long()], i)
        if squeeze:
            return s[0], i[0]
        return s, i

    # -- live add / delete -------------------------------------------------------

    def _dequantized(self) -> torch.Tensor:
        """Valid rows as f32 (identity for float dtypes)."""
        if self.cfg.dtype == "int4":
            return dequantize_int4(self.corpus, self.corpus_scale, self.n)
        rows = self.corpus[: self.n].float()
        if self.corpus_scale is not None:
            rows = rows * self.corpus_scale[: self.n, None]
        return rows

    def add(self, vectors) -> "FlatIndex":
        """Append vectors; returns a new index. New rows get consecutive doc
        ids from ``next_id`` (stable labels that survive later deletes).
        int4 re-quantizes through f32, since byte-rows pair logical rows;
        existing rows keep their codes and scales."""
        v = vectors if isinstance(vectors, torch.Tensor) else torch.as_tensor(
            np.asarray(vectors))
        v = v.to(self.corpus.device)
        m = v.shape[0]
        if self.cfg.metric == "cosine":
            v = l2_normalize(v.float())
        n = self.n + m
        scale = None
        refine = self.refine
        if self.corpus_scale is not None:
            if refine is not None:
                refine = np.concatenate(
                    [refine, v.float().cpu().numpy().astype(np.float16)], axis=0)
            if self.cfg.dtype == "int4":
                merged, scale = quantize_rows_int4(
                    torch.cat([self._dequantized(), v.float()], dim=0))
            else:
                q8, s_new = quantize_rows(v.float())
                merged = torch.cat([self.corpus[: self.n], q8], dim=0)
                scale = torch.cat([self.corpus_scale[: self.n], s_new])
        else:
            merged = torch.cat([self.corpus[: self.n], v.to(self.corpus.dtype)], dim=0)
        ids = None
        if self.ids is not None or self._next_id not in (None, self.n):
            old = (self.ids[: self.n] if self.ids is not None
                   else torch.arange(self.n, dtype=torch.int32))
            ids = torch.cat([old, self.next_id + torch.arange(m, dtype=torch.int32)])
        return self._repad(merged, n, scale, ids, self.next_id + m, refine)

    def delete(self, doc_ids) -> "FlatIndex":
        """Remove docs by stable id; returns a new index (or this one when no
        id is known). Order-preserving compaction; unknown ids are ignored;
        deleting every row raises."""
        want_gone = np.asarray(doc_ids).reshape(-1)
        cur = (self.ids[: self.n].numpy() if self.ids is not None
               else np.arange(self.n, dtype=np.int32))
        keep = np.where(~np.isin(cur, want_gone))[0]
        if len(keep) == self.n:
            return self
        if len(keep) == 0:
            raise ValueError("delete would empty the index")
        keep_t = torch.as_tensor(keep, device=self.corpus.device)
        if self.cfg.dtype == "int4":
            # packed byte-rows hold two logical rows: compact in f32, repack
            merged, scale = quantize_rows_int4(self._dequantized()[keep_t])
        else:
            merged = self.corpus[keep_t]
            scale = self.corpus_scale[keep_t] if self.corpus_scale is not None else None
        ids = torch.as_tensor(cur[keep], dtype=torch.int32)
        refine = self.refine[keep] if self.refine is not None else None
        return self._repad(merged, len(keep), scale, ids, self.next_id, refine)

    def _repad(self, merged, n, scale, ids, next_id, refine) -> "FlatIndex":
        """Pad already normalized/quantized rows, their scales and ids to the
        corpus tile (int4: ``n_pad / 2`` byte-rows and scale columns)."""
        tile = self.cfg.corpus_tile
        n_pad = _round_up(max(n, tile), tile)
        rows_pad = n_pad // 2 if self.cfg.dtype == "int4" else n_pad
        merged = torch.nn.functional.pad(merged, (0, 0, 0, rows_pad - merged.shape[0]))
        if scale is not None:
            scale = torch.nn.functional.pad(scale, (0, rows_pad - scale.shape[-1]))
        if ids is not None:
            ids = torch.nn.functional.pad(ids, (0, n_pad - n))
        return FlatIndex(corpus=merged, n=n, cfg=self.cfg, corpus_scale=scale,
                         ids=ids, _next_id=next_id, refine=refine)

    # -- persistence: the JAX package's format 2 (raw rows + meta.json) ----------

    def save(self, path: str) -> None:
        """Write the stored representation (bf16/int8/int4 bytes, scales,
        ids per logical row, the refine copy) and ``meta.json``."""
        os.makedirs(path, exist_ok=True)
        raw = self.corpus.cpu()
        if raw.dtype == torch.bfloat16:        # numpy has no bfloat16
            raw = raw.view(torch.int16).numpy().view(np.uint16)
        else:
            raw = raw.numpy()
        np.save(os.path.join(path, "corpus_raw.npy"), raw)
        if self.corpus_scale is not None:
            np.save(os.path.join(path, "scales.npy"), self.corpus_scale.cpu().numpy())
        if self.ids is not None:
            np.save(os.path.join(path, "ids.npy"), self.ids[: self.n].numpy())
        if self.refine is not None:
            np.save(os.path.join(path, "refine.npy"), self.refine)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "kind": "flat", "cfg": self.cfg.__dict__,
                       "next_id": self.next_id, "format": 2}, f)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "FlatIndex":
        """Load an index saved by this class or by the JAX package."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig(**{**EngineConfig().__dict__, **meta["cfg"]})
        _check_dtype(cfg)
        if meta.get("format", 1) >= 2:
            raw = np.load(os.path.join(path, "corpus_raw.npy"))
            if cfg.dtype == "bfloat16":
                corpus = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            else:
                corpus = torch.from_numpy(raw)
            scale = None
            sc_path = os.path.join(path, "scales.npy")
            if os.path.exists(sc_path):
                scale = torch.from_numpy(np.load(sc_path)).to(device)
            idx = cls(corpus=corpus.to(device), n=meta["n"], cfg=cfg,
                      corpus_scale=scale)
        else:   # legacy format: f32 rows, rebuilt
            idx = cls.build(np.load(os.path.join(path, "corpus.npy")), cfg,
                            device=device)
        ids_path = os.path.join(path, "ids.npy")
        if os.path.exists(ids_path):
            raw_ids = np.load(ids_path)
            # ids are per LOGICAL row; int4 corpora store n_pad/2 byte-rows
            n_pad = idx.corpus.shape[0] * (2 if cfg.dtype == "int4" else 1)
            idx.ids = torch.from_numpy(
                np.pad(raw_ids, (0, n_pad - len(raw_ids))).astype(np.int32))
        ref_path = os.path.join(path, "refine.npy")
        if os.path.exists(ref_path):
            idx.refine = np.load(ref_path)
        idx._next_id = meta.get("next_id")
        return idx

    @property
    def nbytes(self) -> int:
        """Device bytes of the stored corpus and its scales."""
        n = self.corpus.numel() * self.corpus.element_size()
        if self.corpus_scale is not None:
            n += self.corpus_scale.numel() * 4
        return n
