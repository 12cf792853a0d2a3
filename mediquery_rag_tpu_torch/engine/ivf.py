"""IVF (inverted-file) index (port of ``mediquery_rag_tpu/engine/ivf.py``).

Build: spherical k-means (``ops/kmeans.py``) on a sample, the balanced
split of oversized clusters, a top-r assignment of every row, then the
bounded-cap bucket layout (``_plan_layout``, host ints) and a chunked
gather of the rows into ``[nlist * cap, D]`` buckets (bf16, int8 with
per-slot scales, or int4 codes with per-slot scales, packed at the end
split-half into ``[nlist * cap/2, D]`` bytes). ``build_streaming`` builds
the same index from chunks of a corpus that never sits on the card whole.
Search: the centroid product, top-``nprobe``, then the query-major
(B8a/B8b/B8c) or bucket-major (B9a/B9b/B9c) probe scan of
``ops/ivf_kernel.py``, and for an int8 or int4 index with ``rerank_factor``
the exact host rerank of ``engine/flat.py``. ``add`` and ``delete`` return
a new index. ``save``/``load`` use the JAX package's files (``ivf.npz`` +
``meta.json``), so either package loads the other's index.

The query-major scan reads ``B * nprobe * cap`` rows, the bucket-major scan
each probed bucket once for the whole batch; ``search`` picks between them
with the JAX package's rule. Every storage type (float32, bfloat16, int8,
int4) runs on the card.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine.flat import (
    _refine_copy, as_query_batch, host_rerank, l2_normalize, stream_to_device)
from mediquery_rag_tpu_torch.ops.ivf_kernel import (
    ivf_batch_search, ivf_bucket_major, ivf_extent, ivf_probe_search, ivf_probe_search_int4,
    ivf_probe_search_int8)
from mediquery_rag_tpu_torch.ops.kmeans import (
    assign_clusters, assign_clusters_topr, kmeans, split_oversized)
from mediquery_rag_tpu_torch.ops.quant import (
    int4_codes, ivf_pack_slots_int4, ivf_unpack_slots_int4, quantize_rows)
from mediquery_rag_tpu_torch.ops.topk import exact_topk

# storage type of each dtype; int4 codes are packed two to a byte
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
           "int4": torch.int8}
_QUANT = ("int8", "int4")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_dtype(cfg: EngineConfig) -> None:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"IVFIndex dtype {cfg.dtype!r}: one of {list(_DTYPES)}")


# Copy of mediquery_rag_tpu/engine/ivf.py:_rebalance_overflow and _plan_layout (host numpy).
def _rebalance_overflow(assign, counts, top_ids, top_scores, cap_limit):
    """Bounded-cap placement, vectorized (runs on host ints at 10M scale).

    Overloaded clusters keep their ``cap_limit`` best-scoring rows; each
    overflow row moves to its next-best centroid with free space (one
    sorted cumcount pass per candidate rank, no per-row Python loop), with
    a least-filled fallback for the rare row whose whole candidate list is
    full.
    """
    nlist = counts.shape[0]
    order_all = np.argsort(assign, kind="stable")
    slice_starts = np.concatenate(([0], np.cumsum(counts)))
    overflow_parts = []
    for c in np.where(counts > cap_limit)[0]:
        rows = order_all[slice_starts[c]:slice_starts[c + 1]]
        order = np.argsort(-top_scores[rows, 0], kind="stable")
        overflow_parts.append(rows[order[cap_limit:]])
        counts[c] = cap_limit
    pending = np.concatenate(overflow_parts)

    r_alt = top_ids.shape[1]
    for r in range(1, r_alt):
        if len(pending) == 0:
            break
        cand = top_ids[pending, r]
        room = cap_limit - counts                     # free slots per cluster
        order = np.argsort(cand, kind="stable")
        sorted_c = cand[order]
        # rank of each row within its candidate cluster group
        starts = np.searchsorted(sorted_c, np.arange(nlist), side="left")
        rank_in_c = np.arange(len(sorted_c)) - starts[sorted_c]
        fits = rank_in_c < room[sorted_c]
        placed_rows = pending[order[fits]]
        assign[placed_rows] = sorted_c[fits]
        counts += np.bincount(sorted_c[fits], minlength=nlist)
        pending = pending[order[~fits]]
    # fallback: spread leftovers over the emptiest clusters
    for row in pending:
        c2 = int(np.argmin(counts))
        assign[row] = c2
        counts[c2] += 1
    return assign, counts


def _plan_layout(top_ids, top_scores, nlist, n, cap_limit):
    """Bucket layout from a top-r assignment (host ints only).

    Returns (bucket_ids [nlist, cap] i32 with -1 empties, positions [n] i64
    mapping global row -> flat bucket slot, cap). The cap rounds to 32, and
    to 256 above 256: the card does not need the TPU's lane alignment, but
    the saved format and ``add``'s growth follow the JAX package's.
    """
    assign = top_ids[:, 0].copy()
    counts = np.bincount(assign, minlength=nlist)
    if cap_limit and counts.max() > cap_limit:
        assign, counts = _rebalance_overflow(
            assign, counts, top_ids, top_scores, cap_limit)
    cap = _round_up(max(int(counts.max()), 32), 32)
    if cap > 256:
        cap = _round_up(cap, 256)
    order = np.argsort(assign, kind="stable")
    bucket_ids = np.full((nlist, cap), -1, dtype=np.int32)
    cluster_of = assign[order]
    # position within cluster = rank among same cluster
    ranks = np.arange(n) - np.concatenate(([0], np.cumsum(counts)))[cluster_of]
    bucket_ids[cluster_of, ranks] = order.astype(np.int32)
    positions = np.empty(n, dtype=np.int64)
    positions[order] = cluster_of.astype(np.int64) * cap + ranks
    return bucket_ids, positions, cap


def _store_rows(rows: torch.Tensor, dtype: str):
    """Normalized f32 rows -> (stored rows, f32 scales or None); int4 gives
    one code per byte, packed once the layout is complete."""
    if dtype == "int8":
        return quantize_rows(rows)
    if dtype == "int4":
        return int4_codes(rows)
    return rows.to(_DTYPES[dtype]), None


def _as_rows(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@dataclass
class IVFIndex:
    """``buckets`` ``[nlist * cap, D]`` (bf16, f32 or int8; int4: ``[nlist *
    cap/2, D]`` split-half packed; a streaming build adds a dummy tail
    bucket), ``bucket_ids`` ``[nlist, cap]`` i32 doc ids (-1 = empty or
    deleted), ``bucket_scales`` ``[nlist, cap]`` f32 for int8 and int4,
    ``refine`` the host f16 copy indexed by doc id (rerank). ``extent``
    ``[nlist]`` int32 beside the ids, one past each bucket's last live slot
    (``ops.ivf_kernel.ivf_extent``: what the float scans read), is derived
    from ``bucket_ids`` whenever an index is made (build, ``add``,
    ``delete``, ``load``) and is not saved."""

    centroids: torch.Tensor
    buckets: torch.Tensor
    bucket_ids: torch.Tensor
    n: int
    cap: int
    cfg: EngineConfig
    bucket_scales: torch.Tensor | None = None
    _next_id: int | None = None              # None = n (no mutations yet)
    refine: np.ndarray | None = None
    extent: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.extent = ivf_extent(self.bucket_ids)

    @classmethod
    def build(cls, vectors, cfg: EngineConfig = EngineConfig(), *, seed: int = 0,
              device: str | torch.device = "cuda") -> "IVFIndex":
        """Build from ``[N, D]`` raw vectors on ``device``. The k-means
        sample and initial rows come from a ``torch.Generator`` seeded with
        ``seed``; the centroid update is deterministic, so one seed gives
        one index."""
        _check_dtype(cfg)
        host_src = vectors if isinstance(vectors, np.ndarray) else None
        v = vectors if isinstance(vectors, torch.Tensor) else torch.as_tensor(
            np.asarray(vectors))
        v32 = v.to(device).float()
        n, d = v32.shape
        nlist = min(cfg.ivf_nlist, max(1, n // 8))
        cosine = cfg.metric == "cosine"
        if cosine:
            v32 = l2_normalize(v32)
        refine = None
        if cfg.dtype in _QUANT and cfg.rerank_factor:
            refine = _refine_copy(host_src, v32, cosine)

        gen = torch.Generator(device=v32.device).manual_seed(seed)
        sample = v32
        if n > cfg.ivf_sample:
            idx = torch.randperm(n, generator=gen, device=v32.device)[:cfg.ivf_sample]
            sample = v32[idx]
        cents = kmeans(sample, gen, nlist=nlist, iters=cfg.ivf_kmeans_iters,
                       balance=cfg.ivf_balance)
        cap_limit = 0
        if cfg.ivf_cap_factor:
            cap_limit = _round_up(max(int(cfg.ivf_cap_factor * n / nlist), 32), 32)
            if cfg.ivf_split_oversized:
                cents = split_oversized(sample, cents, cap_rows=cap_limit, n_total=n,
                                        balance=max(cfg.ivf_balance, 0.1))
        del sample
        top_ids, top_scores = assign_clusters_topr(v32, cents, r=min(8, nlist))
        bucket_ids, _, cap = _plan_layout(top_ids.cpu().numpy(), top_scores.cpu().numpy(),
                                          nlist, n, cap_limit)
        # chunked gather: each chunk is cast or quantized at once, so the f32
        # intermediate stays chunk x D
        flat_rows = torch.as_tensor(bucket_ids.reshape(-1), device=v32.device)
        parts, scales = [], []
        for r in range(0, flat_rows.shape[0], 65536):
            rows = flat_rows[r:r + 65536].long()
            g = torch.where((rows >= 0)[:, None], v32[torch.clamp(rows, min=0)], 0.0)
            stored, sc = _store_rows(g, cfg.dtype)
            parts.append(stored)
            scales.append(sc)
        buckets = torch.cat(parts)
        del parts
        if cfg.dtype == "int4":
            buckets = ivf_pack_slots_int4(buckets, nlist, cap)
        return cls(centroids=cents, buckets=buckets,
                   bucket_ids=torch.as_tensor(bucket_ids, device=v32.device), n=n, cap=cap,
                   cfg=cfg, refine=refine,
                   bucket_scales=(torch.cat(scales).reshape(nlist, cap)
                                  if cfg.dtype in _QUANT else None))

    @classmethod
    def build_streaming(cls, make_chunks, n: int, cfg: EngineConfig = EngineConfig(), *,
                        seed: int = 0, chunk_rows: int = 65536,
                        transfer_dtype: str = "float32", timings: dict | None = None,
                        sample_rows=None,
                        device: str | torch.device = "cuda") -> "IVFIndex":
        """Build without the f32 corpus on the card (port of the JAX
        package's ``build_streaming``).

        ``make_chunks()`` returns a fresh iterator of ``[rows, D]`` chunks
        (host arrays or tensors, at most ``chunk_rows`` rows; only the last
        may be short) and is iterated three times: (1) a stride sample for
        k-means, sliced where the chunk lives; (2) the top-r assignment of
        each chunk, kept on the card and pulled once at the end; (3) each
        chunk normalized, quantized or cast, and scattered into a
        preallocated ``(nlist + 1) * cap`` buffer whose dummy tail bucket
        absorbs the padded rows. Host chunks reach the card through two
        pinned buffers on a side stream (``stream_to_device``), chunk
        ``i+1``'s copy overlapping chunk ``i``'s work. Peak device memory is
        the buckets and a chunk; int4 scatters codes and packs once at the
        end, 1.5x the int8 buffer at the peak. With every row in the
        k-means sample (``n <= cfg.ivf_sample``) the index equals
        ``build(..., seed=seed)`` bucket for bucket, as the in-memory build
        also assigns in blocks of 65,536 rows (``assign_clusters_topr``).

        ``transfer_dtype="bfloat16"`` halves the bytes sent (the math stays
        f32 on the card; assignments and codes may move by a bf16 rounding).
        ``sample_rows`` (sorted int64 row indices -> ``[len, D]`` rows) skips
        pass 1's iteration. ``timings`` receives ``sample_s``, ``kmeans_s``,
        ``assign_s``, ``assign_pull_s``, ``layout_s``, ``scatter_s`` (phase
        ends synchronize the card only when it is given) and ``placement``.
        ``refine`` is not built here."""
        _check_dtype(cfg)
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(transfer_dtype)
        if tdt is None:
            raise ValueError(f"transfer_dtype must be float32|bfloat16, got {transfer_dtype!r}")
        dev = torch.device(device)

        def mark(name, t0):
            if timings is None:
                return t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            if name:
                timings[name] = round(now - t0, 3)
            return now

        t_ph = mark(None, 0.0)
        d = cfg.dim
        nlist = min(cfg.ivf_nlist, max(1, n // 8))
        cosine = cfg.metric == "cosine"

        # pass 1: stride sample for k-means (copies, so no chunk stays alive)
        target = min(cfg.ivf_sample, n)
        stride = max(1, n // target)
        if sample_rows is not None:
            idx = np.arange(0, n, stride, dtype=np.int64)[:target]
            sample = _as_rows(sample_rows(idx))[:target].to(dev)
        else:
            parts, seen = [], 0
            for chunk in make_chunks():
                c = _as_rows(chunk)
                parts.append(c[(-seen) % stride::stride].to(dev, copy=True))
                seen += c.shape[0]
            assert seen == n, f"make_chunks yielded {seen} rows, expected {n}"
            sample = torch.cat(parts)[:target]
            del parts
        sample = l2_normalize(sample.float()) if cosine else sample.float()
        t_ph = mark("sample_s", t_ph)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cents = kmeans(sample, gen, nlist=nlist, iters=cfg.ivf_kmeans_iters,
                       balance=cfg.ivf_balance)
        cap_limit = 0
        if cfg.ivf_cap_factor:
            cap_limit = _round_up(max(int(cfg.ivf_cap_factor * n / nlist), 32), 32)
            if cfg.ivf_split_oversized:
                cents = split_oversized(sample, cents, cap_rows=cap_limit, n_total=n,
                                        balance=max(cfg.ivf_balance, 0.1))
        t_ph = mark("kmeans_s", t_ph)
        del sample

        valid: list[int] = []

        def padded():
            """Each chunk as a ``[chunk_rows, D]`` tensor, zero-padded; its
            valid rows go to ``valid``."""
            for chunk in make_chunks():
                c = _as_rows(chunk)
                valid.append(c.shape[0])
                if c.shape[0] != chunk_rows:
                    c = torch.nn.functional.pad(c, (0, 0, 0, chunk_rows - c.shape[0]))
                yield (c,)

        # pass 2: top-r assignment per chunk; results stay on the card
        r_alt = min(8, nlist)
        ids_parts, score_parts = [], []
        for ci, (x,) in enumerate(stream_to_device(padded(), dev, dtypes=(tdt,))):
            v = x[:valid[ci]].float()
            ti, ts = assign_clusters_topr(l2_normalize(v) if cosine else v, cents, r=r_alt)
            ids_parts.append(ti)
            score_parts.append(ts)
        assert sum(valid) == n, f"make_chunks yielded {sum(valid)} rows, expected {n}"
        t_ph = mark("assign_s", t_ph)
        top_ids = torch.cat(ids_parts).cpu().numpy()
        top_scores = torch.cat(score_parts).cpu().numpy()
        del ids_parts, score_parts
        t_ph = mark("assign_pull_s", t_ph)

        bucket_ids, positions, cap = _plan_layout(top_ids, top_scores, nlist, n, cap_limit)
        if timings is not None:
            # a first-choice row is found whenever its bucket is probed, an
            # alternative-choice row only when the probes reach its fallback,
            # a least-filled fallback row hardly ever
            b_of = (positions // cap).astype(np.int32)
            in_r = top_ids == b_of[:, None]
            rank = np.where(in_r.any(1), in_r.argmax(1), -1)
            timings["placement"] = {
                "first_choice": round(float((rank == 0).mean()), 4),
                "alt_choice": round(float((rank > 0).mean()), 4),
                "fallback": round(float((rank < 0).mean()), 4)}
        del top_ids, top_scores
        t_ph = mark("layout_s", t_ph)

        # pass 3: scatter prepared rows into the bucket buffer, in place
        # (index_copy_; JAX donates the buffer to the same effect). Empty
        # slots keep what the in-memory build gathers for them: a zero row
        # and the scale of a zero row.
        quant = cfg.dtype in _QUANT
        dummy = nlist * cap
        buckets = torch.zeros(((nlist + 1) * cap, d), dtype=_DTYPES[cfg.dtype], device=dev)
        scales = None
        if quant:
            zero_scale = _store_rows(torch.zeros((1, d), device=dev), cfg.dtype)[1]
            scales = zero_scale.expand((nlist + 1) * cap).contiguous()
        pos_all = torch.as_tensor(positions, device=dev)
        row0 = 0
        valid.clear()
        for ci, (x,) in enumerate(stream_to_device(padded(), dev, dtypes=(tdt,))):
            m = valid[ci]
            v = x.float()
            rows, sc = _store_rows(l2_normalize(v) if cosine else v, cfg.dtype)
            pos = torch.full((chunk_rows,), dummy, dtype=torch.int64, device=dev)
            pos[:m] = pos_all[row0:row0 + m]
            buckets.index_copy_(0, pos, rows)
            if quant:
                scales.index_copy_(0, pos, sc)
            row0 += m
        if cfg.dtype == "int4":
            buckets = ivf_pack_slots_int4(buckets, nlist + 1, cap)
        mark("scatter_s", t_ph)
        return cls(centroids=cents, buckets=buckets,       # with the dummy tail bucket
                   bucket_ids=torch.as_tensor(bucket_ids, device=dev), n=n, cap=cap, cfg=cfg,
                   bucket_scales=scales.reshape(nlist + 1, cap)[:nlist] if quant else None)

    # -- search ----------------------------------------------------------------

    @property
    def nlist(self) -> int:
        return self.bucket_ids.shape[0]

    def search(self, queries, k: int | None = None, nprobe: int | None = None, *,
               batched: bool | None = None):
        """Probe search. Returns (scores ``[B, k]`` f32, doc ids ``[B, k]``
        i32) as host tensors; a 1-D query gives 1-D results. ``batched=None``
        picks the layout by ``ops.ivf_kernel.ivf_bucket_major``: on the card
        from the crossover measured per storage type; on the CPU as the JAX
        package does, bucket-major once ``B * nprobe >= 2 * nlist``."""
        k = self.cfg.top_k if k is None else k
        if k > 128:
            raise ValueError(f"k={k} > 128 not supported by the fused kernel")
        nprobe = min(self.cfg.ivf_nprobe if nprobe is None else nprobe, self.nlist)
        queries, squeeze = as_query_batch(queries)
        b = queries.shape[0]
        quant = self.cfg.dtype if self.bucket_scales is not None else "none"
        if batched is None:
            kind = quant if quant != "none" else (
                "f32" if self.buckets.dtype == torch.float32 else "bf16")
            batched = ivf_bucket_major(kind, b, nprobe, self.nlist, self.buckets.is_cuda)
        cosine = self.cfg.metric == "cosine"
        rerank = self.refine is not None and self.cfg.rerank_factor > 0
        kk = max(k, min(128, self.cfg.rerank_factor * k, self.n)) if rerank else k
        q = queries.to(self.centroids.device).float()
        if cosine:
            q = l2_normalize(q)
        pid = exact_topk(q @ self.centroids.T, nprobe)[1].to(torch.int32).contiguous()
        if batched:
            s, i = ivf_batch_search(pid, q, self.buckets, self.bucket_ids, k=kk,
                                    bucket_scales=self.bucket_scales, quant=quant,
                                    extent=self.extent)
        elif quant == "int4":
            s, i = ivf_probe_search_int4(pid, q, self.buckets, self.bucket_ids,
                                         self.bucket_scales, k=kk, extent=self.extent)
        elif quant == "int8":
            s, i = ivf_probe_search_int8(pid, q, self.buckets, self.bucket_ids,
                                         self.bucket_scales, k=kk, extent=self.extent)
        else:
            s, i = ivf_probe_search(pid, q.to(self.buckets.dtype), self.buckets,
                                    self.bucket_ids, k=kk, extent=self.extent)
        s, i = s.cpu(), i.cpu()
        if rerank:
            # refine is indexed by stable doc id, which the scans return
            rs, ri = host_rerank(self.refine, queries.cpu().numpy(), s.numpy(),
                                 i.numpy(), k, cosine)
            s = torch.from_numpy(np.ascontiguousarray(rs, np.float32))
            i = torch.from_numpy(np.ascontiguousarray(ri, np.int32))
        if squeeze:
            return s[0], i[0]
        return s, i

    # -- live add / delete -------------------------------------------------------

    @property
    def next_id(self) -> int:
        """First unused doc id (ids are never reused after delete)."""
        return self.n if self._next_id is None else self._next_id

    @property
    def live(self) -> int:
        """Number of live (non-deleted) docs."""
        return int((self.bucket_ids >= 0).sum())

    def delete(self, doc_ids) -> "IVFIndex":
        """Mask docs by stable id (returns a new index, or this one when no
        id is known). The rows stay on the card but are never scored."""
        gone = np.asarray(doc_ids).reshape(-1).astype(np.int64)
        gone = torch.as_tensor(gone[(gone >= 0) & (gone < 2**31)], dtype=torch.int32,
                               device=self.bucket_ids.device)
        hit = torch.isin(self.bucket_ids, gone) & (self.bucket_ids >= 0)
        if not bool(hit.any()):
            return self
        return replace(self, bucket_ids=torch.where(hit, -1, self.bucket_ids),
                       _next_id=self.next_id)

    def add(self, vectors) -> "IVFIndex":
        """Insert vectors (returns a new index): each goes to its nearest
        centroid, into the first free slot after the bucket's live rows
        (holes left by deletes are compacted away); ``cap`` grows, rounded
        to 32, only when a bucket fills. New docs get consecutive stable ids
        from ``next_id``. int4 buckets are unpacked to slot-ordered codes
        (a nibble cannot be gathered), mutated as codes and repacked."""
        dev = self.buckets.device
        v = vectors if isinstance(vectors, torch.Tensor) else torch.as_tensor(
            np.asarray(vectors))
        v32 = v.to(dev).float()
        m, d = v32.shape
        if self.cfg.metric == "cosine":
            v32 = l2_normalize(v32)
        assign = assign_clusters(v32, self.centroids).cpu().numpy()

        nlist, cap = self.nlist, self.cap
        ids = self.bucket_ids.cpu().numpy()
        used = (ids >= 0).sum(axis=1)
        need = np.bincount(assign, minlength=nlist)
        new_cap = cap
        if (used + need).max() > cap:
            new_cap = _round_up(int((used + need).max()), 32)

        # compact each bucket's live slots to the front, then append
        order = np.argsort(ids < 0, axis=1, kind="stable")    # live first
        ids_c = np.take_along_axis(ids, order, axis=1)
        gather = torch.as_tensor((order + (np.arange(nlist) * cap)[:, None]).reshape(-1),
                                 device=dev)
        int4 = self.cfg.dtype == "int4"
        src = self.buckets
        if int4:
            # a streaming build's dummy tail bucket lies past nlist*cap/2 packed rows
            src = ivf_unpack_slots_int4(self.buckets[: nlist * cap // 2], nlist, cap)
        bk = src[gather].reshape(nlist, cap, d)
        del src
        sc = (self.bucket_scales.reshape(-1)[gather].reshape(nlist, cap)
              if self.bucket_scales is not None else None)
        if new_cap != cap:
            bk = torch.nn.functional.pad(bk, (0, 0, 0, new_cap - cap))
            ids_c = np.pad(ids_c, ((0, 0), (0, new_cap - cap)), constant_values=-1)
            if sc is not None:
                sc = torch.nn.functional.pad(sc, (0, new_cap - cap))

        # slot of the i-th new row: its rank within its bucket after the used slots
        offs = np.zeros(nlist, np.int64)
        slots = np.empty(m, np.int64)
        for i, b in enumerate(assign):
            slots[i] = used[b] + offs[b]
            offs[b] += 1
        flat_pos_np = assign.astype(np.int64) * new_cap + slots
        flat_pos = torch.as_tensor(flat_pos_np, device=dev)

        refine = self.refine
        if refine is not None:
            refine = np.concatenate([refine, v32.cpu().numpy().astype(np.float16)], axis=0)
        bk = bk.reshape(nlist * new_cap, d)
        rows, s_new = _store_rows(v32, self.cfg.dtype)
        bk[flat_pos] = rows
        if int4:
            bk = ivf_pack_slots_int4(bk, nlist, new_cap)
        if sc is not None:
            sc = sc.reshape(-1)
            sc[flat_pos] = s_new
            sc = sc.reshape(nlist, new_cap)
        new_ids = ids_c.reshape(-1).copy()
        new_ids[flat_pos_np] = self.next_id + np.arange(m)
        return replace(
            self, buckets=bk,
            bucket_ids=torch.as_tensor(new_ids.reshape(nlist, new_cap), device=dev),
            bucket_scales=sc, n=self.n + m, cap=new_cap, _next_id=self.next_id + m,
            refine=refine)

    @property
    def nbytes(self) -> int:
        """Device bytes of the buckets, centroids, ids and scales."""
        nb = (self.buckets.numel() * self.buckets.element_size()
              + self.centroids.numel() * 4 + self.bucket_ids.numel() * 4)
        if self.bucket_scales is not None:
            nb += self.bucket_scales.numel() * 4
        return nb

    # -- persistence: the JAX package's files ----------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        buckets = self.buckets.cpu()
        if buckets.dtype == torch.bfloat16:        # npz has no bf16: the raw bits
            buckets = buckets.view(torch.int16).numpy().view(np.uint16)
        else:
            buckets = buckets.numpy()
        arrays = {"centroids": self.centroids.cpu().numpy(), "buckets": buckets,
                  "bucket_ids": self.bucket_ids.cpu().numpy()}
        if self.bucket_scales is not None:
            arrays["bucket_scales"] = self.bucket_scales.cpu().numpy()
        if self.refine is not None:
            arrays["refine"] = self.refine
        np.savez(os.path.join(path, "ivf.npz"), **arrays)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "cap": self.cap, "kind": "ivf",
                       "next_id": self.next_id, "cfg": self.cfg.__dict__}, f)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "IVFIndex":
        """Load an index saved by this class or by the JAX package (bf16
        buckets as uint16 bits or, in older files, as f32)."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig(**{**EngineConfig().__dict__, **meta["cfg"]})
        _check_dtype(cfg)
        z = np.load(os.path.join(path, "ivf.npz"))
        raw = z["buckets"]
        if cfg.dtype == "bfloat16":
            buckets = (torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
                       if raw.dtype == np.uint16
                       else torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16))
        else:
            buckets = torch.from_numpy(raw.astype(
                "int8" if cfg.dtype in _QUANT else cfg.dtype, copy=False))
        return cls(
            centroids=torch.from_numpy(z["centroids"]).to(device),
            buckets=buckets.to(device),
            bucket_ids=torch.from_numpy(z["bucket_ids"]).to(device),
            n=meta["n"], cap=meta["cap"], cfg=cfg,
            bucket_scales=(torch.from_numpy(z["bucket_scales"]).to(device)
                           if "bucket_scales" in z.files else None),
            _next_id=meta.get("next_id"),
            refine=z["refine"] if "refine" in z.files else None)
