"""IVF probe scans with a fused top-k (port of ``mediquery_rag_tpu/ops/ivf_kernel.py``).

Two layouts of the same function, each score the doc rows of the buckets a
query probes and keep its top-k:

- query-major (``ivf_probe_search``, ``ivf_probe_search_int8``,
  ``ivf_probe_search_int4``): every (query, probed bucket) pair is read;
  least latency at small batch;
- bucket-major (``ivf_batch_search``): the probed buckets of the whole
  batch are deduplicated and each is read once for every query that probes
  it; fewer bytes once several queries share buckets.

On CUDA tensors they launch the hand-written kernels of ``csrc/ivf_topk.cu``
(replacing the Pallas ``_ivf_kernel``, ``_ivf_int8_kernel``,
``_ivf_int4_kernel``, ``_ivf_batch_kernel``, ``_ivf_batch_int8_kernel`` and
``_ivf_batch_int4_kernel``; the float kernels over bf16 or f32 buckets, as
the Pallas ones take the storage dtype as given). All of them, both layouts
and every storage type, are one Hopper scan (``csrc/ivf_scan.cuh``) that
walks work items (:func:`ivf_scan_plan`, :func:`ivf_items`) and reads only
each bucket's live extent (:func:`ivf_extent`); the host prepares its
positions, and for the bucket-major layout its gathered queries (int4: and
corr), in :func:`ivf_scan_inputs`. :func:`ivf_bucket_major` picks the
layout for ``IVFIndex.search``. On CPU tensors they run the ``*_plain``
versions, which do the same f32 arithmetic with the gather done in chunks
of probes or buckets. int4 buckets are split-half packed
(``ops/quant.py:ivf_pack_slots_int4``): ``[nlist * cap/2, D]`` bytes whose
packed row ``j`` holds slots ``j`` and ``j + cap/2`` of its bucket.

Both layouts and the plain versions order results by (score desc, doc id
asc); the JAX kernels put an equal score that enters before the incumbents,
so their order among exact ties follows the order of visits. Slots whose id
is -1 (empty or deleted) score -inf; short results are (-inf, id 0). The
probe ids of one query must be distinct (``IVFIndex.search`` takes them
from a top-k). Queries are quantized outside the kernels and the per-query
scale multiplies only the k returned scores.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mediquery_rag_tpu_torch.ops import _build
from mediquery_rag_tpu_torch.ops.quant import quantize_rows
from mediquery_rag_tpu_torch.ops.scoring import (
    _SCAN_MAX_STAGES, LANE, SCAN_TILE, _scan_smem, pad_short)
from mediquery_rag_tpu_torch.ops.topk import exact_topk

_PLAIN_ELEMS = 1 << 26    # gathered bucket elements per chunk in the plain versions
_NEG_INF = float("-inf")


# -- plain versions ----------------------------------------------------------------

def _top_by_score_id(s: torch.Tensor, i: torch.Tensor, k: int):
    """Top-k of each row under (score desc, id asc): a stable sort by id,
    then a stable sort by score."""
    o = torch.sort(i, dim=-1, stable=True).indices
    s, i = torch.gather(s, -1, o), torch.gather(i, -1, o)
    vals, pos = exact_topk(s, k)
    return vals, torch.gather(i, -1, pos)


def _fold(run, s, i, k):
    """Merge candidates ``[B, m]`` into the running top-k ``(s, i)``."""
    if run is not None:
        s, i = torch.cat([run[0], s], dim=1), torch.cat([run[1], i], dim=1)
    return _top_by_score_id(s, i, k)


def _rows_score(q: torch.Tensor, rows: torch.Tensor, scale) -> torch.Tensor:
    """Scores of queries against bucket rows, summed in f64 and rounded to
    f32: products of f32, bf16 or int8 values are exact in f64 and the sum's
    error is far below an f32 ulp, so the rounded score does not depend on
    the shape of the product (the query-major and bucket-major plain
    versions agree to the bit); int8 sums are exact and
    then times the row scale in f32, as the kernels do."""
    s = q.double().matmul(rows.double().transpose(-1, -2)).float()
    return s if scale is None else s * scale


def _int4_slots(du, dp, corr, s2):
    """Slot-ordered int4 scores ``[..., cap]`` from the packed rows' exact
    integer dots ``du`` = q8 . (p & 15) and ``dp`` = q8 . p (f32 ``[...,
    cap/2]``), ``corr`` = 8 sum(q8) and the scale planes ``s2`` ``[..., 2,
    cap/2]``, broadcast: ``[even | odd]`` in the f32 order of the kernels."""
    even = (du - corr) * s2[..., 0, :]
    odd = (dp - du) * s2[..., 1, :] * 0.0625
    return torch.cat([even, odd], dim=-1)


def _probe_plain(probe_ids, bucket_ids, row_elems, k, score):
    """Query-major plain scan: ``score(pid [B, p])`` gives the slot-ordered
    scores ``[B, p, cap]`` of each query's probed buckets ``pid``."""
    b, nprobe = probe_ids.shape
    cap = bucket_ids.shape[1]
    pc = max(1, _PLAIN_ELEMS // max(1, b * cap * row_elems))
    run = None
    for j in range(0, nprobe, pc):
        pid = probe_ids[:, j:j + pc].long()                    # [B, p]
        ids = bucket_ids[pid].reshape(b, -1)                   # [B, p*cap]
        s = score(pid).reshape(b, -1)
        run = _fold(run, torch.where(ids >= 0, s, _NEG_INF), ids, k)
    return pad_short(*run, k)


def _float_probe_score(q, buckets, bucket_ids, scales):
    nlist, cap = bucket_ids.shape
    bk = buckets[: nlist * cap].reshape(nlist, cap, -1)

    def score(pid):
        b = pid.shape[0]
        sc = None if scales is None else scales[pid].reshape(b, 1, -1)
        rows = bk[pid].reshape(b, -1, bk.shape[-1])             # [B, p*cap, D]
        return _rows_score(q[:, None, :], rows, sc)[:, 0]
    return score


def _int4_buckets(buckets, bucket_ids, bucket_scales):
    """Packed rows ``[nlist, cap/2, D]`` (a streaming build's dummy tail
    bucket cut off) and scale planes ``[nlist, 2, cap/2]``."""
    nlist, cap = bucket_ids.shape
    bk = buckets[: nlist * cap // 2].reshape(nlist, cap // 2, -1)
    return bk, bucket_scales.reshape(nlist, 2, cap // 2)


def ivf_probe_search_plain(probe_ids, queries, buckets, bucket_ids, k):
    """Plain version of B8a: ``queries`` in the buckets' float type."""
    return _probe_plain(probe_ids, bucket_ids, buckets.shape[1], k,
                        _float_probe_score(queries, buckets, bucket_ids, None))


def ivf_probe_search_int8_plain(probe_ids, q8, buckets, bucket_ids, bucket_scales, k):
    """Plain version of B8b: int8 queries, scores without the query scale."""
    return _probe_plain(probe_ids, bucket_ids, buckets.shape[1], k,
                        _float_probe_score(q8, buckets, bucket_ids, bucket_scales))


def ivf_probe_search_int4_plain(probe_ids, q8, corr, buckets, bucket_ids, bucket_scales, k):
    """Plain version of B8c: int8 queries and ``corr`` = 8 sum(q8) ``[B]``
    over split-half packed buckets; exact integer dots (f64), the kernels'
    f32 epilogue, scores without the query scale."""
    bk, s2 = _int4_buckets(buckets, bucket_ids, bucket_scales)
    qd = q8.double()[:, None, :, None]                          # [B, 1, D, 1]

    def score(pid):
        rows = bk[pid]                                          # [B, p, cap/2, D]
        du = (rows & 15).double().matmul(qd)[..., 0].float()
        dp = rows.double().matmul(qd)[..., 0].float()
        return _int4_slots(du, dp, corr[:, None, None], s2[pid])
    return _probe_plain(probe_ids, bucket_ids, buckets.shape[1], k, score)


def _batch_plain(probe_ids, uniq, bucket_ids, row_elems, k, score):
    """Bucket-major plain scan: ``score(ub [u])`` gives the slot-ordered
    scores ``[B, u, cap]`` of every query against buckets ``ub``; rows of
    queries that do not probe a bucket (and -1 pads of ``uniq``) are masked."""
    b = probe_ids.shape[0]
    cap = bucket_ids.shape[1]
    uc = max(1, _PLAIN_ELEMS // max(1, cap * row_elems))
    uniq = uniq.long()
    run = None
    for u in range(0, uniq.shape[0], uc):
        us = uniq[u:u + uc]
        ub = torch.clamp(us, min=0)
        ids = bucket_ids[ub]                                   # [u, cap]
        s = score(ub)                                          # [B, u, cap]
        probed = (probe_ids[:, :, None] == us[None, None, :]).any(dim=1)  # [B, u]
        keep = probed[:, :, None] & (ids >= 0)[None] & (us >= 0)[None, :, None]
        s = torch.where(keep, s, _NEG_INF)
        run = _fold(run, s.reshape(b, -1), ids[None].expand(b, -1, -1).reshape(b, -1), k)
    return pad_short(*run, k)


def ivf_batch_search_plain(probe_ids, uniq, queries, buckets, bucket_ids,
                           bucket_scales, k):
    """Plain version of B9a/B9b: each bucket of ``uniq`` (-1 = pad) scored
    for the whole batch, rows of queries that do not probe it masked."""
    nlist, cap = bucket_ids.shape
    b, d = queries.shape
    bk = buckets[: nlist * cap].reshape(nlist, cap, d)

    def score(ub):
        sc = None if bucket_scales is None else bucket_scales[ub].reshape(1, -1)
        return _rows_score(queries, bk[ub].reshape(-1, d), sc).reshape(b, -1, cap)
    return _batch_plain(probe_ids, uniq, bucket_ids, d, k, score)


def ivf_batch_search_int4_plain(probe_ids, uniq, q8, corr, buckets, bucket_ids,
                                bucket_scales, k):
    """Plain version of B9c: B8c's arithmetic, bucket-major."""
    bk, s2 = _int4_buckets(buckets, bucket_ids, bucket_scales)
    b, d = q8.shape
    qd = q8.double()

    def score(ub):
        rows = bk[ub].reshape(-1, d)                            # [u*cap/2, D]
        du = qd.matmul((rows & 15).double().T).float().reshape(b, ub.shape[0], -1)
        dp = qd.matmul(rows.double().T).float().reshape(b, ub.shape[0], -1)
        return _int4_slots(du, dp, corr[:, None, None], s2[ub][None])
    return _batch_plain(probe_ids, uniq, bucket_ids, d, k, score)


# -- the Hopper IVF scan's plan (B8a-B9c) ----------------------------------------------

_QBS = (16, 32, 64, 128)          # probers a bucket-major chunk may take (wgmma N)
# the most a chunk of each kind may take: the largest instance its bucket-major
# C entry compiles (the QBMAX of its ivf_scan<Stage, QBMAX> in csrc/ivf_topk.cu;
# Int8Stage<128> and Int4Ivf<64> spill and were 2x and 1.6x slower)
_QB_MAX = {"bf16": 128, "f32": 128, "int8": 64, "int4": 32}
_ROW_BYTES = {"bf16": 2, "f32": 4, "int8": 1, "int4": 1}   # bytes of a row per dimension
_ITEMS_TARGET = 16 * _build.SMS   # work items a launch aims at: short ones even out the tail
_SCHED_SMEM = 72                  # the item queue's shared memory (SCHED_SMEM, ivf_scan.cuh)


def ivf_extent(bucket_ids: torch.Tensor) -> torch.Tensor:
    """One past each bucket's last live slot, ``[nlist]`` int32 on the ids'
    device (0 for an empty bucket): the slots the float scans read. A
    build or an ``add`` packs a bucket's live rows at its front; a
    ``delete`` leaves holes inside the extent (or shortens it)."""
    cap = bucket_ids.shape[1]
    slot = torch.arange(1, cap + 1, dtype=torch.int32, device=bucket_ids.device)
    return torch.where(bucket_ids >= 0, slot, 0).amax(dim=1).to(torch.int32)


class IVFPlan(NamedTuple):
    """How the Hopper IVF scan cuts one search (:func:`ivf_scan_plan`):
    chunks of at most ``qb`` probers of one bucket (query-major: one), each
    bucket's live tiles cut into ``maxp`` pieces, work item (chunk, piece),
    drawn in order from a counter; a ring of ``stages`` stages, each a
    128-row panel of the buckets and the chunk's query panel; ``grid``
    persistent blocks of ``smem`` bytes. ``caph``: int4's cap / 2 (packed
    row ``r`` of a bucket holds its slots ``r`` and ``r + caph``; the live
    tiles are of ``min(extent, caph)`` packed rows), 0 for the other kinds."""
    qb: int
    stages: int
    maxp: int
    grid: int
    smem: int
    caph: int = 0


@functools.lru_cache(maxsize=None)
def ivf_scan_plan(kind: str, b: int, nprobe: int, d: int, cap: int, k: int,
                  bucket_major: bool, distinct: int | None = None) -> IVFPlan:
    """The plan of a ``kind`` (``bf16``, ``f32``, ``int8``, ``int4``) IVF
    scan of ``b`` queries probing ``nprobe`` buckets of ``cap`` slots each
    (int4: ``cap/2`` packed rows of D bytes). Query-major: a chunk per
    prober (16 query columns, one live). Bucket-major: the fewest probers a
    chunk (16 to ``_QB_MAX[kind]``) that hold ``b`` (bf16, f32: a bucket
    read once for all its probers while ``b <= qb``), or for int8/int4 that
    hold a bucket's mean run of probers, ``b * nprobe / distinct`` (each
    thread filters every column of its tiles, live or not, and their
    filter, not their bytes, bounds them: at nprobe 32 over 1,024 buckets
    16 columns beat 32 and 64 at B = 64 and 256), halved while a 4-stage
    ring with the lists does not fit. Then as many ring stages (up to 8) as
    fit, and pieces of each bucket for the chunks the launch may have
    (``distinct``: at most this many probed buckets): bf16/f32 enough that
    the launch has about ``_ITEMS_TARGET`` items; int8/int4 the fewest, a
    power of two, that give every SM an item (each item starts its lists
    empty, and at k = 40 filling them costs more than a tile); no more
    pieces than a half-full bucket has 128-row tiles. One block per SM,
    fewer if there are fewer items. At B = 1 the bucket-major chunks are
    the query-major ones (a prober each)."""
    row_bytes = d * _ROW_BYTES[kind]
    caph = cap // 2 if kind == "int4" else 0
    if row_bytes % 16 or not 1 <= k <= LANE or cap % 32 or b < 1 or nprobe < 1:
        raise ValueError(f"IVF scan: {kind} rows of a multiple of 16 bytes, 1 <= k <= {LANE}, "
                         f"cap % 32 == 0; got D={d}, k={k}, cap={cap}")

    def smem(qb, stages):
        return _scan_smem(qb, row_bytes, k, stages, True) + _SCHED_SMEM

    qbs = [q for q in _QBS if q <= _QB_MAX[kind]]
    qb = qbs[0]
    n_pos = b * nprobe
    if bucket_major:
        run = -(-n_pos // (distinct or n_pos)) if kind in ("int8", "int4") else b
        qb = next((q for q in qbs if q >= run), qbs[-1])
        while qb > _QBS[0] and smem(qb, 4) > _build.SMEM_PER_BLOCK:
            qb //= 2
    fits = [st for st in range(2, _SCAN_MAX_STAGES + 1) if smem(qb, st) <= _build.SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"IVF scan: D={d}, k={k} do not fit a block's shared memory")
    chunks = n_pos
    if bucket_major:
        chunks = min(n_pos, (distinct or n_pos) * -(-b // qb))
    if kind in ("int8", "int4"):      # the fewest pieces, a power of two, for an item an SM
        want = 1 << (-(-_build.SMS // chunks) - 1).bit_length()
    else:
        want = -(-_ITEMS_TARGET // chunks)
    # a bucket's live tiles, taken as half its rows (a build rounds the cap up
    # past the fullest bucket): more pieces would be empty items
    rows = caph or cap
    maxp = max(1, min(-(-rows // (2 * SCAN_TILE)), want))
    return IVFPlan(qb, fits[-1], maxp, max(1, min(_build.SMS, n_pos * maxp)),
                   smem(qb, fits[-1]), caph)


def ivf_chunks_plain(pos_bucket: torch.Tensor, qb: int) -> tuple[torch.Tensor, int]:
    """Plain version of the bucket-major chunk plan (``chunk_plan`` of
    ``csrc/ivf_scan.cuh``): from the probed buckets sorted by bucket, the
    first position of every chunk (a new chunk at each bucket's first
    position and every ``qb`` positions after it), ``[n_pos]`` int32 whose
    first ``n_chunks`` entries are set, and ``n_chunks``."""
    n = pos_bucket.shape[0]
    idx = torch.arange(n)
    sb = pos_bucket.cpu()
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = sb[1:] != sb[:-1]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    heads = idx[(idx - start) % qb == 0]
    out = torch.zeros(n, dtype=torch.int32)
    out[:heads.shape[0]] = heads.to(torch.int32)
    return out, int(heads.shape[0])


def ivf_chunks_cuda(pos_bucket: torch.Tensor, qb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the chunk plan alone on the card (as the bucket-major float
    scans launch it): ``(chunk_e0 [n_pos], n_chunks [1])`` int32."""
    if pos_bucket.dtype != torch.int32 or not pos_bucket.is_cuda or pos_bucket.dim() != 1:
        raise ValueError("ivf_chunks_cuda takes a 1-D int32 CUDA tensor")
    pos_bucket = pos_bucket.contiguous()
    e0 = torch.empty_like(pos_bucket)
    n = torch.empty(1, dtype=torch.int32, device=pos_bucket.device)
    lib = _build.load("ivf_topk")
    _build.launch("ivf_chunk_plan", lib.ivf_chunk_plan, pos_bucket, pos_bucket.data_ptr(),
                  pos_bucket.shape[0], qb, e0.data_ptr(), n.data_ptr())
    return e0, n


def ivf_items(plan: IVFPlan, pos_bucket, pos_prober, chunk_e0, n_chunks: int, extent,
              nprobe: int) -> list[tuple]:
    """The work items of one launch in the order the kernel numbers them
    (``item`` of ``csrc/ivf_scan.cuh``: item ``it`` is piece ``it //
    n_chunks`` of chunk ``it % n_chunks``): ``(probers, bucket, piece, rows
    [r0, r1), query row)``, each prober ``b * nprobe + j`` at the item's
    ``nq`` positions, the bucket rows of the piece's tiles cut at the
    bucket's extent: slots, or for int4 (``plan.caph``) packed rows cut at
    ``min(extent, caph)``, covering slots ``[r0, r1)`` and ``[r0 + caph, r1
    + caph)`` below the extent. ``chunk_e0`` None: query-major (a chunk per
    position, its query row the prober's query); ``pos_prober`` None: the
    identity."""
    pos_bucket = pos_bucket.tolist()
    n_pos = len(pos_bucket)
    pos_prober = list(range(n_pos)) if pos_prober is None else pos_prober.tolist()
    extent = extent.tolist()
    e0s = chunk_e0.tolist() if chunk_e0 is not None else None
    items = []
    for it in range(n_chunks * plan.maxp):
        p, h = divmod(it, n_chunks)
        if e0s is None:
            e0, nq, qrow = h, 1, pos_prober[h] // nprobe
        else:
            e0 = e0s[h]
            nq = (e0s[h + 1] if h + 1 < n_chunks else n_pos) - e0
            qrow = e0
        u = pos_bucket[e0]
        rows = min(extent[u], plan.caph) if plan.caph else extent[u]
        nt = -(-rows // SCAN_TILE)
        t0, t1 = p * nt // plan.maxp, (p + 1) * nt // plan.maxp
        items.append((pos_prober[e0:e0 + nq], u, p,
                      (t0 * SCAN_TILE, min(t1 * SCAN_TILE, rows)), qrow))
    return items


# -- CUDA launchers ------------------------------------------------------------------

_MAX_LISTS = 227 * 1024 // 4  # pass 2 keeps one int per partial list in shared memory


def _check(what, k, rows, bucket_ids, probe_ids, d_mult, dtype, *others, packed=False):
    d = rows.shape[1]
    if not 1 <= k <= LANE:
        raise ValueError(f"{what} takes 1 <= k <= {LANE}, got {k}")
    if rows.dtype != dtype:
        raise ValueError(f"{what} takes {dtype} buckets, got {rows.dtype}")
    nlist, cap = bucket_ids.shape
    need = nlist * cap // 2 if packed else nlist * cap
    if d % d_mult or cap % 32 or rows.shape[0] < need:
        raise ValueError(f"{what} needs D % {d_mult} == 0, cap % 32 == 0 and "
                         f"{'nlist*cap/2' if packed else 'nlist*cap'} rows, got D={d} "
                         f"cap={cap} rows={rows.shape[0]}")
    if bucket_ids.dtype != torch.int32 or probe_ids.dtype != torch.int32:
        raise ValueError(f"{what} takes int32 bucket and probe ids")
    for t in (rows, bucket_ids, probe_ids, *others):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} operands must be contiguous, 16-byte "
                             "aligned CUDA tensors")


_sched: dict = {}    # (device, stream) -> the IVF scans' item counters


def _sched_counters(dev, stream: int) -> torch.Tensor:
    """The IVF scans' [next item, blocks done] on ``dev`` for ``stream``:
    zeroed once here; each launch leaves them zero (its last block resets
    them), so launches on one stream share them in turn."""
    key = (dev, stream)
    if key not in _sched:
        _sched[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _sched[key]


class ScanInputs(NamedTuple):
    """What the host hands one Hopper IVF scan (:func:`ivf_scan_inputs`):
    the probed bucket at each position ``[B*nprobe]`` int32, the prober
    ``b * nprobe + j`` there ``[B*nprobe]`` int64 (None: the identity), the
    query rows the kernel's chunks read, and int4's ``corr`` in the same
    row order (None for the other kinds)."""
    pos_bucket: torch.Tensor
    pos_prober: torch.Tensor | None
    queries: torch.Tensor
    corr: torch.Tensor | None


def ivf_scan_inputs(probe_ids, queries, corr=None, *, bucket_major: bool) -> ScanInputs:
    """The positions of one IVF scan and its query rows: positions sorted
    by bucket (stable), but at B = 1, where no bucket repeats, the probe ids
    in order, each its own chunk in both layouts (no sort, no gather).
    Query-major: the queries (and ``corr`` ``[B]``) as given, each chunk
    reading its prober's query row. Bucket-major (B > 1): a chunk's column
    ``c`` reads row ``e0 + c`` of the map, so the queries and int4's
    ``corr`` are gathered in position order, row ``e`` of both being query
    ``pos_prober[e] // nprobe``; ``corr`` in query order would hand every
    column past the first another query's correction. Runs on any device."""
    b, nprobe = probe_ids.shape
    flat = probe_ids.reshape(-1)
    if b == 1:
        return ScanInputs(flat, None, queries, corr)
    pos_bucket, pos_prober = torch.sort(flat, stable=True)
    if not bucket_major:
        return ScanInputs(pos_bucket, pos_prober, queries, corr)
    rows = pos_prober // nprobe
    return ScanInputs(pos_bucket, pos_prober, queries.index_select(0, rows),
                      None if corr is None else corr.index_select(0, rows))


def _scan_launch(what, fn, kind, probe_ids, queries, buckets, bucket_ids, extent, k,
                 bucket_major, scales=None, corr=None):
    """The Hopper IVF scan (B8a, B9a over bf16 or f32 buckets; B8b, B9b over
    int8; B8c, B9c over int4): the inputs of :func:`ivf_scan_inputs`, then
    the C entry (its chunk plan, pass 1, pass 2). ``scales``: the int8/int4
    slot scales, ``corr``: int4's ``[B]``, passed after the item counters.
    ``extent``: the buckets' live extent (:func:`ivf_extent`), computed here
    when None. One allocation holds pass 1's lists and the results."""
    b, nprobe = probe_ids.shape
    nlist, cap = bucket_ids.shape
    d = buckets.shape[1]
    dev = buckets.device
    if queries.shape != (b, d):
        raise ValueError(f"{what}: queries must be [B, D] = [{b}, {d}], got "
                         f"{list(queries.shape)}")
    plan = ivf_scan_plan(kind, b, nprobe, d, cap, k, bucket_major, min(b * nprobe, nlist))
    if extent is None:
        extent = ivf_extent(bucket_ids)
    elif (extent.dtype != torch.int32 or extent.shape != (nlist,) or extent.device != dev
          or not extent.is_contiguous()):
        raise ValueError(f"{what}: extent must be a contiguous int32 [nlist] tensor on the "
                         "buckets' device")
    lists = nprobe * plan.maxp
    if lists > _MAX_LISTS:
        raise ValueError(f"nprobe * pieces = {lists} partial lists per query; "
                         f"the merge takes at most {_MAX_LISTS}")
    inp = ivf_scan_inputs(probe_ids, queries, corr, bucket_major=bucket_major)
    n_part, n_out = b * lists * k, b * k
    buf = torch.empty(2 * (n_part + n_out), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    chunk_ptrs = [None, None] if bucket_major else []
    if bucket_major and b > 1:       # chunks of a bucket's run of positions
        chunks = torch.empty(b * nprobe + 1, dtype=torch.int32, device=dev)   # e0s, count
        chunk_ptrs = [chunks.data_ptr(), chunks.data_ptr() + 4 * b * nprobe]
    extra = [t.data_ptr() for t in (scales, inp.corr) if t is not None]
    stream = _build.stream_ptr(buckets)
    q = inp.queries
    _build.launch(what, fn, buckets, q.data_ptr(), q.shape[0], buckets.data_ptr(),
                  buckets.shape[0], bucket_ids.data_ptr(), extent.data_ptr(),
                  inp.pos_bucket.data_ptr(),
                  None if inp.pos_prober is None else inp.pos_prober.data_ptr(), *chunk_ptrs,
                  _sched_counters(dev, stream).data_ptr(), *extra, b, d, cap, nprobe,
                  plan.qb, plan.stages, plan.maxp, plan.grid, k, base, base + 4 * n_part,
                  base + 8 * n_part, base + 8 * n_part + 4 * n_out)
    out = buf[2 * n_part:]
    return out[:n_out].view(torch.float32).view(b, k), out[n_out:].view(b, k)


def ivf_probe_topk_cuda(probe_ids, queries, buckets, bucket_ids, k, *, extent=None):
    """Launch ``ivf_probe_topk`` (B8a): bf16 queries ``[B, D]`` over bf16
    buckets ``[nlist*cap, D]`` -> (scores, doc ids) ``[B, k]``; ``extent``
    as :func:`ivf_extent` gives it (computed when None)."""
    _check("ivf_probe_topk", k, buckets, bucket_ids, probe_ids, 8, torch.bfloat16,
           queries)
    if queries.dtype != torch.bfloat16:
        raise ValueError("ivf_probe_topk takes bf16 queries")
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_probe_topk", lib.ivf_probe_topk, "bf16", probe_ids, queries,
                       buckets, bucket_ids, extent, k, False)
    ivf_probe_topk_cuda.launches += 1
    return out


ivf_probe_topk_cuda.launches = 0


def ivf_probe_topk_f32_cuda(probe_ids, queries, buckets, bucket_ids, k, *, extent=None):
    """Launch ``ivf_probe_topk_f32`` (B8a over f32 buckets): f32 queries
    ``[B, D]`` over f32 buckets ``[nlist*cap, D]``, f32 sums on the CUDA
    cores -> (scores, doc ids) ``[B, k]``; ``extent`` as for
    :func:`ivf_probe_topk_cuda`."""
    _check("ivf_probe_topk_f32", k, buckets, bucket_ids, probe_ids, 4, torch.float32,
           queries)
    if queries.dtype != torch.float32:
        raise ValueError("ivf_probe_topk_f32 takes f32 queries")
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_probe_topk_f32", lib.ivf_probe_topk_f32, "f32", probe_ids,
                       queries, buckets, bucket_ids, extent, k, False)
    ivf_probe_topk_f32_cuda.launches += 1
    return out


ivf_probe_topk_f32_cuda.launches = 0


def _check_scales(what, bucket_ids, bucket_scales):
    if bucket_scales.dtype != torch.float32 or bucket_scales.numel() != bucket_ids.numel():
        raise ValueError(f"{what} takes f32 slot scales [nlist, cap]")


def ivf_probe_topk_int8_cuda(probe_ids, q8, buckets, bucket_ids, bucket_scales, k, *,
                             extent=None):
    """Launch ``ivf_probe_topk_int8`` (B8b): int8 queries ``[B, D]`` over
    int8 buckets ``[nlist*cap, D]`` with f32 slot scales ``[nlist, cap]``
    -> (scores, doc ids) ``[B, k]``; scores carry no query scale.
    ``extent`` as for :func:`ivf_probe_topk_cuda`."""
    _check("ivf_probe_topk_int8", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, bucket_scales)
    if q8.dtype != torch.int8:
        raise ValueError("ivf_probe_topk_int8 takes int8 queries")
    _check_scales("ivf_probe_topk_int8", bucket_ids, bucket_scales)
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_probe_topk_int8", lib.ivf_probe_topk_int8, "int8", probe_ids, q8,
                       buckets, bucket_ids, extent, k, False, bucket_scales)
    ivf_probe_topk_int8_cuda.launches += 1
    return out


ivf_probe_topk_int8_cuda.launches = 0


def ivf_probe_topk_int4_cuda(probe_ids, q8, corr, buckets, bucket_ids, bucket_scales, k, *,
                             extent=None):
    """Launch ``ivf_probe_topk_int4`` (B8c): int8 queries ``[B, D]`` and
    ``corr`` = 8 sum(q8) ``[B]`` f32 over split-half packed int4 buckets
    ``[nlist*cap/2, D]`` with f32 slot scales ``[nlist, cap]`` -> (scores,
    doc ids) ``[B, k]``; scores carry no query scale. ``extent`` (in slots)
    as for :func:`ivf_probe_topk_cuda`."""
    _check("ivf_probe_topk_int4", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, corr, bucket_scales, packed=True)
    if q8.dtype != torch.int8 or corr.dtype != torch.float32 or corr.shape != q8.shape[:1]:
        raise ValueError("ivf_probe_topk_int4 takes int8 queries and f32 corr [B]")
    _check_scales("ivf_probe_topk_int4", bucket_ids, bucket_scales)
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_probe_topk_int4", lib.ivf_probe_topk_int4, "int4", probe_ids, q8,
                       buckets, bucket_ids, extent, k, False, bucket_scales, corr)
    ivf_probe_topk_int4_cuda.launches += 1
    return out


ivf_probe_topk_int4_cuda.launches = 0


def ivf_batch_topk_cuda(probe_ids, uniq, queries, buckets, bucket_ids, k, *, extent=None):
    """Launch ``ivf_batch_topk`` (B9a): bucket-major over bf16 buckets, each
    probed bucket's live rows read once for up to 128 of its probers.
    ``uniq``, the sorted probed bucket ids (-1 padded) that the plain
    versions walk, is taken for the common call shape and not read (may be
    None): the scan sorts the probes itself. ``extent`` as for
    :func:`ivf_probe_topk_cuda`."""
    _check("ivf_batch_topk", k, buckets, bucket_ids, probe_ids, 8, torch.bfloat16, queries)
    if queries.dtype != torch.bfloat16:
        raise ValueError("ivf_batch_topk takes bf16 queries")
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_batch_topk", lib.ivf_batch_topk, "bf16", probe_ids, queries,
                       buckets, bucket_ids, extent, k, True)
    ivf_batch_topk_cuda.launches += 1
    return out


ivf_batch_topk_cuda.launches = 0


def ivf_batch_topk_f32_cuda(probe_ids, uniq, queries, buckets, bucket_ids, k, *, extent=None):
    """Launch ``ivf_batch_topk_f32`` (B9a over f32 buckets): bucket-major,
    f32 sums on the CUDA cores over the chunk's live query groups; ``uniq``
    and ``extent`` as for :func:`ivf_batch_topk_cuda`."""
    _check("ivf_batch_topk_f32", k, buckets, bucket_ids, probe_ids, 4, torch.float32, queries)
    if queries.dtype != torch.float32:
        raise ValueError("ivf_batch_topk_f32 takes f32 queries")
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_batch_topk_f32", lib.ivf_batch_topk_f32, "f32", probe_ids,
                       queries, buckets, bucket_ids, extent, k, True)
    ivf_batch_topk_f32_cuda.launches += 1
    return out


ivf_batch_topk_f32_cuda.launches = 0


def ivf_batch_topk_int8_cuda(probe_ids, uniq, q8, buckets, bucket_ids, bucket_scales, k, *,
                             extent=None):
    """Launch ``ivf_batch_topk_int8`` (B9b): bucket-major over int8 buckets,
    each probed bucket's live rows read once for up to 64 of its probers;
    scores carry no query scale. ``uniq`` and ``extent`` as for
    :func:`ivf_batch_topk_cuda`."""
    _check("ivf_batch_topk_int8", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, bucket_scales)
    if q8.dtype != torch.int8:
        raise ValueError("ivf_batch_topk_int8 takes int8 queries")
    _check_scales("ivf_batch_topk_int8", bucket_ids, bucket_scales)
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_batch_topk_int8", lib.ivf_batch_topk_int8, "int8", probe_ids, q8,
                       buckets, bucket_ids, extent, k, True, bucket_scales)
    ivf_batch_topk_int8_cuda.launches += 1
    return out


ivf_batch_topk_int8_cuda.launches = 0


def ivf_batch_topk_int4_cuda(probe_ids, uniq, q8, corr, buckets, bucket_ids, bucket_scales, k,
                             *, extent=None):
    """Launch ``ivf_batch_topk_int4`` (B9c): bucket-major over split-half
    packed int4 buckets, each probed bucket's live packed rows read once for
    up to 32 of its probers; ``corr`` = 8 sum(q8) ``[B]`` in query order
    (gathered with the queries by :func:`ivf_scan_inputs`); scores carry no
    query scale. ``uniq`` and ``extent`` (in slots) as for
    :func:`ivf_batch_topk_cuda`."""
    _check("ivf_batch_topk_int4", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, corr, bucket_scales, packed=True)
    if q8.dtype != torch.int8 or corr.dtype != torch.float32 or corr.shape != q8.shape[:1]:
        raise ValueError("ivf_batch_topk_int4 takes int8 queries and f32 corr [B]")
    _check_scales("ivf_batch_topk_int4", bucket_ids, bucket_scales)
    lib = _build.load("ivf_topk")
    out = _scan_launch("ivf_batch_topk_int4", lib.ivf_batch_topk_int4, "int4", probe_ids, q8,
                       buckets, bucket_ids, extent, k, True, bucket_scales, corr)
    ivf_batch_topk_int4_cuda.launches += 1
    return out


ivf_batch_topk_int4_cuda.launches = 0


# -- the layout rule -------------------------------------------------------------------

# The least batch from which the bucket-major layout is the faster on the card
# (bf16: ties at 16, within 1%), per storage type, at the shape where it was
# measured: nlist 1,024, nprobe 32 (chip_smoke.py phase 3c's crossover table,
# PERF.md section 6; int8 and int4 lose by 10-13% at B = 16).
_BUCKET_MAJOR_FROM = {"bf16": 16, "f32": 16, "int8": 32, "int4": 32}
_MEASURED_NLIST, _MEASURED_NPROBE = 1024, 32


def ivf_layout_threshold(kind: str, nprobe: int, nlist: int) -> int:
    """The least batch ``B`` from which :func:`ivf_bucket_major` takes the
    bucket-major layout on the card for a ``kind`` (``bf16``, ``f32``,
    ``int8``, ``int4``) index: the measured crossover at the same probes per
    bucket, ``B * nprobe / nlist``, as at the shape it was measured; never
    below 2 (at B = 1 both layouts run the same chunks)."""
    num = _BUCKET_MAJOR_FROM[kind] * _MEASURED_NPROBE * nlist
    return max(2, -(-num // (_MEASURED_NLIST * nprobe)))


def ivf_bucket_major(kind: str, b: int, nprobe: int, nlist: int, on_card: bool) -> bool:
    """Whether ``IVFIndex.search`` takes the bucket-major layout for ``b``
    queries: on the card from :func:`ivf_layout_threshold`; on the CPU the
    JAX package's rule, ``B * nprobe >= 2 * nlist``
    (``mediquery_rag_tpu/engine/ivf.py:558``), so that the plain versions
    walk the layout JAX does."""
    if not on_card:
        return b * nprobe >= 2 * nlist
    return b >= ivf_layout_threshold(kind, nprobe, nlist)


# -- public entry points ---------------------------------------------------------------

def unique_probes(probe_ids: torch.Tensor, nlist: int) -> torch.Tensor:
    """The sorted distinct bucket ids of ``probe_ids`` at the fixed size
    ``min(B*nprobe, nlist)``, padded with -1. Sort, first-mark and cumsum
    on the device: ``torch.unique`` would stop the host until the card is
    done."""
    flat = torch.sort(probe_ids.reshape(-1)).values
    n_uniq = min(flat.shape[0], nlist)
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    slot = torch.where(first, torch.cumsum(first, 0) - 1, n_uniq)   # n_uniq: discarded
    out = torch.full((n_uniq + 1,), -1, dtype=torch.int32, device=flat.device)
    out.scatter_(0, slot, flat.to(torch.int32))
    out[n_uniq] = -1
    return out[:n_uniq].contiguous()


def ivf_probe_search(probe_ids, queries, buckets, bucket_ids, *, k, extent=None):
    """Score each query against its probed buckets, fused top-k.
    ``queries`` ``[B, D]`` in the buckets' float type; ``extent`` the
    buckets' live extent on the card (:func:`ivf_extent`, computed when
    None; the plain version masks by id alone). Returns (scores ``[B, k]``
    f32, doc ids ``[B, k]`` i32; (-inf, 0) where fewer than k live docs were
    probed)."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    if buckets.is_cuda:
        kern = ivf_probe_topk_f32_cuda if buckets.dtype == torch.float32 else ivf_probe_topk_cuda
        return kern(probe_ids, queries, buckets, bucket_ids, k, extent=extent)
    return ivf_probe_search_plain(probe_ids, queries, buckets, bucket_ids, k)


def ivf_probe_search_int8(probe_ids, queries, buckets, bucket_ids, bucket_scales, *, k,
                          extent=None):
    """int8 probe search. ``queries`` f32 ``[B, D]`` (quantized here);
    returned scores are rescaled by the per-query scale. ``extent`` as for
    :func:`ivf_probe_search`."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    q8, qs = quantize_rows(queries)
    if buckets.is_cuda:
        s, i = ivf_probe_topk_int8_cuda(probe_ids, q8, buckets, bucket_ids,
                                        bucket_scales, k, extent=extent)
    else:
        s, i = ivf_probe_search_int8_plain(probe_ids, q8, buckets, bucket_ids,
                                           bucket_scales, k)
    return s * qs[:, None], i


def int4_query(queries):
    """int8 query codes, the bias correction ``corr`` = 8 sum(q8) ``[B]``
    f32 (exact: at most 8 * 127 * D) and the query scales."""
    q8, qs = quantize_rows(queries)
    return q8, (8 * q8.to(torch.int32).sum(dim=1)).float(), qs


def ivf_probe_search_int4(probe_ids, queries, buckets, bucket_ids, bucket_scales, *, k,
                          extent=None):
    """int4 probe search over split-half packed buckets. ``queries`` f32
    ``[B, D]`` (int8-quantized here, ``corr`` computed once on their
    device); returned scores are rescaled by the per-query scale.
    ``extent`` (in slots) as for :func:`ivf_probe_search`."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    q8, corr, qs = int4_query(queries)
    if buckets.is_cuda:
        s, i = ivf_probe_topk_int4_cuda(probe_ids, q8, corr, buckets, bucket_ids,
                                        bucket_scales, k, extent=extent)
    else:
        s, i = ivf_probe_search_int4_plain(probe_ids, q8, corr, buckets, bucket_ids,
                                           bucket_scales, k)
    return s * qs[:, None], i


def ivf_batch_search(probe_ids, queries, buckets, bucket_ids, *, k,
                     bucket_scales=None, quant=None, extent=None):
    """Bucket-major batched probe search. ``quant``: "none" | "int8" |
    "int4" (default int8 when scales are given; int4 buckets are split-half
    packed, ``ops/quant.py:ivf_pack_slots_int4``); ``extent`` as for
    :func:`ivf_probe_search`. Returns (scores ``[B, k]`` f32, doc ids ``[B,
    k]`` i32)."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    if quant is None:
        quant = "int8" if bucket_scales is not None else "none"
    nlist, cap = bucket_ids.shape
    need = nlist * cap // 2 if quant == "int4" else nlist * cap
    if quant != "none" and buckets.shape[0] < need:
        # packed int4 buckets have nlist*cap/2 rows: scored as int8 codes
        # they would be silently wrong
        raise ValueError(f"buckets has {buckets.shape[0]} rows but {quant} needs "
                         f"{need}" + ("; packed int4 input? pass quant='int4'"
                                      if quant == "int8" else ""))
    corr = qs = None
    if quant == "int4":
        q, corr, qs = int4_query(queries)
    elif quant == "int8":
        q, qs = quantize_rows(queries)
    else:
        q = queries.to(buckets.dtype)
    if buckets.is_cuda:
        # the scans sort the probes themselves: no unique list
        if quant == "int4":
            s, i = ivf_batch_topk_int4_cuda(probe_ids, None, q, corr, buckets, bucket_ids,
                                            bucket_scales, k, extent=extent)
        elif quant == "int8":
            s, i = ivf_batch_topk_int8_cuda(probe_ids, None, q, buckets, bucket_ids,
                                            bucket_scales, k, extent=extent)
        else:
            kern = (ivf_batch_topk_f32_cuda if buckets.dtype == torch.float32
                    else ivf_batch_topk_cuda)
            return kern(probe_ids, None, q, buckets, bucket_ids, k, extent=extent)
    elif quant == "int4":
        s, i = ivf_batch_search_int4_plain(probe_ids, unique_probes(probe_ids, nlist), q, corr,
                                           buckets, bucket_ids, bucket_scales, k)
    else:
        s, i = ivf_batch_search_plain(probe_ids, unique_probes(probe_ids, nlist), q, buckets,
                                      bucket_ids, bucket_scales if quant == "int8" else None, k)
    if qs is not None:
        s = s * qs[:, None]
    return s, i
