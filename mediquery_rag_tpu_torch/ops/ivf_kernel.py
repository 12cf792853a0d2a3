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
the Pallas ones take the storage dtype as given); on CPU tensors they run the ``*_plain``
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

import torch

from mediquery_rag_tpu_torch.ops import _build
from mediquery_rag_tpu_torch.ops.quant import quantize_rows
from mediquery_rag_tpu_torch.ops.scoring import LANE, _round_up, pad_short
from mediquery_rag_tpu_torch.ops.topk import exact_topk

_PLAIN_ELEMS = 1 << 26    # gathered bucket elements per chunk in the plain versions
_TARGET_BLOCKS = 264      # two blocks per SM of an H100
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


# -- CUDA launchers ------------------------------------------------------------------

_WARP_BLOCKS = 16 * 132      # one-warp query-major blocks: 16 warps per SM of an H100
_MAX_LISTS = 227 * 1024 // 4  # pass 2 keeps one int per partial list in shared memory


def _pieces(base_blocks: int, cap: int, target: int = _TARGET_BLOCKS) -> tuple[int, int]:
    """Split a bucket into pieces of a multiple of 64 rows so that the
    grid has about ``target`` blocks: (piece rows, pieces)."""
    want = max(1, min(-(-cap // 64), -(-target // max(1, base_blocks))))
    piece = _round_up(-(-cap // want), 64)
    return piece, -(-cap // piece)


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


def _outputs(dev, b, nchunks, k):
    if nchunks > _MAX_LISTS:
        raise ValueError(f"nprobe * pieces = {nchunks} partial lists per query; "
                         f"the merge takes at most {_MAX_LISTS}")
    part_s = torch.empty((b, nchunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, nchunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    return part_s, part_i, out_s, out_i


def _probe_launch(what, fn, probe_ids, lead, buckets, bucket_ids, scale_ptrs, k,
                  packed=False):
    """``lead``: the query tensors passed before the buckets (q, or q8
    and corr); ``packed``: int4 buckets, pieces of packed rows."""
    b, nprobe = probe_ids.shape
    cap = bucket_ids.shape[1]
    if not 1 <= b <= 65535 or buckets.shape[1] > 12288:
        raise ValueError(f"{what} takes 1 <= B <= 65535 and D <= 12288")
    piece, npieces = _pieces(b * nprobe, cap // 2 if packed else cap, _WARP_BLOCKS)
    parts = _outputs(buckets.device, b, nprobe * npieces, k)
    _build.check(fn(*(t.data_ptr() for t in lead), buckets.data_ptr(), *scale_ptrs,
                    bucket_ids.data_ptr(),
                    probe_ids.data_ptr(), b, buckets.shape[1], cap, nprobe, piece, k,
                    *(t.data_ptr() for t in parts), _build.stream_ptr(buckets)), what)
    return parts[2], parts[3]


def ivf_probe_topk_cuda(probe_ids, queries, buckets, bucket_ids, k):
    """Launch ``ivf_probe_topk`` (B8a): bf16 queries ``[B, D]`` over bf16
    buckets ``[nlist*cap, D]`` -> (scores, doc ids) ``[B, k]``."""
    _check("ivf_probe_topk", k, buckets, bucket_ids, probe_ids, 8, torch.bfloat16,
           queries)
    if queries.dtype != torch.bfloat16:
        raise ValueError("ivf_probe_topk takes bf16 queries")
    lib = _build.load("ivf_topk")
    out = _probe_launch("ivf_probe_topk", lib.ivf_probe_topk, probe_ids, [queries],
                        buckets, bucket_ids, [], k)
    ivf_probe_topk_cuda.launches += 1
    return out


ivf_probe_topk_cuda.launches = 0


def ivf_probe_topk_f32_cuda(probe_ids, queries, buckets, bucket_ids, k):
    """Launch ``ivf_probe_topk_f32`` (B8a over f32 buckets): f32 queries
    ``[B, D]`` over f32 buckets ``[nlist*cap, D]``, f32 sums on the CUDA
    cores -> (scores, doc ids) ``[B, k]``."""
    _check("ivf_probe_topk_f32", k, buckets, bucket_ids, probe_ids, 4, torch.float32,
           queries)
    if queries.dtype != torch.float32:
        raise ValueError("ivf_probe_topk_f32 takes f32 queries")
    lib = _build.load("ivf_topk")
    out = _probe_launch("ivf_probe_topk_f32", lib.ivf_probe_topk_f32, probe_ids, [queries],
                        buckets, bucket_ids, [], k)
    ivf_probe_topk_f32_cuda.launches += 1
    return out


ivf_probe_topk_f32_cuda.launches = 0


def ivf_probe_topk_int8_cuda(probe_ids, q8, buckets, bucket_ids, bucket_scales, k):
    """Launch ``ivf_probe_topk_int8`` (B8b): int8 queries over int8 buckets
    with f32 row scales ``[nlist, cap]``; scores carry no query scale."""
    _check("ivf_probe_topk_int8", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, bucket_scales)
    if q8.dtype != torch.int8 or bucket_scales.dtype != torch.float32:
        raise ValueError("ivf_probe_topk_int8 takes int8 queries and f32 scales")
    lib = _build.load("ivf_topk")
    out = _probe_launch("ivf_probe_topk_int8", lib.ivf_probe_topk_int8, probe_ids, [q8],
                        buckets, bucket_ids, [bucket_scales.data_ptr()], k)
    ivf_probe_topk_int8_cuda.launches += 1
    return out


ivf_probe_topk_int8_cuda.launches = 0


def ivf_probe_topk_int4_cuda(probe_ids, q8, corr, buckets, bucket_ids, bucket_scales, k):
    """Launch ``ivf_probe_topk_int4`` (B8c): int8 queries and ``corr`` =
    8 sum(q8) ``[B]`` f32 over split-half packed int4 buckets ``[nlist*cap/2,
    D]`` with f32 slot scales ``[nlist, cap]``; scores carry no query scale."""
    _check("ivf_probe_topk_int4", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, corr, bucket_scales, packed=True)
    if (q8.dtype != torch.int8 or corr.dtype != torch.float32
            or bucket_scales.dtype != torch.float32):
        raise ValueError("ivf_probe_topk_int4 takes int8 queries, f32 corr and scales")
    lib = _build.load("ivf_topk")
    out = _probe_launch("ivf_probe_topk_int4", lib.ivf_probe_topk_int4, probe_ids,
                        [q8, corr], buckets, bucket_ids, [bucket_scales.data_ptr()], k,
                        packed=True)
    ivf_probe_topk_int4_cuda.launches += 1
    return out


ivf_probe_topk_int4_cuda.launches = 0


def _batch_launch(what, fn, probe_ids, uniq, q, buckets, bucket_ids, scale_ptrs, k,
                  corr=None):
    """``corr`` given: int4 buckets, corr passed after the queries and
    pieces of packed rows."""
    b, nprobe = probe_ids.shape
    d = buckets.shape[1]
    cap = bucket_ids.shape[1]
    dev = buckets.device
    b_pad = _round_up(max(b, 1), 16)
    qp = torch.zeros((b_pad, d), dtype=q.dtype, device=dev)
    qp[:b] = q
    lead = [qp]
    if corr is not None:
        cp = torch.zeros((b_pad,), dtype=torch.float32, device=dev)
        cp[:b] = corr
        lead.append(cp)
    pp = torch.full((b_pad, nprobe), -1, dtype=torch.int32, device=dev)
    pp[:b] = probe_ids
    n_uniq = uniq.shape[0]
    piece, npieces = _pieces(n_uniq * (b_pad // 16), cap if corr is None else cap // 2)
    parts = _outputs(dev, b, nprobe * npieces, k)
    _build.check(fn(*(t.data_ptr() for t in lead), buckets.data_ptr(), *scale_ptrs,
                    bucket_ids.data_ptr(),
                    pp.data_ptr(), uniq.data_ptr(), n_uniq, b_pad, b, d, cap, nprobe,
                    piece, k, *(t.data_ptr() for t in parts),
                    _build.stream_ptr(buckets)), what)
    return parts[2], parts[3]


def ivf_batch_topk_cuda(probe_ids, uniq, queries, buckets, bucket_ids, k):
    """Launch ``ivf_batch_topk`` (B9a): bucket-major over bf16 buckets;
    ``uniq`` holds the sorted probed bucket ids, -1 padded."""
    _check("ivf_batch_topk", k, buckets, bucket_ids, probe_ids, 16, torch.bfloat16,
           queries, uniq)
    if queries.dtype != torch.bfloat16 or buckets.data_ptr() % 32:
        raise ValueError("ivf_batch_topk takes bf16 queries and 32-byte aligned buckets")
    lib = _build.load("ivf_topk")
    out = _batch_launch("ivf_batch_topk", lib.ivf_batch_topk, probe_ids, uniq, queries,
                        buckets, bucket_ids, [], k)
    ivf_batch_topk_cuda.launches += 1
    return out


ivf_batch_topk_cuda.launches = 0


def ivf_batch_topk_f32_cuda(probe_ids, uniq, queries, buckets, bucket_ids, k):
    """Launch ``ivf_batch_topk_f32`` (B9a over f32 buckets): bucket-major,
    f32 sums on the CUDA cores; ``uniq`` as for :func:`ivf_batch_topk_cuda`."""
    _check("ivf_batch_topk_f32", k, buckets, bucket_ids, probe_ids, 4, torch.float32,
           queries, uniq)
    if queries.dtype != torch.float32:
        raise ValueError("ivf_batch_topk_f32 takes f32 queries")
    lib = _build.load("ivf_topk")
    out = _batch_launch("ivf_batch_topk_f32", lib.ivf_batch_topk_f32, probe_ids, uniq,
                        queries, buckets, bucket_ids, [], k)
    ivf_batch_topk_f32_cuda.launches += 1
    return out


ivf_batch_topk_f32_cuda.launches = 0


def ivf_batch_topk_int8_cuda(probe_ids, uniq, q8, buckets, bucket_ids, bucket_scales, k):
    """Launch ``ivf_batch_topk_int8`` (B9b): bucket-major over int8 buckets;
    scores carry no query scale."""
    _check("ivf_batch_topk_int8", k, buckets, bucket_ids, probe_ids, 32, torch.int8,
           q8, uniq, bucket_scales)
    if q8.dtype != torch.int8 or bucket_scales.dtype != torch.float32:
        raise ValueError("ivf_batch_topk_int8 takes int8 queries and f32 scales")
    lib = _build.load("ivf_topk")
    out = _batch_launch("ivf_batch_topk_int8", lib.ivf_batch_topk_int8, probe_ids, uniq,
                        q8, buckets, bucket_ids, [bucket_scales.data_ptr()], k)
    ivf_batch_topk_int8_cuda.launches += 1
    return out


ivf_batch_topk_int8_cuda.launches = 0


def ivf_batch_topk_int4_cuda(probe_ids, uniq, q8, corr, buckets, bucket_ids,
                             bucket_scales, k):
    """Launch ``ivf_batch_topk_int4`` (B9c): bucket-major over split-half
    packed int4 buckets; scores carry no query scale."""
    _check("ivf_batch_topk_int4", k, buckets, bucket_ids, probe_ids, 32, torch.int8,
           q8, corr, uniq, bucket_scales, packed=True)
    if (q8.dtype != torch.int8 or corr.dtype != torch.float32
            or bucket_scales.dtype != torch.float32):
        raise ValueError("ivf_batch_topk_int4 takes int8 queries, f32 corr and scales")
    lib = _build.load("ivf_topk")
    out = _batch_launch("ivf_batch_topk_int4", lib.ivf_batch_topk_int4, probe_ids, uniq,
                        q8, buckets, bucket_ids, [bucket_scales.data_ptr()], k, corr=corr)
    ivf_batch_topk_int4_cuda.launches += 1
    return out


ivf_batch_topk_int4_cuda.launches = 0


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


def ivf_probe_search(probe_ids, queries, buckets, bucket_ids, *, k):
    """Score each query against its probed buckets, fused top-k.
    ``queries`` ``[B, D]`` in the buckets' float type. Returns (scores
    ``[B, k]`` f32, doc ids ``[B, k]`` i32; (-inf, 0) where fewer than k
    live docs were probed)."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    if buckets.is_cuda:
        kern = ivf_probe_topk_f32_cuda if buckets.dtype == torch.float32 else ivf_probe_topk_cuda
        return kern(probe_ids, queries, buckets, bucket_ids, k)
    return ivf_probe_search_plain(probe_ids, queries, buckets, bucket_ids, k)


def ivf_probe_search_int8(probe_ids, queries, buckets, bucket_ids, bucket_scales, *, k):
    """int8 probe search. ``queries`` f32 ``[B, D]`` (quantized here);
    returned scores are rescaled by the per-query scale."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    q8, qs = quantize_rows(queries)
    if buckets.is_cuda:
        s, i = ivf_probe_topk_int8_cuda(probe_ids, q8, buckets, bucket_ids,
                                        bucket_scales, k)
    else:
        s, i = ivf_probe_search_int8_plain(probe_ids, q8, buckets, bucket_ids,
                                           bucket_scales, k)
    return s * qs[:, None], i


def int4_query(queries):
    """int8 query codes, the bias correction ``corr`` = 8 sum(q8) ``[B]``
    f32 (exact: at most 8 * 127 * D) and the query scales."""
    q8, qs = quantize_rows(queries)
    return q8, (8 * q8.to(torch.int32).sum(dim=1)).float(), qs


def ivf_probe_search_int4(probe_ids, queries, buckets, bucket_ids, bucket_scales, *, k):
    """int4 probe search over split-half packed buckets. ``queries`` f32
    ``[B, D]`` (int8-quantized here, ``corr`` computed once on their
    device); returned scores are rescaled by the per-query scale."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    q8, corr, qs = int4_query(queries)
    if buckets.is_cuda:
        s, i = ivf_probe_topk_int4_cuda(probe_ids, q8, corr, buckets, bucket_ids,
                                        bucket_scales, k)
    else:
        s, i = ivf_probe_search_int4_plain(probe_ids, q8, corr, buckets, bucket_ids,
                                           bucket_scales, k)
    return s * qs[:, None], i


def ivf_batch_search(probe_ids, queries, buckets, bucket_ids, *, k,
                     bucket_scales=None, quant=None):
    """Bucket-major batched probe search. ``quant``: "none" | "int8" |
    "int4" (default int8 when scales are given; int4 buckets are split-half
    packed, ``ops/quant.py:ivf_pack_slots_int4``). Returns (scores ``[B, k]``
    f32, doc ids ``[B, k]`` i32)."""
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
    uniq = unique_probes(probe_ids, nlist)
    if buckets.is_cuda:
        if quant == "int4":
            s, i = ivf_batch_topk_int4_cuda(probe_ids, uniq, q, corr, buckets, bucket_ids,
                                            bucket_scales, k)
        elif quant == "int8":
            s, i = ivf_batch_topk_int8_cuda(probe_ids, uniq, q, buckets, bucket_ids,
                                            bucket_scales, k)
        elif buckets.dtype == torch.float32:
            s, i = ivf_batch_topk_f32_cuda(probe_ids, uniq, q, buckets, bucket_ids, k)
        else:
            s, i = ivf_batch_topk_cuda(probe_ids, uniq, q, buckets, bucket_ids, k)
    elif quant == "int4":
        s, i = ivf_batch_search_int4_plain(probe_ids, uniq, q, corr, buckets, bucket_ids,
                                           bucket_scales, k)
    else:
        s, i = ivf_batch_search_plain(probe_ids, uniq, q, buckets, bucket_ids,
                                      bucket_scales if quant == "int8" else None, k)
    if qs is not None:
        s = s * qs[:, None]
    return s, i
