"""IVF probe scans with a fused top-k (port of ``mediquery_rag_tpu/ops/ivf_kernel.py``).

Two layouts of the same function, each score the doc rows of the buckets a
query probes and keep its top-k:

- query-major (``ivf_probe_search``, ``ivf_probe_search_int8``): every
  (query, probed bucket) pair is read; least latency at small batch;
- bucket-major (``ivf_batch_search``): the probed buckets of the whole
  batch are deduplicated and each is read once for every query that probes
  it; fewer bytes once several queries share buckets.

On CUDA tensors they launch the hand-written kernels of ``csrc/ivf_topk.cu``
(replacing the Pallas ``_ivf_kernel``, ``_ivf_int8_kernel``,
``_ivf_batch_kernel`` and ``_ivf_batch_int8_kernel``); on CPU tensors they
run the ``*_plain`` versions, which do the same f32 arithmetic with the
gather done in chunks of probes or buckets.

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
from mediquery_rag_tpu_torch.ops.scoring import LANE, _TARGET_BLOCKS, _round_up, pad_short
from mediquery_rag_tpu_torch.ops.topk import exact_topk

_PLAIN_ELEMS = 1 << 26    # gathered bucket elements per chunk in the plain versions
_NEG_INF = float("-inf")
_INT4_TODO = ("int4 IVF buckets need kernels B8c/B9c (_ivf_int4_kernel, "
              "_ivf_batch_int4_kernel), not ported yet (ROADMAP Queue A)")


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


def _probe_plain(probe_ids, q, buckets, bucket_ids, scales, k):
    b, nprobe = probe_ids.shape
    nlist, cap = bucket_ids.shape
    bk = buckets[: nlist * cap].reshape(nlist, cap, -1)
    pc = max(1, _PLAIN_ELEMS // max(1, b * cap * bk.shape[-1]))
    run = None
    for j in range(0, nprobe, pc):
        pid = probe_ids[:, j:j + pc].long()                    # [B, p]
        ids = bucket_ids[pid]                                  # [B, p, cap]
        sc = None if scales is None else scales[pid].reshape(b, 1, -1)
        rows = bk[pid].reshape(b, -1, bk.shape[-1])             # [B, p*cap, D]
        s = _rows_score(q[:, None, :], rows, sc)[:, 0]          # [B, p*cap]
        ids = ids.reshape(b, -1)
        run = _fold(run, torch.where(ids >= 0, s, _NEG_INF), ids, k)
    return pad_short(*run, k)


def ivf_probe_search_plain(probe_ids, queries, buckets, bucket_ids, k):
    """Plain version of B8a: ``queries`` in the buckets' float type."""
    return _probe_plain(probe_ids, queries, buckets, bucket_ids, None, k)


def ivf_probe_search_int8_plain(probe_ids, q8, buckets, bucket_ids, bucket_scales, k):
    """Plain version of B8b: int8 queries, scores without the query scale."""
    return _probe_plain(probe_ids, q8, buckets, bucket_ids, bucket_scales, k)


def ivf_batch_search_plain(probe_ids, uniq, queries, buckets, bucket_ids,
                           bucket_scales, k):
    """Plain version of B9a/B9b: each bucket of ``uniq`` (-1 = pad) scored
    for the whole batch, rows of queries that do not probe it masked."""
    b = probe_ids.shape[0]
    nlist, cap = bucket_ids.shape
    bk = buckets[: nlist * cap].reshape(nlist, cap, -1)
    uc = max(1, _PLAIN_ELEMS // max(1, cap * bk.shape[-1]))
    uniq = uniq.long()
    run = None
    for u in range(0, uniq.shape[0], uc):
        us = uniq[u:u + uc]
        ub = torch.clamp(us, min=0)
        ids = bucket_ids[ub]                                   # [u, cap]
        sc = None if bucket_scales is None else bucket_scales[ub].reshape(1, -1)
        s = _rows_score(queries, bk[ub].reshape(-1, bk.shape[-1]), sc)
        s = s.reshape(b, us.shape[0], cap)                     # [B, u, cap]
        probed = (probe_ids[:, :, None] == us[None, None, :]).any(dim=1)  # [B, u]
        keep = probed[:, :, None] & (ids >= 0)[None] & (us >= 0)[None, :, None]
        s = torch.where(keep, s, _NEG_INF)
        run = _fold(run, s.reshape(b, -1), ids[None].expand(b, -1, -1).reshape(b, -1), k)
    return pad_short(*run, k)


# -- CUDA launchers ------------------------------------------------------------------

_WARP_BLOCKS = 16 * 132      # one-warp query-major blocks: 16 warps per SM of an H100
_MAX_LISTS = 227 * 1024 // 4  # pass 2 keeps one int per partial list in shared memory


def _pieces(base_blocks: int, cap: int, target: int = _TARGET_BLOCKS) -> tuple[int, int]:
    """Split a bucket into pieces of a multiple of 64 rows so that the
    grid has about ``target`` blocks: (piece rows, pieces)."""
    want = max(1, min(-(-cap // 64), -(-target // max(1, base_blocks))))
    piece = _round_up(-(-cap // want), 64)
    return piece, -(-cap // piece)


def _check(what, k, rows, bucket_ids, probe_ids, d_mult, dtype, *others):
    d = rows.shape[1]
    if not 1 <= k <= LANE:
        raise ValueError(f"{what} takes 1 <= k <= {LANE}, got {k}")
    if rows.dtype != dtype:
        raise NotImplementedError(
            f"{what} takes {dtype} buckets, got {rows.dtype}"
            + (" (float32 IVF storage on the card is a ROADMAP Queue A item)"
               if rows.dtype == torch.float32 else ""))
    nlist, cap = bucket_ids.shape
    if d % d_mult or cap % 32 or rows.shape[0] < nlist * cap:
        raise ValueError(f"{what} needs D % {d_mult} == 0, cap % 32 == 0 and "
                         f"nlist*cap rows, got D={d} cap={cap} rows={rows.shape[0]}")
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


def _probe_launch(what, fn, probe_ids, q, buckets, bucket_ids, scale_ptrs, k):
    b, nprobe = probe_ids.shape
    cap = bucket_ids.shape[1]
    if not 1 <= b <= 65535 or buckets.shape[1] > 12288:
        raise ValueError(f"{what} takes 1 <= B <= 65535 and D <= 12288")
    piece, npieces = _pieces(b * nprobe, cap, _WARP_BLOCKS)
    parts = _outputs(buckets.device, b, nprobe * npieces, k)
    _build.check(fn(q.data_ptr(), buckets.data_ptr(), *scale_ptrs, bucket_ids.data_ptr(),
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
    out = _probe_launch("ivf_probe_topk", lib.ivf_probe_topk, probe_ids, queries,
                        buckets, bucket_ids, [], k)
    ivf_probe_topk_cuda.launches += 1
    return out


ivf_probe_topk_cuda.launches = 0


def ivf_probe_topk_int8_cuda(probe_ids, q8, buckets, bucket_ids, bucket_scales, k):
    """Launch ``ivf_probe_topk_int8`` (B8b): int8 queries over int8 buckets
    with f32 row scales ``[nlist, cap]``; scores carry no query scale."""
    _check("ivf_probe_topk_int8", k, buckets, bucket_ids, probe_ids, 16, torch.int8,
           q8, bucket_scales)
    if q8.dtype != torch.int8 or bucket_scales.dtype != torch.float32:
        raise ValueError("ivf_probe_topk_int8 takes int8 queries and f32 scales")
    lib = _build.load("ivf_topk")
    out = _probe_launch("ivf_probe_topk_int8", lib.ivf_probe_topk_int8, probe_ids, q8,
                        buckets, bucket_ids, [bucket_scales.data_ptr()], k)
    ivf_probe_topk_int8_cuda.launches += 1
    return out


ivf_probe_topk_int8_cuda.launches = 0


def _batch_launch(what, fn, probe_ids, uniq, q, buckets, bucket_ids, scale_ptrs, k):
    b, nprobe = probe_ids.shape
    d = buckets.shape[1]
    cap = bucket_ids.shape[1]
    dev = buckets.device
    b_pad = _round_up(max(b, 1), 16)
    qp = torch.zeros((b_pad, d), dtype=q.dtype, device=dev)
    qp[:b] = q
    pp = torch.full((b_pad, nprobe), -1, dtype=torch.int32, device=dev)
    pp[:b] = probe_ids
    n_uniq = uniq.shape[0]
    piece, npieces = _pieces(n_uniq * (b_pad // 16), cap)
    parts = _outputs(dev, b, nprobe * npieces, k)
    _build.check(fn(qp.data_ptr(), buckets.data_ptr(), *scale_ptrs, bucket_ids.data_ptr(),
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
        return ivf_probe_topk_cuda(probe_ids, queries, buckets, bucket_ids, k)
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


def ivf_batch_search(probe_ids, queries, buckets, bucket_ids, *, k,
                     bucket_scales=None, quant=None):
    """Bucket-major batched probe search. ``quant``: "none" | "int8"
    (default int8 when scales are given); int4 raises. Returns (scores
    ``[B, k]`` f32, doc ids ``[B, k]`` i32)."""
    if k > LANE:
        raise ValueError(f"k={k} > {LANE}")
    if quant is None:
        quant = "int8" if bucket_scales is not None else "none"
    if quant == "int4":
        raise NotImplementedError(_INT4_TODO)
    nlist, cap = bucket_ids.shape
    if quant == "int8":
        if buckets.shape[0] < nlist * cap:
            raise ValueError(f"buckets has {buckets.shape[0]} rows but int8 needs "
                             f"nlist*cap={nlist * cap}")
        q, qs = quantize_rows(queries)
    else:
        q, qs = queries.to(buckets.dtype), None
    uniq = unique_probes(probe_ids, nlist)
    if buckets.is_cuda:
        if quant == "int8":
            s, i = ivf_batch_topk_int8_cuda(probe_ids, uniq, q, buckets, bucket_ids,
                                            bucket_scales, k)
        else:
            s, i = ivf_batch_topk_cuda(probe_ids, uniq, q, buckets, bucket_ids, k)
    else:
        s, i = ivf_batch_search_plain(probe_ids, uniq, q, buckets, bucket_ids,
                                      bucket_scales if quant == "int8" else None, k)
    if qs is not None:
        s = s * qs[:, None]
    return s, i
