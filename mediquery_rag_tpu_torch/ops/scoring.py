"""Exact top-k dot-product search (port of ``mediquery_rag_tpu/ops/scoring.py``).

``flat_search`` scores a query batch against a row-padded corpus and
returns the sorted top-k without keeping the ``[B, N]`` score matrix: on a
CUDA tensor it launches the hand-written kernel ``csrc/flat_topk.cu``
(replacing the Pallas ``_flat_topk_kernel``: ``flat_topk`` for a bf16
corpus, ``flat_topk_f32`` for f32, no TF32); on a CPU tensor it runs
:func:`flat_search_plain`, the same function in plain PyTorch.

The flat scans (B1 here, B2/B3 in ``ops/quant.py``) are one Hopper kernel
(``csrc/scan.cuh``) with a score stage per type; :func:`scan_plan` cuts a
scan for it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mediquery_rag_tpu_torch.ops import _build
from mediquery_rag_tpu_torch.ops.topk import exact_topk

LANE = 128          # largest k the fused kernel takes (as on the TPU)
SCAN_TILE = 128     # corpus rows (int4: byte-rows) per scan tile, 64 per consumer warpgroup
_SCAN_PANEL = SCAN_TILE * 128   # one 128-byte K panel of a tile: a ring stage
_SCAN_SLOTS = 32    # survivor slots per query (merged when full)
_SCAN_MAX_STAGES = 8
# scan kind -> (bytes per query/corpus element, queries a block may take (wgmma N))
SCAN_KINDS = {"bf16": (2, (16, 32, 64, 128)), "f32": (4, (16, 32, 64, 128)),
              "int8": (1, (16, 32, 64, 128)), "int4": (1, (16, 32, 64))}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ScanPlan(NamedTuple):
    """How the Hopper scan cuts one search (:func:`scan_plan`): ``groups``
    groups of ``qb`` queries, each of ``ranges`` blocks walking a contiguous
    range of the ``tiles`` 128-row corpus tiles through a ring of ``stages``
    128-byte K panels, in ``smem`` bytes of shared memory a block; with
    ``qstream`` each stage also carries the queries' panel (their tile does
    not fit a block)."""
    qb: int
    stages: int
    groups: int
    ranges: int
    tiles: int
    smem: int
    qstream: bool

    def tile_ranges(self) -> list[tuple[int, int]]:
        """Block r's tiles ``[r T / R, (r + 1) T / R)``, as the kernel cuts them."""
        t, r = self.tiles, self.ranges
        return [(i * t // r, (i + 1) * t // r) for i in range(r)]


def _scan_smem(qb: int, row_bytes: int, k: int, stages: int, qstream: bool = False) -> int:
    """The scan's shared memory (``smem_bytes`` of ``csrc/scan.cuh``):
    resident query panels, ring, lists, survivor slots, counts and aux
    values, barriers, alignment."""
    resident = 0 if qstream else -(-row_bytes // 128) * qb * 128
    stage = _SCAN_PANEL + (qb * 128 if qstream else 0)
    return (1024 + resident + stages * stage + qb * k * 8 + qb * _SCAN_SLOTS * 8 + qb * 8
            + (2 * stages + 1) * 8)


@functools.lru_cache(maxsize=None)
def scan_plan(kind: str, b_pad: int, d: int, n_pad: int, k: int) -> ScanPlan:
    """The plan of a ``kind`` scan (``bf16``, ``f32``, ``int8``, ``int4``)
    of ``b_pad`` queries of width ``d`` over ``n_pad`` corpus rows (int4:
    byte-rows): the fewest queries per block (a power of two from 16 to 128;
    int4 to 64) that hold all ``b_pad`` queries, with the query tile
    resident if it fits beside a 4-stage ring and the lists, else with the
    queries riding in the ring (``qstream``: read again from the L2 for
    every tile, so the corpus is still read once), halved while neither
    fits (at the last, 2 stages will do); as many ring stages (up to 8) as
    then fit; one block per SM in all, split evenly over the query groups;
    no more ranges than tiles. At D = 768, k = 10: int8 keeps 128 queries
    resident, bf16 64 and streams 128, f32 keeps 32 and streams 64 or 128,
    int4 keeps 64."""
    esz, qbs = SCAN_KINDS[kind]
    if b_pad % 16 or not 1 <= k <= LANE:
        raise ValueError(f"scan_plan: b_pad % 16 == 0 and 1 <= k <= {LANE}, "
                         f"got b_pad={b_pad}, k={k}")
    row_bytes = d * esz

    def layout(qb: int, stages: int) -> bool | None:
        """False: the query tile resident; True: streamed; None: neither fits."""
        return next((qs for qs in (False, True) if _scan_smem(qb, row_bytes, k, stages, qs)
                     <= _build.SMEM_PER_BLOCK), None)

    qb = next(q for q in qbs if q >= b_pad) if b_pad <= qbs[-1] else qbs[-1]
    while qb > qbs[0] and layout(qb, 4) is None:
        qb //= 2
    qstream = layout(qb, 4)
    if qstream is None:
        qstream = layout(qb, 2)
    if qstream is None:
        raise ValueError(f"{kind} scan: D={d}, k={k} do not fit a block's shared memory")
    stages = max(st for st in range(2, _SCAN_MAX_STAGES + 1)
                 if _scan_smem(qb, row_bytes, k, st, qstream) <= _build.SMEM_PER_BLOCK)
    groups = -(-b_pad // qb)
    tiles = -(-n_pad // SCAN_TILE)
    ranges = max(1, min(tiles, _build.SMS // groups))
    return ScanPlan(qb, stages, groups, ranges, tiles,
                    _scan_smem(qb, row_bytes, k, stages, qstream), qstream)


def flat_scan_plan(b_pad: int, d: int, n_pad: int, k: int,
                   dtype: torch.dtype = torch.bfloat16) -> ScanPlan:
    """B1's plan over a bf16 or f32 corpus (:func:`scan_plan`)."""
    return scan_plan("f32" if dtype == torch.float32 else "bf16", b_pad, d, n_pad, k)


def scan_lists(b_pad: int, lists: int, k: int, dev) -> list[torch.Tensor]:
    """Pass 1's per-block lists and pass 2's output, scores and ids."""
    return [torch.empty((b_pad, lists, k), dtype=torch.float32, device=dev),
            torch.empty((b_pad, lists, k), dtype=torch.int32, device=dev),
            torch.empty((b_pad, k), dtype=torch.float32, device=dev),
            torch.empty((b_pad, k), dtype=torch.int32, device=dev)]


def check_stats(what: str, stats, dev) -> None:
    """A scan's ``stats`` hook: None, or an int32 tensor of 2 on ``dev``."""
    if stats is not None and (stats.dtype != torch.int32 or stats.device != dev
                              or stats.numel() < 2):
        raise ValueError(f"{what}: stats must be an int32 tensor of 2 on the corpus' device")


def pad_short(s: torch.Tensor, i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Short results as the kernels give them: fewer than ``k`` columns are
    padded, and every -inf score carries id 0."""
    if s.shape[1] < k:                          # fewer corpus rows than k
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, pad))
    i = torch.where(s == float("-inf"), torch.zeros_like(i), i)
    return s, i.to(torch.int32)


def flat_search_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: f32 scores, rows >= ``n_valid`` masked,
    stable descending sort, short results as (-inf, id 0)."""
    scores = queries.float() @ corpus.float().T
    scores[:, n_valid:] = float("-inf")
    return pad_short(*exact_topk(scores, k), k)


def _flat_launch(what: str, queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 n_valid: int, stats) -> tuple[torch.Tensor, torch.Tensor]:
    b, d = queries.shape
    n_pad = corpus.shape[0]
    if not 1 <= k <= LANE:
        raise ValueError(f"{what} takes 1 <= k <= {LANE}, got {k}")
    if d % 16 or n_pad % 64:
        raise ValueError(f"{what} needs D % 16 == 0 and N_pad % 64 == 0, "
                         f"got D={d} N_pad={n_pad}")
    if not corpus.is_contiguous() or corpus.data_ptr() % 16:
        raise ValueError("corpus must be contiguous and 16-byte aligned")
    check_stats(what, stats, corpus.device)
    lib = _build.load("flat_topk")
    b_pad = _round_up(max(b, 1), 16)
    q = torch.zeros((b_pad, d), dtype=corpus.dtype, device=corpus.device)
    q[:b] = queries
    plan = flat_scan_plan(b_pad, d, n_pad, k, corpus.dtype)
    bufs = scan_lists(b_pad, plan.ranges, k, corpus.device)
    _build.launch(what, getattr(lib, what), corpus,
        q.data_ptr(), corpus.data_ptr(), b_pad, d, n_pad, int(n_valid), plan.qb,
        int(plan.qstream), plan.stages, plan.ranges, k, *[t.data_ptr() for t in bufs],
        None if stats is None else stats.data_ptr())
    return bufs[2][:b], bufs[3][:b]


def flat_topk_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int, n_valid: int, *,
                   stats: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flat_topk`` of ``csrc/flat_topk.cu`` on bf16 CUDA tensors;
    an f32 corpus goes to :func:`flat_topk_f32_cuda` (the int8/int4 scans
    are ``ops/quant.py``'s). ``stats``, an int32 CUDA tensor of 2, gains the
    scores that passed the in-register filter and the blocks' merge rounds
    (a measurement hook)."""
    if corpus.dtype == torch.float32:
        return flat_topk_f32_cuda(queries, corpus, k, n_valid, stats=stats)
    if corpus.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA flat scan takes a bfloat16 or float32 corpus, got {corpus.dtype}")
    out = _flat_launch("flat_topk", queries, corpus, k, n_valid, stats)
    flat_topk_cuda.launches += 1
    return out


flat_topk_cuda.launches = 0


def flat_topk_f32_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int, n_valid: int, *,
                       stats: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flat_topk_f32`` (f32 queries and corpus, f32 sums on CUDA
    cores: no TF32); ``stats`` as :func:`flat_topk_cuda`'s."""
    if corpus.dtype != torch.float32 or queries.dtype != torch.float32:
        raise ValueError("flat_topk_f32 takes f32 queries and corpus")
    out = _flat_launch("flat_topk_f32", queries, corpus, k, n_valid, stats)
    flat_topk_f32_cuda.launches += 1
    return out


flat_topk_f32_cuda.launches = 0


def flat_search(
    queries: torch.Tensor,
    corpus_padded: torch.Tensor,
    k: int,
    *,
    n_valid: int | None = None,
    query_tile: int = 128,
    corpus_tile: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dot-product search.

    Args:
      queries: ``[B, D]`` (L2-normalized by the caller for cosine).
      corpus_padded: ``[N_pad, D]``, rows padded to a multiple of
        ``corpus_tile`` (``engine.FlatIndex`` stores it this way).
      k: neighbors to return (k <= 128).
      n_valid: number of real corpus rows (defaults to ``N_pad``).
      query_tile: accepted for signature parity with the JAX package; the
        CUDA kernel takes queries by :func:`flat_scan_plan`.

    Returns:
      (scores ``[B, k]`` f32 desc-sorted, indices ``[B, k]`` i32).
    """
    del query_tile
    if k > LANE:
        raise ValueError(f"k={k} > {LANE} not supported by the fused kernel")
    n_pad = corpus_padded.shape[0]
    if corpus_tile <= 0:
        raise ValueError(
            f"corpus_tile={corpus_tile}: 0 means 'auto' at the EngineConfig "
            "level — call cfg.resolve_corpus_tile(n) before calling the "
            "kernel directly")
    if n_pad % corpus_tile:
        raise ValueError(f"corpus rows {n_pad} not a multiple of tile {corpus_tile}")
    n_valid = n_pad if n_valid is None else int(n_valid)
    q = queries.to(corpus_padded.dtype)
    if corpus_padded.is_cuda:
        return flat_topk_cuda(q, corpus_padded, k, n_valid)
    return flat_search_plain(q, corpus_padded, k, n_valid)


def flat_search_xla(queries: torch.Tensor, corpus: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialized-scores oracle (the JAX package's ``flat_search_xla``):
    the full ``[B, N]`` f32 score matrix, then a sorted top-k."""
    scores = queries.to(corpus.dtype).float() @ corpus.float().T
    return exact_topk(scores, k)
