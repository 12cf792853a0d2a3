"""Exact top-k dot-product search (port of ``mediquery_rag_tpu/ops/scoring.py``).

``flat_search`` scores a query batch against a row-padded corpus and
returns the sorted top-k without keeping the ``[B, N]`` score matrix: on a
CUDA tensor it launches the hand-written kernel ``csrc/flat_topk.cu``
(replacing the Pallas ``_flat_topk_kernel``: ``flat_topk`` for a bf16
corpus, ``flat_topk_f32`` for f32, no TF32); on a CPU tensor it runs
:func:`flat_search_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from mediquery_rag_tpu_torch.ops import _build
from mediquery_rag_tpu_torch.ops.topk import exact_topk

LANE = 128          # largest k the fused kernel takes (as on the TPU)
_TARGET_BLOCKS = 264   # two blocks per SM of an H100


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def scan_chunk(rows: int, qtiles: int) -> int:
    """Corpus rows per pass-1 block of the scan kernels: a multiple of 64,
    at most 1024, small enough that ``qtiles x chunks`` fills the card."""
    return max(64, min(1024, (rows * qtiles // _TARGET_BLOCKS) // 64 * 64))


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
                 n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    b, d = queries.shape
    n_pad = corpus.shape[0]
    if not 1 <= k <= LANE:
        raise ValueError(f"{what} takes 1 <= k <= {LANE}, got {k}")
    if d % 16 or n_pad % 64:
        raise ValueError(f"{what} needs D % 16 == 0 and N_pad % 64 == 0, "
                         f"got D={d} N_pad={n_pad}")
    if not corpus.is_contiguous() or corpus.data_ptr() % 32:
        raise ValueError("corpus must be contiguous and 32-byte aligned")
    lib = _build.load("flat_topk")
    b_pad = _round_up(max(b, 1), 16)
    q = torch.zeros((b_pad, d), dtype=corpus.dtype, device=corpus.device)
    q[:b] = queries
    qtiles = b_pad // 16
    chunk = scan_chunk(n_pad, qtiles)
    nchunks = -(-n_pad // chunk)
    dev = corpus.device
    part_s = torch.empty((b_pad, nchunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b_pad, nchunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b_pad, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b_pad, k), dtype=torch.int32, device=dev)
    _build.check(getattr(lib, what)(
        q.data_ptr(), corpus.data_ptr(), b_pad, d, n_pad, int(n_valid), chunk,
        k, part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), _build.stream_ptr(corpus)), what)
    return out_s[:b], out_i[:b]


def flat_topk_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flat_topk`` of ``csrc/flat_topk.cu`` on bf16 CUDA tensors;
    an f32 corpus goes to :func:`flat_topk_f32_cuda` (the int8/int4 scans
    are ``ops/quant.py``'s)."""
    if corpus.dtype == torch.float32:
        return flat_topk_f32_cuda(queries, corpus, k, n_valid)
    if corpus.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA flat scan takes a bfloat16 or float32 corpus, got {corpus.dtype}")
    out = _flat_launch("flat_topk", queries, corpus, k, n_valid)
    flat_topk_cuda.launches += 1
    return out


flat_topk_cuda.launches = 0


def flat_topk_f32_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                       n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flat_topk_f32`` (f32 queries and corpus, f32 sums on CUDA
    cores: no TF32)."""
    if corpus.dtype != torch.float32 or queries.dtype != torch.float32:
        raise ValueError("flat_topk_f32 takes f32 queries and corpus")
    out = _flat_launch("flat_topk_f32", queries, corpus, k, n_valid)
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
        CUDA kernel tiles queries by 16.

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
