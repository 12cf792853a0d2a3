"""Plain IVF search over int8 rows (the search cell's reference).

The semantics of an int8 IVF index with cosine scores: rows and queries
L2-normalized, each coded per row as absmax/127 int8 (clipped to +-127),
a query's score against a row the exact integer dot of the codes times
both scales; a query probes the ``nprobe`` lists whose centroids score
highest against it, and its answer is the ``k`` best (score, then lower
id) of the rows those lists hold. ``precision="control"`` codes the rows
int4 (absmax/7, clipped to +-7), one step below the configuration's int8.

``exact`` is the whole index's answer: the ``k`` best of every row, with
no lists. ``kmeans`` is a plain spherical Lloyd's k-means from the
reference's own seed, and ``fit`` the mean score of each row against its
best centroid: how well a set of centroids covers the rows. ``search`` follows the lists (centroids and membership) of the
index under test, which it cannot draw again without the program's
k-means; ``placement`` checks that stage by itself: every row in exactly
one list, and in one of its ``r`` best-scoring lists (scored as the index
places rows: operands rounded to bf16, products summed in f32) unless all of those
hold ``cap_limit`` rows (a full list sends a row on to the next, and past
the ``r``-th to the emptiest list)."""

from __future__ import annotations

import torch


def codes(rows: torch.Tensor, levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 rows -> (integer codes as f32, per-row scales)."""
    s = rows.abs().amax(dim=1).clamp(min=1e-12) / levels
    return torch.clamp(torch.round(rows / s[:, None]), -levels, levels), s


def _no_tf32(fn):
    def run(*a, **kw):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*a, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return run


@_no_tf32
@torch.no_grad()
def scores(q: torch.Tensor, row_codes: torch.Tensor, row_scales: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Int8-query scores of one unit query ``q`` against rows ``ids``: the
    integer dot is exact in f32 (768 * 127^2 < 2^24)."""
    q8, qs = codes(q[None], 127)
    return (row_codes[ids] @ q8[0]) * row_scales[ids] * qs[0]


@_no_tf32
@torch.no_grad()
def exact(q: torch.Tensor, row_codes: torch.Tensor, row_scales: torch.Tensor, k: int,
          block: int = 1 << 18) -> torch.Tensor:
    """Ids of the ``k`` best of all rows for each unit query of ``q`` [B, D],
    by int8-query scores as ``scores`` gives them."""
    q8, qs = codes(q, 127)
    best_s = torch.full((q.shape[0], 0), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=q.device)
    for a in range(0, row_codes.shape[0], block):
        s = (q8 @ row_codes[a:a + block].T) * row_scales[a:a + block] * qs[:, None]
        top = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_s = torch.cat([best_s, top.values], dim=1)
        best_i = torch.cat([best_i, top.indices + a], dim=1)
        keep = torch.topk(best_s, k, dim=1).indices
        best_s, best_i = best_s.gather(1, keep), best_i.gather(1, keep)
    return best_i


@_no_tf32
@torch.no_grad()
def fit(rows: torch.Tensor, centroids: torch.Tensor, block: int = 1 << 16) -> float:
    """Mean over the unit ``rows`` of the score of their best centroid."""
    c = centroids / centroids.norm(dim=1, keepdim=True).clamp(min=1e-12)
    total = torch.zeros((), dtype=torch.float64, device=rows.device)
    for a in range(0, rows.shape[0], block):
        total += (rows[a:a + block] @ c.T).max(dim=1).values.double().sum()
    return float(total) / rows.shape[0]


@_no_tf32
@torch.no_grad()
def kmeans(rows: torch.Tensor, nlist: int, iters: int, seed: int,
           block: int = 1 << 16) -> torch.Tensor:
    """Spherical k-means of the unit ``rows``: ``nlist`` rows drawn from the
    seed to start, then ``iters`` rounds of assigning each row to its best
    centroid and renormalizing each centroid's sum (an empty one stays)."""
    g = torch.Generator(device=rows.device).manual_seed(seed)
    c = rows[torch.randperm(rows.shape[0], generator=g, device=rows.device)[:nlist]].clone()
    for _ in range(iters):
        sums = torch.zeros_like(c)
        counts = torch.zeros(nlist, device=rows.device)
        for a in range(0, rows.shape[0], block):
            x = rows[a:a + block]
            best = (x @ c.T).argmax(dim=1)
            sums.index_add_(0, best, x)
            counts.index_add_(0, best, torch.ones_like(best, dtype=counts.dtype))
        live = counts > 0
        c[live] = sums[live] / sums[live].norm(dim=1, keepdim=True)
    return c


@_no_tf32
@torch.no_grad()
def search(q: torch.Tensor, centroids: torch.Tensor, lists: torch.Tensor,
           row_codes: torch.Tensor, row_scales: torch.Tensor, nprobe: int,
           k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores, ids) of the ``k`` best rows of the lists one unit query
    probes. ``lists``: [nlist, cap] row ids, -1 empty."""
    probe = torch.topk(centroids @ q, nprobe).indices
    ids = lists[probe].reshape(-1)
    ids = ids[ids >= 0].long()
    s = scores(q, row_codes, row_scales, ids)
    # best score first, the lower id first among equals
    order = torch.argsort(ids)
    ids, s = ids[order], s[order]
    top = torch.argsort(-s, stable=True)[:k]
    return s[top], ids[top]


@_no_tf32
@torch.no_grad()
def placement(rows: torch.Tensor, centroids: torch.Tensor, lists: torch.Tensor, r: int,
              tie: float, cap_limit: int) -> tuple[int, int]:
    """(rows not in exactly one list, rows whose list scores more than
    ``tie`` below their ``r``-th best while one of their ``r`` best lists
    holds fewer than ``cap_limit`` rows)."""
    n = rows.shape[0]
    flat = lists.reshape(-1)
    live = flat >= 0
    ids = flat[live].long()
    seen = torch.bincount(ids, minlength=n)[:n]
    bad_once = int((seen != 1).sum()) + int((ids >= n).sum())
    owner = torch.full((n,), -1, dtype=torch.long, device=rows.device)
    owner[ids.clamp(max=n - 1)] = torch.arange(
        lists.shape[0], device=rows.device).repeat_interleave(lists.shape[1])[live]
    full = (lists >= 0).sum(dim=1) >= cap_limit
    cb = centroids.to(torch.bfloat16).float()
    bad_rank = 0
    for a in range(0, n, 1 << 16):
        b = min(n, a + (1 << 16))
        sc = rows[a:b].to(torch.bfloat16).float() @ cb.T
        top = torch.topk(sc, r, dim=1)
        mine = sc.gather(1, owner[a:b].clamp(min=0)[:, None])[:, 0]
        outside = mine < top.values[:, -1] - tie
        bad_rank += int((outside & ~full[top.indices].all(dim=1)).sum())
    return bad_once, bad_rank
