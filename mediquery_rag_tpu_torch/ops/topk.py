"""Top-k selection and merge primitives (port of ``mediquery_rag_tpu/ops/topk.py``).

Plain PyTorch with the fused scan kernel's order: sorted by score
descending and, among equal scores, by index ascending (a stable sort), so
an equal score never displaces an earlier incumbent.
"""

from __future__ import annotations

import torch


def exact_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis. Returns (values, indices), sorted desc."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_topk(scores_a: torch.Tensor, idx_a: torch.Tensor,
               scores_b: torch.Tensor, idx_b: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial top-k lists along the last axis ([..., ka] and
    [..., kb] -> [..., k]); list ``a`` wins ties over list ``b``."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([idx_a, idx_b], dim=-1)
    vals, pos = exact_topk(s, k)
    return vals, torch.gather(i, -1, pos)


def merge_topk_many(scores: torch.Tensor, idx: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge ``[n_parts, ..., kp]`` partial lists into one ``[..., k]``
    list, ordered by (score desc, id asc): the order of every scan of the
    port, so the merged list does not depend on how the rows were split
    (the JAX package's ``lax.top_k`` orders tied scores by part)."""
    s = torch.movedim(scores, 0, -2).flatten(-2)
    i = torch.movedim(idx, 0, -2).flatten(-2)
    order = torch.argsort(i, dim=-1, stable=True)
    s, i = torch.gather(s, -1, order), torch.gather(i, -1, order)
    vals, pos = exact_topk(s, k)
    return vals, torch.gather(i, -1, pos)
