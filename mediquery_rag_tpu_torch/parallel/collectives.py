"""Cross-shard top-k merge (port of ``mediquery_rag_tpu/parallel/collectives.py``).

Each shard's scan leaves a ``[B, kp]`` partial list (scores, global ids)
on its own device. Where JAX all-gathers those lists over ICI inside
``shard_map``, the port copies them to one device and merges there: the
lists are bytes, not the corpus (8 shards x k = 10 x B = 64 is 40 KB).
Merges order by (score desc, id asc), so the flat and the hierarchical
merge return the same lists.
"""

from __future__ import annotations

import torch

from mediquery_rag_tpu_torch.ops.topk import merge_topk_many


def sharded_topk_merge(scores: list[torch.Tensor], idx: list[torch.Tensor], k: int, *,
                       device: torch.device | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge the shards' partial lists into the global ``([B, k], [B, k])``
    on ``device`` (default: the first list's device)."""
    device = scores[0].device if device is None else device
    gs = torch.stack([s.to(device, non_blocking=True) for s in scores])   # [S, B, kp]
    gi = torch.stack([i.to(device, non_blocking=True) for i in idx])
    return merge_topk_many(gs, gi, k)


def hierarchical_topk_merge(scores: list[torch.Tensor], idx: list[torch.Tensor], k: int, *,
                            groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level merge over ``groups`` runs of consecutive shards (the
    ``dcn`` axis of a ``(dcn, ici)`` mesh): each group's lists are merged
    to k on the group's first device, then only the ``groups`` x k
    finalists travel to the first group's device for the last merge."""
    if len(scores) % groups:
        raise ValueError(f"{len(scores)} shards do not divide into {groups} groups")
    per = len(scores) // groups
    finals = [sharded_topk_merge(scores[g * per:(g + 1) * per], idx[g * per:(g + 1) * per], k)
              for g in range(groups)]
    return sharded_topk_merge([f[0] for f in finals], [f[1] for f in finals], k)


def grouped_topk_merge(scores: list[torch.Tensor], idx: list[torch.Tensor], k: int,
                       mesh, axes: tuple[str, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge over the mesh ``axes`` the rows were split along: one axis ->
    the flat merge; two ``(dcn, ici)`` -> the hierarchical one."""
    if len(axes) == 1:
        return sharded_topk_merge(scores, idx, k, device=mesh.flat()[0])
    if len(axes) == 2:
        return hierarchical_topk_merge(scores, idx, k, groups=mesh.shape[axes[0]])
    raise ValueError(f"expected 1 or 2 mesh axes, got {axes!r}")
