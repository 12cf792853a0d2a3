"""Cross-shard top-k merge (port of ``mediquery_rag_tpu/parallel/collectives.py``)
and the training mesh's collectives (the port's own).

Each shard's scan leaves a ``[B, kp]`` partial list (scores, global ids)
on its own device. Where JAX all-gathers those lists over ICI inside
``shard_map``, the port copies them to one device and merges there: the
lists are bytes, not the corpus (8 shards x k = 10 x B = 64 is 40 KB).
Merges order by (score desc, id asc), so the flat and the hierarchical
merge return the same lists.

The training mesh (``parallel/dist.py``) runs one process per rank, so its
collectives are ``torch.distributed`` calls over a group of the mesh; a
group of None (an axis of size 1) makes each of them the identity.
Megatron's conjugate pair and its kin are autograd functions:

- ``copy_to_model``: identity forward, all-reduce of the gradient over
  "model" (the input of a column-parallel product);
- ``reduce_from_model``: all-reduce forward, identity backward (the output
  of a row-parallel product);
- ``gather_from_model``: all-gather along the last dim forward, this rank's
  slice of the gradient backward (vocab-sharded logits);
- ``gather_from_data``: all-gather along dim 0 over "data" forward, this
  rank's rows of the gradient backward (InfoNCE over the global batch:
  every data rank computes the same loss from the gathered rows, so each
  rank's own rows carry the whole gradient of its inputs).

Two ranks can share one card only over gloo (NCCL refuses them); gloo
takes CUDA tensors in the sum all-reduce and the all-gather, staging them
through host memory itself (``chip_smoke.py`` phase 12 checks both on the
card), and in the MAX all-reduce and the broadcast too, so every collective
here passes its tensor to ``torch.distributed`` as it is, on any backend.
Serving over the model axis adds three (``chip_smoke.py`` phase 13 runs
them over gloo on CUDA tensors and times each call):

- ``all_reduce_max``: the row-parallel products' activation scales (each
  rank's absmax over its slice of the input dim, maxed over "model");
- ``broadcast_from_model``: the tokens model rank 0 picked, to every rank;
- ``broadcast_bytes``: the serving scheduler's record of an iteration
  (an int64 length, then the bytes), from model rank 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


# -- the training mesh's collectives ---------------------------------------------

def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` as a new tensor (``t`` itself for None)."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), by group rank."""
    if group is None:
        return [t]
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return parts


def all_reduce_flat(ts: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each of ``ts`` summed over ``group``, in one collective over their
    concatenation (one dtype)."""
    if group is None or not ts:
        return list(ts)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in ts]), group)
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in ts]), ts)]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, group, x.ndim - 1)


def gather_from_data(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, group, 0)


# -- serving over the model axis ----------------------------------------------------

def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``t`` over ``group`` as a new tensor (``t`` for None)."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def broadcast_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """Model rank 0's ``t`` on every rank of ``group`` (``t`` for None); every
    rank passes a tensor of the same shape and dtype."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


def broadcast_bytes(data: bytes | None, group, device: torch.device) -> bytes:
    """Model rank 0's ``data`` on every rank of ``group`` (the others pass
    None): its length as an int64, then its bytes. On the CPU for gloo, on
    ``device`` for NCCL, which takes only CUDA tensors."""
    dev = torch.device("cpu") if dist.get_backend(group) == "gloo" else device
    src = dist.get_global_rank(group, 0)
    n = torch.tensor([0 if data is None else len(data)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=src, group=group)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev) if data is not None
           else torch.empty(int(n.item()), dtype=torch.uint8, device=dev))
    if buf.numel():
        dist.broadcast(buf, src=src, group=group)
    return bytes(buf.cpu().numpy().tobytes())
