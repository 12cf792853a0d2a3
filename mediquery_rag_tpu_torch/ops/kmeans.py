"""Spherical k-means, the IVF coarse quantizer (port of ``mediquery_rag_tpu/ops/kmeans.py``).

Plain PyTorch: the JAX package computes all of this with XLA, outside any
Pallas kernel, so the products go to ``torch.matmul``. Assignment is a
``[chunk, nlist]`` product and an argmax. The centroid update is a one-hot
product per chunk, not a scatter-add: on the card ``index_add_`` adds in no
fixed order, and a centroid one ulp off moves rows across a boundary, so
the same seed would not give the same index run after run. The one-hot
product costs ``2 * chunk * nlist * D`` f32 operations per chunk, about
2 ms per Lloyd pass over 262,144 x 768 rows at nlist 1,024 on an H100.

Randomness comes from an explicit ``torch.Generator``, so the sample and
the initial rows differ from the JAX package's ``PRNGKey``; given the same
initial centroids (``init=``) the stages agree with JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from mediquery_rag_tpu_torch.ops.topk import exact_topk


def _renorm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def kmeans(
    x: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    nlist: int,
    iters: int = 10,
    chunk: int = 8192,
    balance: float = 0.0,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Spherical k-means. ``x``: ``[S, D]`` L2-normalized f32. Returns
    ``[nlist, D]``; centroids stay normalized, so assignment is a cosine
    argmax, and an empty cluster keeps its previous centroid.

    ``balance > 0`` penalizes oversubscribed clusters during assignment
    (``score - balance * (count / avg - 1)``, counts of the previous pass).
    ``init`` (``[nlist, D]``) replaces the random initial rows (drawn with
    ``generator``)."""
    s, d = x.shape
    chunk = min(chunk, s)
    avg = s / nlist
    if init is not None:
        cents = init.float()
    else:
        perm = torch.randperm(s, generator=generator, device=x.device)[:nlist]
        cents = x[perm]
    counts = torch.full((nlist,), avg, dtype=torch.float32, device=x.device)
    ids = torch.arange(nlist, device=x.device)
    for _ in range(iters):
        penalty = balance * (counts / avg - 1.0) if balance else None
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((nlist,), dtype=torch.float32, device=x.device)
        for r in range(0, s, chunk):
            xb = x[r:r + chunk]
            scores = xb @ cents.T
            if penalty is not None:
                scores = scores - penalty[None, :]
            onehot = (scores.argmax(dim=-1)[:, None] == ids[None, :]).float()
            sums += onehot.T @ xb
            counts += onehot.sum(dim=0)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts[:, None], min=1), cents)
        cents = _renorm(new)
    return cents


def _apply_split(cents, sample, over, victims, first, mid):
    """Split each cluster of ``over`` in two: its centroid pulled toward
    member row ``first`` stays in place, pulled toward ``mid`` replaces the
    centroid of ``victims`` (index arrays of one length, ``over`` and
    ``victims`` disjoint)."""
    c_over = cents[over]
    cents = cents.clone()
    cents[over] = _renorm(0.5 * (c_over + sample[first]))
    cents[victims] = _renorm(0.5 * (c_over + sample[mid]))
    return cents


def split_oversized(
    sample: torch.Tensor,
    cents: torch.Tensor,
    *,
    cap_rows: int,
    n_total: int,
    margin: float = 0.85,
    max_iters: int = 16,
    polish_iters: int = 2,
    balance: float = 0.1,
) -> torch.Tensor:
    """Balanced-split refinement: clusters whose sample-estimated row count
    exceeds ``margin * cap_rows`` are split in two, recycling the centroid
    slots of the smallest clusters (nlist never changes), then polished by
    a few Lloyd steps. A penalized phase, then an unpenalized one; every
    iterate is scored by its overflow mass under plain assignment and the
    best one is returned (the JAX package's algorithm, host control)."""
    s = sample.shape[0]
    nlist = cents.shape[0]
    cap_sample = cap_rows * s / n_total * margin
    dev = sample.device

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    best_mass, best_cents = np.inf, cents
    for bal in [balance] * max_iters + [0.0] * max_iters:
        asg = assign_clusters(sample, cents).cpu().numpy()
        counts = np.bincount(asg, minlength=nlist)
        mass = float(np.maximum(counts - cap_sample, 0).sum())
        if mass < best_mass:
            best_mass, best_cents = mass, cents
        over = np.where(counts > cap_sample)[0]
        if over.size == 0:
            break
        over = over[np.argsort(-counts[over])]
        over_set = set(over.tolist())
        victims = np.array([c for c in np.argsort(counts)
                            if c not in over_set][:over.size])
        over = over[:victims.size]
        if over.size == 0:
            break
        order = np.argsort(asg, kind="stable")
        starts = np.searchsorted(asg[order], over, side="left")
        first = order[starts]
        mid = order[starts + counts[over] // 2]
        cents = _apply_split(cents, sample, idx(over), idx(victims), idx(first),
                             idx(mid))
        if polish_iters:
            cents = kmeans(sample, nlist=nlist, iters=polish_iters, init=cents,
                           balance=bal)
    else:
        counts = np.bincount(assign_clusters(sample, cents).cpu().numpy(),
                             minlength=nlist)
        mass = float(np.maximum(counts - cap_sample, 0).sum())
        if mass < best_mass:
            best_mass, best_cents = mass, cents
    return best_cents


def assign_clusters(x: torch.Tensor, cents: torch.Tensor, *,
                    chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment for every row of ``x``: ``[N]`` i32."""
    out = [(x[r:r + chunk].float() @ cents.T).argmax(dim=-1)
           for r in range(0, x.shape[0], chunk)]
    return torch.cat(out).to(torch.int32)


def assign_clusters_topr(x: torch.Tensor, cents: torch.Tensor, *, r: int,
                         chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``r`` nearest centroids per row, best first, with scores:
    (``[N, r]`` i32, ``[N, r]`` f32). Inputs are rounded to bf16 and the
    products summed in f32, as the JAX package does (a product of two bf16
    values is exact in f32, so f32 operands give the same sums)."""
    cb = cents.to(torch.bfloat16).float()
    ids, scores = [], []
    for s0 in range(0, x.shape[0], chunk):
        sc = x[s0:s0 + chunk].to(torch.bfloat16).float() @ cb.T
        v, i = exact_topk(sc, r)
        scores.append(v)
        ids.append(i.to(torch.int32))
    return torch.cat(ids), torch.cat(scores)
