# Copy of mediquery_rag_tpu/engine/tuning.py (the port imports nothing of the JAX package).
"""Recall-driven nprobe tuning.

SURVEY §7 hard part (c): hitting ">=10x QPS *at recall parity*" requires
knowing the smallest nprobe that reaches the target recall on the actual
corpus geometry — not a guess. ``tune_nprobe`` measures recall against an
exact oracle on a query sample and returns the cheapest passing setting.
"""

from __future__ import annotations

from mediquery_rag_tpu_torch.obs.metrics import recall_at_k


def tune_nprobe(
    index,
    oracle_index,
    queries,
    *,
    k: int = 10,
    target_recall: float = 0.95,
    candidates: tuple = (1, 2, 4, 8, 16, 32, 64, 128),
) -> dict:
    """Smallest nprobe whose recall@k (vs ``oracle_index`` exact search on
    ``queries``) meets ``target_recall``.

    Returns {"nprobe", "recall", "sweep": [(nprobe, recall), ...]}; falls
    back to the best candidate if none reaches the target.
    """
    import numpy as np

    _, i_ref = oracle_index.search(queries, k=k)
    i_ref = np.asarray(i_ref)
    sweep = []
    best = None
    nlist = index.centroids.shape[0]
    for np_ in candidates:
        if np_ > nlist:
            break
        _, i_got = index.search(queries, k=k, nprobe=np_)
        rec = recall_at_k(np.asarray(i_got), i_ref)
        sweep.append((np_, rec))
        if best is None or rec > best[1]:
            best = (np_, rec)
        if rec >= target_recall:
            return {"nprobe": np_, "recall": rec, "sweep": sweep}
    return {"nprobe": best[0], "recall": best[1], "sweep": sweep}
