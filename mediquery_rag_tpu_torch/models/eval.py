# Copy of mediquery_rag_tpu/models/eval.py (numpy).
"""Held-out retrieval evaluation: unseen query phrasings -> right chunk.

The round-1 embedder was only ever scored on its own training pairs
(query == title), which measures memorization, not retrieval. This module
scores the end-to-end capability the reference gets from its pretrained
dmeta-zh encoder (/root/reference/src/medical_engine.py:43): a user
phrasing a question colloquially must still surface the right chunk.

``data/heldout_queries.tsv`` holds original paraphrases that appear
nowhere in the training corpus; the gap between train-title recall and
held-out recall is the generalization gap and both are reported.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

HELDOUT_PATH = os.path.join("data", "heldout_queries.tsv")


def load_heldout(path: str = HELDOUT_PATH) -> list[tuple[str, str]]:
    """[(chunk_id, query)] from the TSV (comment lines ignored)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cid, query = line.split("\t", 1)
            out.append((cid.strip(), query.strip()))
    return out


def retrieval_recall(
    embed: Callable[[Sequence[str]], np.ndarray],
    docs: Sequence,
    doc_ids: Sequence[str],
    queries: Sequence[str],
    gold_ids: Sequence[str],
    ks: Sequence[int] = (1, 5, 10),
    batch: int = 32,
    doc_embed: Callable | None = None,
) -> dict[str, float]:
    """recall@k of query -> gold chunk over a cosine scan of doc embeddings.

    Pure numpy scoring (the eval corpus is tiny); ``embed`` is any
    ``texts -> [n, d]`` callable returning L2-normalized rows, e.g.
    ``TextEmbedder.embed`` — the same function the ingest pipeline and the
    serving engine use, so this measures the shipping path end to end.
    ``doc_embed`` overrides document-side embedding (pass
    ``embedder.embed_docs`` with the structured chunks as ``docs`` to
    measure the field-weighted ingest path, ingest/pipeline.py).
    """
    id_row = {cid: r for r, cid in enumerate(doc_ids)}
    gold_rows = np.array([id_row[g] for g in gold_ids])

    def embed_all(texts, fn):
        parts = [np.asarray(fn(list(texts[i:i + batch])))
                 for i in range(0, len(texts), batch)]
        return np.concatenate(parts, axis=0)

    d_emb = embed_all(list(docs), doc_embed if doc_embed is not None else embed)
    q_emb = embed_all(list(queries), embed)
    scores = q_emb @ d_emb.T                       # [Q, N]
    order = np.argsort(-scores, axis=1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == gold_rows[:, None]).any(axis=1)
        out[f"recall@{k}"] = float(hit.mean())
    ranks = (order == gold_rows[:, None]).argmax(axis=1) + 1
    out["mrr"] = float((1.0 / ranks).mean())
    return out
