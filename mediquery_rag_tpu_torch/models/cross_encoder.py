# Copy of SimilarityGrader from mediquery_rag_tpu/models/cross_encoder.py (that module imports jax).
"""Embedding-similarity document grader (numpy only)."""

from __future__ import annotations

import numpy as np


class SimilarityGrader:
    """Bi-encoder threshold grader: the graph's ``grade_fn(question,
    doc_texts) -> bool`` plug point, true when any document's embedding
    cosine with the question reaches ``threshold``."""

    def __init__(self, embedder, threshold: float = 0.3):
        self.embedder = embedder          # texts -> [n, d] unit rows
        self.threshold = threshold

    def __call__(self, question: str, doc_texts: list[str]) -> bool:
        if not doc_texts:
            return False
        embs = np.asarray(self.embedder([question] + list(doc_texts)))
        return bool((embs[1:] @ embs[0]).max() >= self.threshold)
