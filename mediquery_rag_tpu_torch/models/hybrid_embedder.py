# Copy of mediquery_rag_tpu/models/hybrid_embedder.py (numpy); from_checkpoint builds the port's TextEmbedder on ``device``.
"""Hybrid lexical+semantic embedder — opt-in fusion for trainable corpora.

The reference ships a pretrained zh encoder (dmeta-embedding-zh,
/root/reference/src/medical_engine.py:43); with zero-egress no pretrained
weights exist here. Measured on the 70-query held-out paraphrase set
(benchmarks/retrieval_eval.py, r3 recipe):

    recall@1/@10   IDF lexical alone 0.857/1.0 | trained encoder 0.50/0.77
                   | hybrid w_lex=0.9 0.857/0.986

At 160-chunk scale the from-scratch encoder memorizes (train recall@1
0.994) and fusion only subtracts, so the CLI ships the IDF lexical channel
alone and enables this fusion behind MEDIQUERY_HYBRID=1 — the right
config once the corpus is large enough for the encoder to generalize.

The fusion is ONE embedder whose output is the weighted concat

    [ sqrt(w) * norm(lex(x)) , sqrt(1-w) * norm(sem(x)) ]

so a plain dot product between two outputs equals
``w * cos_lex + (1-w) * cos_sem``: the engine (FlatIndex/IVFIndex, the
scan kernels, quantization) needs no changes, it just sees a
wider unit-norm vector. Output rows are exactly unit norm.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class HybridEmbedder:
    """Weighted concat of a lexical and a semantic embedder.

    ``w_lex=0.9`` is the held-out-measured best fusion weight with the
    IDF lexical channel at 160-chunk training scale
    (benchmarks/retrieval_eval.py sweeps it).
    """

    def __init__(self, lexical: Callable, semantic: Callable,
                 w_lex: float = 0.8):
        if not 0.0 < w_lex < 1.0:
            raise ValueError(f"w_lex must be in (0,1), got {w_lex}")
        self.lexical = lexical
        self.semantic = semantic
        self.w_lex = float(w_lex)

    @staticmethod
    def _norm(x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-9)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        lex = self._norm(self.lexical(list(texts)))
        sem = self._norm(self.semantic(list(texts)))
        return np.concatenate(
            [np.sqrt(self.w_lex) * lex, np.sqrt(1.0 - self.w_lex) * sem],
            axis=1)

    def embed_docs(self, chunks) -> np.ndarray:
        """Structured-document path (ingest pipeline hook): the lexical
        channel gets the chunks when it is field-weighted
        (IDFHashingEmbedder.embed_docs), the semantic channel always
        embeds the rendered text."""
        lex_fn = getattr(self.lexical, "embed_docs", None)
        texts = [c.text for c in chunks]
        lex = self._norm(lex_fn(chunks) if lex_fn is not None
                         else self.lexical(texts))
        sem = self._norm(self.semantic(texts))
        return np.concatenate(
            [np.sqrt(self.w_lex) * lex, np.sqrt(1.0 - self.w_lex) * sem],
            axis=1)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed(texts)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, *, w_lex: float = 0.8,
                        lex_dim: int = 768,
                        lexical: Callable | None = None,
                        device: str = "cuda") -> "HybridEmbedder":
        """Trained-encoder checkpoint (served from ``device``) + a lexical
        channel (defaults to the dependency-free hashing embedder; pass a
        fitted ``IDFHashingEmbedder`` for the shipping config)."""
        from mediquery_rag_tpu_torch.models.text_embedder import TextEmbedder
        if lexical is None:
            from mediquery_rag_tpu_torch.models.hash_embedder import HashingEmbedder
            lexical = HashingEmbedder(lex_dim)
        return cls(lexical, TextEmbedder.from_checkpoint(ckpt_dir, device=device),
                   w_lex=w_lex)
