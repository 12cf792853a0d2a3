# Copy of mediquery_rag_tpu/models/hash_embedder.py (the port imports nothing of the JAX package).
"""Deterministic hash-feature embedder — the no-weights fallback.

The reference cannot run without a live Ollama daemon (it hard-exits,
medical_engine.py:34-37). This embedder removes that failure mode for
development, tests, and cold starts: character-bigram feature hashing into
the same 768-d space, deterministic across hosts, no model weights, no
network. Semantically it is a lexical embedder (overlapping text → nearby
vectors), which is exactly what the integration tests need; production uses
``TextEmbedder`` (the trained encoder) via the same protocol.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _mix(x: int) -> int:
    x &= 0xFFFFFFFF
    x = (x * 0x9E3779B1) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    return x


@dataclass(frozen=True)
class HashingEmbedder:
    dim: int = 768

    def embed(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for r, text in enumerate(texts):
            chars = [c for c in text if not c.isspace()]
            grams = chars + ["".join(p) for p in zip(chars, chars[1:])]
            for g in grams:
                h = _mix(hash_str(g))
                idx = h % self.dim
                sign = 1.0 if (h >> 16) & 1 else -1.0
                out[r, idx] += sign
            n = np.linalg.norm(out[r])
            if n > 0:
                out[r] /= n
        return out

    def __call__(self, texts: list[str]) -> np.ndarray:
        return self.embed(texts)


def hash_str(s: str) -> int:
    """FNV-1a over UTF-8 bytes; stable across processes (unlike hash())."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h
