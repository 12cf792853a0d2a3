# Copy of mediquery_rag_tpu/models/tokenizer.py (numpy; the native path is the port's native.tokenizer).
"""Deterministic character-hash tokenizer.

The reference shipped no tokenizer: it lived inside the Ollama daemon. For
Chinese medical text a character-level vocabulary is a solid baseline (CJK
has no whitespace segmentation), and hashing each codepoint into a fixed
vocab keeps the tokenizer dependency-free, O(1)-memory, and identical across
hosts, which matters because the corpus and every query must agree forever.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2


@dataclass(frozen=True)
class HashCharTokenizer:
    vocab_size: int = 16384
    max_len: int = 512

    def _char_id(self, ch: str) -> int:
        # splitmix-style scramble of the codepoint; stable across runs/hosts.
        x = ord(ch) & 0xFFFFFFFF
        x = (x * 0x9E3779B1) & 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        return _RESERVED + (x % (self.vocab_size - _RESERVED))

    def encode(self, text: str) -> list[int]:
        ids = [CLS_ID]
        for ch in text[: self.max_len - 1]:
            if ch.isspace():
                continue
            ids.append(self._char_id(ch))
        return ids

    def batch_encode(self, texts: list[str], max_len: int | None = None):
        """Returns (ids [B, L] i32, mask [B, L] f32), L = min(longest, max_len),
        padded to a multiple of 128.

        Uses the native C++ tokenizer when it builds (bit-identical output,
        held in tests) and the Python loop otherwise.
        """
        max_len = self.max_len if max_len is None else max_len
        from mediquery_rag_tpu_torch.native.tokenizer import (
            native_available, tok_batch)

        if texts and native_available():
            ids_full, lens = tok_batch(
                texts, self.vocab_size, self.max_len - 1, max_len)
            longest = int(lens.max()) if len(lens) else 1
            length = min(-(-longest // 128) * 128, max_len)
            ids = np.ascontiguousarray(ids_full[:, :length])
            mask = (np.arange(length)[None, :] < lens[:, None]).astype(
                np.float32)
            return ids, mask

        encoded = [self.encode(t)[:max_len] for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        length = min(-(-longest // 128) * 128, max_len)
        ids = np.full((len(texts), length), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), length), dtype=np.float32)
        for r, e in enumerate(encoded):
            e = e[:length]
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1.0
        return ids, mask
