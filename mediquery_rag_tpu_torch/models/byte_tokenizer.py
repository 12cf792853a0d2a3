# Copy of mediquery_rag_tpu/models/byte_tokenizer.py (the port imports nothing of the JAX package).
"""Reversible byte-level tokenizer for the TPU-hosted causal LM.

The retrieval-side ``HashCharTokenizer`` is one-way (codepoints are hashed
into a fixed vocab) — fine for an encoder, useless for generation. The LM
needs decode(), so it tokenizes raw UTF-8 bytes: 256 byte ids + PAD/BOS/EOS,
fully reversible, deterministic across hosts, zero vocabulary files. This is
the in-repo replacement for the tokenizer that lived inside the Ollama
daemon (reference medical_engine.py:46 — the chat model's BPE was a GGML
internal, never in the reference tree).

Batch encoding is LEFT-padded: every sequence ends at the same column, so
batched decoding appends generated tokens at one shared cursor — the
standard serving layout for batched KV-cache generation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_BYTE0 = 3          # byte b encodes as _BYTE0 + b
VOCAB_USED = _BYTE0 + 256


@dataclass(frozen=True)
class ByteTokenizer:
    max_len: int = 1024

    # uniform tokenizer interface (shared with models.bpe_tokenizer.BPETokenizer)
    pad_id: int = PAD_ID
    eos_id: int = EOS_ID

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
        ids = [BOS_ID] if bos else []
        ids.extend(_BYTE0 + b for b in text.encode("utf-8"))
        if eos:
            ids.append(EOS_ID)
        return ids[: self.max_len]

    def decode(self, ids) -> str:
        """Inverse of encode: stops at EOS, skips PAD/BOS, tolerates the
        truncated trailing multi-byte sequence a length cap can produce."""
        out = bytearray()
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if _BYTE0 <= i < VOCAB_USED:  # ids in the padded vocab tail are noise
                out.append(i - _BYTE0)
        return out.decode("utf-8", errors="ignore")

    def byte_token_ids(self) -> np.ndarray:
        """[256] token id of each raw byte — the vocab projection used by
        grammar-constrained decoding (models/constrain.py)."""
        return np.arange(_BYTE0, _BYTE0 + 256, dtype=np.int32)

    def token_byte_table(self, vocab_size: int | None = None,
                         max_bytes: int | None = None):
        """(tok_bytes [V, 1] int32, tok_len [V] int32) — the token-level
        constraint tables (see BPETokenizer.token_byte_table): here every
        real token IS one byte, specials get len 0."""
        V = vocab_size or VOCAB_USED
        tok_bytes = np.zeros((V, 1), dtype=np.int32)
        tok_len = np.zeros((V,), dtype=np.int32)
        tok_bytes[_BYTE0:VOCAB_USED, 0] = np.arange(256)
        tok_len[_BYTE0:VOCAB_USED] = 1
        return tok_bytes, tok_len

    def batch_encode(self, texts: list[str], *, pad_to: int | None = None):
        """Left-padded batch. Returns (ids [B,L] i32, mask [B,L] f32) with L
        a multiple of 128 (TPU lanes), or exactly ``pad_to`` when given."""
        encoded = [self.encode(t) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        if pad_to is None:
            length = min(-(-longest // 128) * 128, self.max_len)
        else:
            if pad_to < longest:
                raise ValueError(f"pad_to={pad_to} < longest prompt {longest}")
            length = pad_to
        ids = np.full((len(texts), length), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), length), dtype=np.float32)
        for r, e in enumerate(encoded):
            e = e[-length:]
            ids[r, length - len(e):] = e
            mask[r, length - len(e):] = 1.0
        return ids, mask
