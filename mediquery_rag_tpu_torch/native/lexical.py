# Copy of mediquery_rag_tpu/native/lexical.py (the port imports nothing of the JAX package); the library builds into build/native/.
"""ctypes wrapper over ``native/lexical.cpp`` (C++ IDF n-gram embedder).

The lexical channel's host hot loop (``models/lexical.py:
IDFHashingEmbedder._vec``) is a per-character Python loop. The C++ path
implements the 1/2-gram pipeline byte for byte (same non-space filter,
same FNV-1a/mix hashing, same first-occurrence accumulation order and
float widths), so vectors, the embedder fingerprint and every persisted
index are bit-identical. Callers fall back to the Python loop when no
compiler is available.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mediquery_rag_tpu_torch.native import _build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("lexical")
    if lib is None:
        return None
    lib.lex_vec_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.lex_vec_batch.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def fnv1a64(data: bytes) -> int:
    """64-bit FNV-1a — the IDF-table key (collision-checked at fit)."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def lex_vec_batch(texts: list[str], keys: np.ndarray, weights: np.ndarray,
                  dim: int) -> np.ndarray:
    """Unit-norm [len(texts), dim] f32 rows. ``keys`` sorted u64 gram
    keys, ``weights`` aligned f64 IDF weights."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexical library unavailable")
    blobs = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    buf = np.frombuffer(b"".join(blobs) or b"\x00", np.uint8)
    out = np.zeros((len(texts), dim), np.float32)
    keys = np.ascontiguousarray(keys, np.uint64)
    weights = np.ascontiguousarray(weights, np.float64)
    lib.lex_vec_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(len(texts)),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(keys)), ctypes.c_int32(dim),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
