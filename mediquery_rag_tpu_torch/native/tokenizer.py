# Copy of mediquery_rag_tpu/native/tokenizer.py (the port imports nothing of the JAX package); the library builds into build/native/.
"""ctypes wrapper over ``native/tokenizer.cpp`` (C++ batch tokenizer).

The host-side data-loader hot path: the per-character Python loop of
``models/tokenizer.py`` runs ~1.4 Mchar/s. The C++ path implements the
same codepoint slice, ``str.isspace`` skip and splitmix hash
(``native/tokenizer.cpp``); exactness is load-bearing because the embedder
fingerprint, and so every persisted index, depends on tokenization
(``tests/test_torch_encoders.py`` holds native == Python == the JAX
package on adversarial inputs). The library is built at first use by
``native/_build.py``; callers use the Python loop when no compiler can
build it (logged once).
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
    lib = _build.load("tokenizer")
    if lib is None:
        return None
    lib.tok_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tok_batch.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def tok_batch(texts: list[str], vocab_size: int, slice_len: int,
              cap_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize a batch natively. Returns (ids [B, cap_len] i32, lens [B]).

    Raises RuntimeError if the native library is unavailable: callers
    (``HashCharTokenizer.batch_encode``) check ``native_available`` first.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native tokenizer library unavailable")
    raw = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in raw], out=offsets[1:])
    buf = np.frombuffer(b"".join(raw) or b"\x00", dtype=np.uint8)
    ids = np.empty((len(texts), cap_len), dtype=np.int32)
    lens = np.empty(len(texts), dtype=np.int32)
    lib.tok_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), vocab_size, slice_len, cap_len,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return ids, lens
