"""ctypes wrapper over the repo's C++ HNSW (``native/hnsw.cpp``; port of
``mediquery_rag_tpu/native/hnsw.py``).

The library is built at first use into ``build/native/`` by
``native/_build.py``. It is the CPU-side ANN index that recall is compared
with (the stand-in for Chroma's hnswlib); there is no Python fallback, so
:func:`hnsw_available` says whether it built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mediquery_rag_tpu_torch.native import _build

_declared = False


def _load() -> ctypes.CDLL:
    global _declared
    lib = _build.load("hnsw")
    if lib is None:
        raise OSError("native hnsw library unavailable (no C++ compiler built native/hnsw.cpp)")
    if not _declared:
        lib.hnsw_create.restype = ctypes.c_void_p
        lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.hnsw_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.hnsw_search_batch.restype = ctypes.c_int
        lib.hnsw_search_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.hnsw_memory_bytes.restype = ctypes.c_uint64
        lib.hnsw_memory_bytes.argtypes = [ctypes.c_void_p]
        lib.hnsw_size.restype = ctypes.c_uint64
        lib.hnsw_size.argtypes = [ctypes.c_void_p]
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        _declared = True
    return lib


def hnsw_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class HNSWIndex:
    """Cosine-metric HNSW over L2-normalized float32 vectors."""

    def __init__(self, dim: int, M: int = 16, ef_construction: int = 200):
        self._lib = _load()
        self._h = self._lib.hnsw_create(dim, M, ef_construction)
        self.dim = dim

    def add(self, vectors: np.ndarray, labels: np.ndarray | None = None) -> None:
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n = v.shape[0]
        if labels is None:
            labels = np.arange(self.size, self.size + n, dtype=np.uint64)
        lab = np.ascontiguousarray(labels, dtype=np.uint64)
        self._lib.hnsw_add_batch(
            self._h, v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n)

    def search(self, queries: np.ndarray, k: int, ef: int = 64, threads: int = 1):
        """Batch top-k: (scores ``[B, k]`` f32, labels ``[B, k]`` i64).
        ``threads`` > 1 (or 0 = all cores) runs the batch through the
        OpenMP path: per-thread visited tables over the read-only graph."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None]
        b = q.shape[0]
        labels = np.zeros((b, k), dtype=np.uint64)
        scores = np.full((b, k), -np.inf, dtype=np.float32)
        counts = np.zeros(b, dtype=np.int32)
        self._lib.hnsw_search_batch(
            self._h, q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, k, ef,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
        return scores, labels.astype(np.int64)

    @property
    def size(self) -> int:
        return int(self._lib.hnsw_size(self._h))

    @property
    def nbytes(self) -> int:
        return int(self._lib.hnsw_memory_bytes(self._h))

    def __del__(self):
        try:
            self._lib.hnsw_free(self._h)
        except Exception:
            pass
