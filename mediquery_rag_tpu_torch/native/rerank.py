# Copy of mediquery_rag_tpu/native/rerank.py (the port imports nothing of the JAX package); the library builds into build/native/.
"""ctypes wrapper over ``native/rerank.cpp`` (OpenMP exact candidate rerank).

The host-side stage of the quantized two-stage search
(``engine/flat.py:host_rerank``): the device scan's ``rerank_factor*k``
candidates are re-scored exactly against the f16 refinement copy in host
RAM. The numpy path materializes a ``[b, kk, d]`` f32 gather; the C++
version fuses the f16 conversion into the dot and parallelizes over
queries. Its ids equal the numpy path's, stable tie-breaking included;
``engine/flat.py`` uses it when the library builds.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from mediquery_rag_tpu_torch.native import _build

MAX_KK = 512   # per-query candidate stack in the C++ kernel

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("rerank")
    if lib is None:
        return None
    lib.rerank_f16.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.rerank_f16.restype = None
    _lib = lib
    return lib


def rerank_available() -> bool:
    return _load() is not None


def native_rerank(refine: np.ndarray, q32: np.ndarray, s: np.ndarray,
                  cand_ids: np.ndarray, k: int,
                  threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k among candidates. ``refine`` [n,d] f16, ``q32`` [b,d] f32
    (already L2-normalized if cosine), ``s``/``cand_ids`` [b,kk] from the
    device scan. threads=0 -> all cores."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native rerank library unavailable")
    n, d = refine.shape
    b, kk = cand_ids.shape
    if kk > MAX_KK:
        raise ValueError(f"kk={kk} > {MAX_KK}")
    refine = np.ascontiguousarray(refine)
    q32 = np.ascontiguousarray(q32, dtype=np.float32)
    s = np.ascontiguousarray(s, dtype=np.float32)
    cand = np.ascontiguousarray(cand_ids, dtype=np.int32)
    out_s = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    if threads <= 0:
        threads = os.cpu_count() or 1
    lib.rerank_f16(
        refine.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        q32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cand.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, b, d, kk, k,
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    native_rerank.calls += 1
    return out_s, out_i


native_rerank.calls = 0
