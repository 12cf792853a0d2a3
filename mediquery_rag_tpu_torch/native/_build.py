"""Compile ``native/<name>.cpp`` (repo root) into ``build/native/lib<name>.so``.

Built at first use with a C++ compiler and rebuilt when the source is newer
than the library (an mtime check, as ``ops/_build.py`` does for the CUDA
kernels). The flags are those of ``native/Makefile`` for each library.
``$CXX`` is tried first, then ``g++`` and ``c++`` from ``PATH``: a ``$CXX``
that cannot build OpenMP code (no ``libgomp``) must not cost the library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SRC = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")
_COMMON = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
           "-funroll-loops", "-fopenmp", "-shared"]
FLAGS = {
    # IEEE-strict: the lexical vectors must be bit-identical to the Python loop
    "lexical": _COMMON + ["-fno-fast-math"],
    "rerank": _COMMON + ["-ffast-math"],
    "tokenizer": _COMMON + ["-ffast-math"],
    "hnsw": _COMMON + ["-ffast-math"],
}
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def _compilers() -> list[str]:
    found = [os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")]
    return list(dict.fromkeys(c for c in found if c))


def _compile(name: str, src: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    errors = []
    for cxx in _compilers():
        proc = subprocess.run([cxx, *FLAGS[name], "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, so)
            return
        errors.append(f"{cxx}: {proc.stderr.strip()}")
    raise OSError(f"cannot build lib{name}.so: " + " | ".join(errors or ["no compiler"]))


def load(name: str) -> ctypes.CDLL | None:
    """Build (if missing or stale) and load ``lib<name>.so``; None, with a
    warning in the log, when it cannot be built or loaded. Cached per
    process."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(NATIVE_SRC, f"{name}.cpp")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                _compile(name, src, so)
            lib = ctypes.CDLL(so)
        except OSError as e:
            logging.getLogger(__name__).warning(
                "native %s library unavailable, using the Python path: %s", name, e)
            lib = None
        _libs[name] = lib
        return lib
