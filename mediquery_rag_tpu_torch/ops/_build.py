"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``.cu`` file has a plain C interface and is compiled on first use by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the checkout
root (git-ignored), then loaded with ``ctypes``. No PyTorch headers are
included, so a build takes seconds, not minutes. Every C entry point takes
raw device pointers plus the CUDA stream as ``void*`` and returns
``cudaGetLastError()``; :func:`launch` calls one on its tensors' card and
:func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

# the card the launch plans size their grids and shared memory for (an H100 SXM)
SMS = 132                 # streaming multiprocessors
SMEM_PER_BLOCK = 232448   # shared memory one block may opt in to (227 KB)
SMEM_PER_SM = 233472      # shared memory of an SM (228 KB), 1 KB of it reserved per block

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library (= csrc/<name>.cu) -> {C entry point: argtypes}
SIGNATURES = {
    "flat_topk": {"flat_topk": [P, P] + [I] * 9 + [P] * 6,
                  "flat_topk_f32": [P, P] + [I] * 9 + [P] * 6},
    "matvec_int8": {"matvec_int8": [P, P, P, P, I, I, I, P]},
    "matvec_int4": {"matvec_int4": [P, P, P, P, P, I, I, I, I, I, P]},
    "flash_prefill": {"flash_prefill": [P] * 9 + [I] * 7 + [F, P],
                      "flash_prefill_int8": [P] * 11 + [I] * 7 + [F, P]},
    "flash_backward": {"flash_bwd_dq": [P] * 8 + [I] * 6 + [F, P],
                       "flash_bwd_dkv": [P] * 11 + [I] * 7 + [F, P]},
    "flash_decode": {"flash_decode": [P] * 14 + [I] * 7 + [F, P],
                     "flash_decode_int8": [P] * 16 + [I] * 7 + [F, P]},
    "quant_topk": {"int8_topk": [P, P, P] + [I] * 9 + [P] * 6,
                   "int4_topk": [P, P, P, P] + [I] * 9 + [P] * 6},
    "ivf_topk": {
        "ivf_probe_topk": [P, I, P, I] + [P] * 5 + [I] * 9 + [P] * 5,
        "ivf_probe_topk_f32": [P, I, P, I] + [P] * 5 + [I] * 9 + [P] * 5,
        "ivf_probe_topk_int8": [P, I, P, I] + [P] * 6 + [I] * 9 + [P] * 5,
        "ivf_batch_topk": [P, I, P, I] + [P] * 7 + [I] * 9 + [P] * 5,
        "ivf_batch_topk_f32": [P, I, P, I] + [P] * 7 + [I] * 9 + [P] * 5,
        "ivf_chunk_plan": [P, I, I, P, P, P],
        "ivf_batch_topk_int8": [P, I, P, I] + [P] * 8 + [I] * 9 + [P] * 5,
        "ivf_probe_topk_int4": [P, I, P, I] + [P] * 7 + [I] * 9 + [P] * 5,
        "ivf_batch_topk_int4": [P, I, P, I] + [P] * 9 + [I] * 9 + [P] * 5},
}

_locks = {name: threading.Lock() for name in SIGNATURES}
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}     # library -> nvcc wall time, this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing or older than
    the source or any shared header (``csrc/*.cuh``), load it, and declare ``argtypes`` (restype is int: the
    ``cudaError_t`` each entry returns). Thread-safe; cached per process."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        newest = max(os.path.getmtime(os.path.join(CSRC, f))
                     for f in os.listdir(CSRC) if f == f"{name}.cu" or f.endswith(".cuh"))
        if not os.path.exists(so) or os.path.getmtime(so) < newest:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(what: str, fn, t, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` with ``t``'s card made the
    current device and ``stream`` that card's current stream, and check
    its error code. The kernels launch on the runtime's current device
    (``cudaGetDevice``): a tensor on ``cuda:1`` launched while ``cuda:0``
    is current would hand one device's stream to another's launch."""
    import torch
    with torch.cuda.device(t.device):
        check(fn(*args, stream_ptr(t)), what)


def build_all() -> dict[str, float]:
    """Build every kernel library in parallel (nvcc runs outside the GIL);
    returns the nvcc seconds of each library built by this call."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        list(pool.map(load, SIGNATURES))
    return dict(build_seconds)
