"""Profiler traces (port of ``mediquery_rag_tpu/obs/tracing.py``).

``capture_trace`` records the host's operators and, once CUDA is in use,
the card's kernels with ``torch.profiler``, and writes a Chrome trace
(open it in Perfetto or ``chrome://tracing``). ``annotate`` names a region
on that timeline, and on the card also as an NVTX range.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


@contextmanager
def capture_trace(log_dir: str):
    """Profile everything inside the context; on exit the trace is written
    to ``log_dir/trace_<pid>_<ns>.json``. Yields the profiler (its
    ``key_averages()`` are read after the context)::

        with capture_trace("build/trace") as prof:
            index.search(q, k=10)
    """
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))


@contextmanager
def annotate(label: str):
    """Name a region so it shows up on the trace timeline."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
