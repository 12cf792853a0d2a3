"""Spans and profiler traces (grown from ``mediquery_rag_tpu/obs/tracing.py``).

``span`` records one stretch of the program's work: a scheduler iteration,
a prefill piece, a decode chunk, a search batch and its stages. Spans are
always on and coarse (per iteration, piece, chunk, batch or request; never
per token, layer or kernel), so each costs a few microseconds. They go to a
bounded in-memory ring, read two ways: ``spans()`` (a copy of the ring, for
a benchmark or a debugging session) and ``totals()`` (per-name count, host
seconds, device seconds and items since start, which ``/metrics`` exports).

Times are ``time.time_ns()``, the clock ``torch.profiler`` stamps its events
with, so a span lines up with the kernels of a trace taken meanwhile. A span
opened with ``device=`` on a CUDA device also records a pair of timing events
on that device's current stream: the stream time from its first launch to its
last. Those events are read once the device has passed them (an event query,
which never waits), so timing adds no synchronization; until then, and
without CUDA, the device time is None.

While a ``torch.profiler`` runs in the process, and only then, each span also
opens a ``record_function`` (and on a card an NVTX range) of its name, so
the program's spans appear on the trace's timeline. ``capture_trace`` records
every thread's, the server's worker threads included.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

import torch

CAPACITY = 1 << 16          # records the ring keeps: a minute of search batches, many of chat


class SpanRecord(NamedTuple):
    """One finished span. ``rid``: the request or batch it belongs to;
    ``parent``: the ``sid`` of the span open on the same thread when it
    opened; ``n``: the items it handled; ``device_s``: stream seconds from its
    first launch to its last (None: not timed on a device, or not read yet)."""

    name: str
    start_ns: int
    end_ns: int
    rid: int | None
    parent: int | None
    n: int
    device_s: float | None
    sid: int


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is running anywhere in the process (the
    profiler's own process-wide flag; the autograd check is per thread)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


def _cuda(device) -> torch.device | None:
    """The CUDA device to time a span on, or None (host only)."""
    if device is None or device is False or not torch.cuda.is_available():
        return None
    dev = torch.device("cuda") if device is True else torch.device(device)
    return dev if dev.type == "cuda" else None


class Span:
    """An open span; set ``n`` before it closes where the count is known
    only at the end."""

    __slots__ = ("name", "rid", "n", "sid", "parent", "start_ns", "_rec", "_dev",
                 "_events", "_rf", "_nvtx")

    def __init__(self, recorder: "Recorder", name: str, rid, n: int, device):
        self._rec, self.name, self.rid, self.n, self._dev = recorder, name, rid, n, device

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        self.parent = stack[-1] if stack else None
        self.sid = next(self._rec._ids)
        stack.append(self.sid)
        dev = _cuda(self._dev)
        self._events = None
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            first = torch.cuda.Event(enable_timing=True)
            first.record(stream)
            self._events = (first, torch.cuda.Event(enable_timing=True), stream)
        self._rf = self._nvtx = None
        if _profiling():
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        events = None
        if self._events is not None:
            first, last, stream = self._events
            last.record(stream)
            events = (first, last)
        self._rec._stack().pop()
        self._rec._add([self.name, self.start_ns, end, self.rid, self.parent, self.n, None,
                        self.sid], events)


class Recorder:
    """A bounded ring of spans, per-name totals and a count of the records
    the ring dropped. Safe to use from any thread."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._totals: dict[str, list] = {}     # name -> [count, host_s, device_s, n]
        self._pending: list = []               # (record, first event, last event)
        self.dropped = 0
        self.dropped_end_ns = 0                # the latest end among dropped records

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def span(self, name: str, *, rid=None, n: int = 0, device=False) -> Span:
        """A context manager that records ``name`` over its body. ``device``:
        True or a CUDA device also times the body's launches on the device's
        current stream (a CPU device or no CUDA: host time only)."""
        return Span(self, name, rid, n, device)

    def record(self, name: str, start_ns: int, end_ns: int, *, rid=None, n: int = 0) -> None:
        """Record a span whose edges were known only later (a request's wait
        in the queue): ``time.time_ns()`` values."""
        stack = self._stack()
        self._add([name, start_ns, end_ns, rid, stack[-1] if stack else None, n, None,
                   next(self._ids)], None)

    def _add(self, rec: list, events) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                self.dropped_end_ns = max(self.dropped_end_ns, self._ring[0][2])
            self._ring.append(rec)
            t = self._totals.get(rec[0])
            if t is None:
                t = self._totals[rec[0]] = [0, 0.0, 0.0, 0]
            t[0] += 1
            t[1] += (rec[2] - rec[1]) / 1e9
            t[3] += rec[5]
            if events is not None:
                self._pending.append((rec, *events))
                settle = len(self._pending) >= 64
            else:
                settle = False
        if settle:
            self.settle()

    def settle(self) -> None:
        """Read the device time of every timed span the device has passed;
        never waits for the device."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep, done = [], []
        for rec, first, last in pending:
            if last.query():
                done.append((rec, first.elapsed_time(last) / 1e3))
            else:
                keep.append((rec, first, last))
        with self._lock:
            self._pending = keep + self._pending
            for rec, secs in done:
                rec[6] = secs
                self._totals[rec[0]][2] += secs

    def spans(self) -> list[SpanRecord]:
        """The ring's records, oldest first."""
        self.settle()
        with self._lock:
            return [SpanRecord(*r) for r in self._ring]

    def window(self, start_ns: int, end_ns: int) -> list[SpanRecord] | None:
        """The records that end in [start_ns, end_ns), or None when the ring
        has dropped a record that may have ended there."""
        self.settle()
        with self._lock:
            if self.dropped and self.dropped_end_ns >= start_ns:
                return None
            return [SpanRecord(*r) for r in self._ring if start_ns <= r[2] < end_ns]

    def totals(self) -> dict[str, dict]:
        """Per name since start: ``count``, ``host_s``, ``device_s`` (the
        timed spans read so far) and ``n``."""
        self.settle()
        with self._lock:
            return {k: {"count": c, "host_s": h, "device_s": d, "n": n}
                    for k, (c, h, d, n) in self._totals.items()}


RECORDER = Recorder()       # the process's recorder: the program's spans go here
span, record, spans, window, totals = (RECORDER.span, RECORDER.record, RECORDER.spans,
                                       RECORDER.window, RECORDER.totals)


@contextmanager
def capture_trace(log_dir: str):
    """Profile everything inside the context, every thread's operators and
    spans and, once CUDA is in use, the card's kernels; on exit the trace is
    written to ``log_dir/trace_<pid>_<ns>.json``. Yields the profiler (its
    ``key_averages()`` are read after the context)::

        with capture_trace("build/trace") as prof:
            index.search(q, k=10)
    """
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))
