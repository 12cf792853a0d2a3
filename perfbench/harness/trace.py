"""The traced sub-window: ``torch.profiler`` over a bounded stretch of steady
load, read in memory (no trace file), and the benchmark's own probes.

What it gives (``TraceData``):

- device intervals (kernels, copies, memsets) clipped to the sub-window,
  their union (``busy_s``) and the sub-window's length (``window_s``);
- device time by kernel name, and the top names for ``breakdown``;
- the longest idle gaps of the device, each named by what the host was
  doing at its middle: a benchmark span if one covers it, else the
  innermost CUDA runtime call of any thread, else "host" (Python between
  launches);
- each ``LaunchProbe``'s launches, bytes and operations over the
  sub-window, beside the device time of the kernels it names.

A ``LaunchProbe`` wraps one of the program's kernel launchers for the
traced run only: while active it adds up what each launch's arguments
need (host shapes, or device-side sums that never synchronize), and the
wrapper calls the original launcher unchanged.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch


class LaunchProbe:
    """Adds up the bytes and operations of one launcher's calls while active.

    ``need(*args, **kwargs)`` returns (bytes, ops), each a number or a 0-dim
    device tensor. ``kernel`` is a substring of the CUDA symbol the
    launcher runs."""

    def __init__(self, module, attr: str, kernel: str, kind: str, need):
        self.module, self.attr, self.kernel, self.kind = module, attr, kernel, kind
        self._need = need
        self._orig = getattr(module, attr)
        self.active = False
        self.launches = 0
        self._host = [0.0, 0.0]
        self._dev = [None, None]

        def wrapper(*args, **kwargs):
            if self.active:
                self.launches += 1
                for i, v in enumerate(self._need(*args, **kwargs)):
                    if isinstance(v, torch.Tensor):
                        v = v.double()
                        self._dev[i] = v if self._dev[i] is None else self._dev[i] + v
                    else:
                        self._host[i] += float(v)
            return self._orig(*args, **kwargs)

        # the launcher counts its launches on its module-level name, which is
        # the wrapper while the probe is in
        wrapper.launches = getattr(self._orig, "launches", 0)
        self._wrapper = wrapper
        setattr(module, attr, wrapper)

    def remove(self) -> None:
        if hasattr(self._orig, "launches"):
            self._orig.launches = self._wrapper.launches
        setattr(self.module, self.attr, self._orig)

    def totals(self) -> tuple[float, float]:
        """(bytes, ops) over the active stretch (reads the device sums)."""
        return tuple(h + (0.0 if d is None else float(d.item()))
                     for h, d in zip(self._host, self._dev))


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)      # name -> device seconds
    kernel_n: dict = field(default_factory=dict)      # name -> count
    gaps: list = field(default_factory=list)          # [label, seconds], longest first
    probes: dict = field(default_factory=dict)        # probe name -> dict

    def device_time(self, substr: str) -> tuple[float, int]:
        """Device seconds and count of the kernels whose name holds ``substr``."""
        s = sum(v for k, v in self.kernel_s.items() if substr in k)
        n = sum(v for k, v in self.kernel_n.items() if substr in k)
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [list(g) for g in self.gaps[:top]]}


SETTLE_S = 0.5     # profiled but not counted: the profiler's own start-up


def _profiler():
    """Device activity only: kernels, copies and the CUDA runtime calls of
    every thread. Recording every host operator of every thread slowed a
    7B serving iteration and took longer to read than the iteration ran."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_window(seconds: float, probes: dict, spans=None, until=None) -> TraceData:
    """Profile whatever runs now, with ``probes`` (name -> LaunchProbe)
    active, for ``seconds``, or until ``until()`` turns true if that comes
    first. ``spans()`` returns the benchmark's own spans recorded meanwhile
    as (name, start_ns, end_ns) on ``time.time_ns``'s clock, the
    profiler's."""
    torch.cuda.synchronize()
    prof = _profiler()
    prof.start()
    time.sleep(SETTLE_S)
    t0 = time.time_ns()
    for p in probes.values():
        p.active = True
    end = time.perf_counter() + seconds
    while time.perf_counter() < end and not (until and until()):
        time.sleep(0.005)
    for p in probes.values():
        p.active = False
    t1 = time.time_ns()
    torch.cuda.synchronize()
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    kernel_s: dict = {}
    kernel_n: dict = {}
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            name = e.name()
            dev.append((a, b))
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e9
            kernel_n[name] = kernel_n.get(name, 0) + 1
        elif b >= t0 and a <= t1:
            host.append((a, b, e.name()))
    busy = _merge(dev)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    own = sorted(spans() if spans else [], key=lambda s: s[1])
    host.sort(key=lambda h: h[0])
    starts = [h[0] for h in host]
    labelled = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        labelled.append([_label(mid, own, host, starts), (b - a) / 1e9])
    data = TraceData(window_s=(t1 - t0) / 1e9,
                     busy_s=sum(b - a for a, b in busy) / 1e9,
                     kernel_s=kernel_s, kernel_n=kernel_n, gaps=labelled)
    for name, p in probes.items():
        nbytes, ops = p.totals()
        secs, n = data.device_time(p.kernel)
        data.probes[name] = {"launches": p.launches, "bytes": nbytes, "ops": ops,
                             "kind": p.kind, "kernel_s": secs, "kernels": n}
    return data


def _label(mid: int, own: list, host: list, starts: list) -> str:
    for name, a, b in reversed(own):
        if a <= mid <= b:
            return f"span:{name}"
    best = None
    i = bisect.bisect_right(starts, mid)
    for j in range(i - 1, max(-1, i - 5000), -1):
        a, b, name = host[j]
        if b >= mid:
            best = name
            break
    return f"host:{best}" if best else "host"
