"""Shares read from a traced sub-window (``trace.TraceData``)."""

from __future__ import annotations

from perfbench.harness import roofline


def roofline_share(trace, names: tuple) -> float | None:
    """Percent of its roofline the kernel of the probes ``names`` (one
    kernel, maybe several launchers) reached: the least time its launches
    need, the larger of their bytes over 3.35 TB/s and operations over the
    type's peak, scaled from the probed launches to the kernels the trace
    saw, over the kernels' device time. None where it did not run."""
    if trace is None:
        return None
    ps = [trace.probes[n] for n in names if n in trace.probes]
    launches = sum(p["launches"] for p in ps)
    if not ps or launches == 0 or ps[0]["kernels"] == 0 or ps[0]["kernel_s"] <= 0:
        return None
    scale = ps[0]["kernels"] / launches
    need_s = max(sum(p["bytes"] for p in ps) / roofline.HBM_BPS,
                 sum(p["ops"] for p in ps) / roofline.PEAK[ps[0]["kind"]])
    return 100.0 * need_s * scale / ps[0]["kernel_s"]


def idle_share(trace) -> float | None:
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
