"""The program's own spans (``mediquery_rag_tpu_torch.obs.tracing``) that end
inside a run's window, for the readers in ``metrics/``.

The window [w0, w1) is on ``time.perf_counter``'s clock and the spans on
``time.time_ns``'s: one offset between the two, taken when read, maps the
one onto the other. A program without the recorder, a window without the
span, or a ring that dropped a span that may have ended in the window gives
None, so the metric is left out of the line."""

from __future__ import annotations

import time


def named(run, name: str) -> list | None:
    """The window's spans called ``name``, oldest first, or None."""
    try:
        from mediquery_rag_tpu_torch.obs import tracing
        window = tracing.window
    except (ImportError, AttributeError):
        return None
    off = time.time_ns() - time.perf_counter_ns()
    got = window(round(run.w0 * 1e9) + off, round(run.w1 * 1e9) + off)
    got = [s for s in got or () if s.name == name]
    return got or None


def mean_s(run, name: str) -> float | None:
    """Mean host seconds of the window's ``name`` spans."""
    got = named(run, name)
    return None if got is None else sum(s.end_ns - s.start_ns for s in got) / len(got) / 1e9


def device_s(spans: list | None) -> list | None:
    """Each span's device seconds, or None unless every one was timed."""
    if spans is None or any(s.device_s is None for s in spans):
        return None
    return [s.device_s for s in spans]
