"""90th percentile of the time from the client's send to the first token,
over every request whose first token falls in the window (the window of
the traced run, before its profiled stretch)."""

from perfbench.harness.window import in_window, percentile


def read(run):
    return percentile([r.t_first - r.t_send for r in run.records
                       if in_window(r.t_first, run.w0, run.w1)], 90)
