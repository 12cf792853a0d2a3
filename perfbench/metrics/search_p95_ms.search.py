"""95th percentile of the time from submit to result, over every query
answered inside the window, in milliseconds."""

from perfbench.harness.window import in_window, percentile


def read(run):
    v = percentile([r.t_done - r.t_send for r in run.records
                    if in_window(r.t_done, run.w0, run.w1)], 95)
    return None if v is None else v * 1e3
