"""Queries answered inside the window, per second."""

from perfbench.harness.window import in_window


def read(run):
    return sum(1 for r in run.records if r.ok and in_window(r.t_done, run.w0, run.w1)) / run.seconds
