"""Output tokens the server emitted inside the window, per second. A
request that straddles an edge counts the part of its tokens that its
[first token, done] span has inside the window, spread evenly."""

from perfbench.harness.window import prorated


def read(run):
    n = sum(prorated(r.n_out, r.t_first, r.t_done, run.w0, run.w1)
            for r in run.records if r.ok and r.t_first is not None)
    return n / run.seconds
