"""Share of the traced sub-window in which no device operation ran."""

from perfbench.harness.probes import idle_share


def read(run):
    return idle_share(run.trace)
