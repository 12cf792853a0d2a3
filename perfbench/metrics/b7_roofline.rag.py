"""B7 ``matvec_int4``'s share of its roofline in the traced sub-window."""

from perfbench.harness.probes import roofline_share


def read(run):
    return roofline_share(run.trace, ("b7",))
