"""B5 ``flash_decode_int8``'s share of its roofline (live columns only) in
the traced sub-window."""

from perfbench.harness.probes import roofline_share


def read(run):
    return roofline_share(run.trace, ("b5",))
