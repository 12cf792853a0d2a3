"""The int8 IVF scans' (B9b, and B8b where a batch is small) share of
their roofline in the traced sub-window: each distinct probed list's live
rows and scales read once."""

from perfbench.harness.probes import roofline_share


def read(run):
    return roofline_share(run.trace, ("ivf", "ivf_probe"))
