"""Mean host milliseconds of building one batch's results from the index's
lists: the program's ``store.assemble`` spans (``DocumentStore._rows`` for
each query)."""

from perfbench.harness import program_spans


def read(run):
    s = program_spans.mean_s(run, "store.assemble")
    return None if s is None else s * 1e3
