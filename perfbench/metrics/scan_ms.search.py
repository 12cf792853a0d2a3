"""Mean host milliseconds of one batch's index search through its host
copy: the program's ``store.scan`` spans (``DocumentStore.batch_search`` over
``IVFIndex.search``: centroids, B9b, the copy)."""

from perfbench.harness import program_spans


def read(run):
    s = program_spans.mean_s(run, "store.scan")
    return None if s is None else s * 1e3
