"""Queries per ``store.batch_search`` call over the window, counted by the
benchmark's wrapper around the store the batching service calls."""


def read(run):
    calls = run.c1["batch_calls"] - run.c0["batch_calls"]
    if calls <= 0:
        return None
    return (run.c1["batch_queries"] - run.c0["batch_queries"]) / calls
