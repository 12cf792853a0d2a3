"""Host milliseconds per call of the store's embedder (the port's BERT
behind the benchmark's timed callable) over the window."""


def read(run):
    calls = run.c1["embed_calls"] - run.c0["embed_calls"]
    if calls <= 0:
        return None
    return (run.c1["embed_s"] - run.c0["embed_s"]) / calls * 1e3
