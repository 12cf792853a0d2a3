"""Host milliseconds per decode step over the window: the server's
``decode_s`` (wall time of its decode-chunk loops) over its ``steps``."""


def read(run):
    steps = run.c1["steps"] - run.c0["steps"]
    if steps <= 0:
        return None
    return (run.c1["decode_s"] - run.c0["decode_s"]) / steps * 1e3
