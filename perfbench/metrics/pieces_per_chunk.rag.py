"""Prefill pieces landed per decode chunk over the window, from the
server's own counters (``LLMServer.stats``): how many 256-token pieces
each scheduler iteration lands beside its decode chunk."""


def read(run):
    chunks = run.c1["chunks"] - run.c0["chunks"]
    if chunks <= 0:
        return None
    return (run.c1["prefill_pieces"] - run.c0["prefill_pieces"]) / chunks
