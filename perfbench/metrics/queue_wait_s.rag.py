"""Mean seconds a request waited in the server's queue: the program's
``llm.queue`` spans (``submit`` to the iteration that admits it) that end in
the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.mean_s(run, "llm.queue")
