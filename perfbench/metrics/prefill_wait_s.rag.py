"""Mean seconds from a request's admission to its prompt landed in its
lane (the last prefill piece, or the whole prefill): the program's
``llm.prefill`` spans that end in the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.mean_s(run, "llm.prefill")
