"""Mean host seconds of one scheduler iteration over the window: the
program's ``llm.tick`` spans (``LLMServer._tick``: admissions, prefill pieces,
one decode chunk, the harvest)."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.mean_s(run, "llm.tick")
