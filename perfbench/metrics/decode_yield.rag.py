"""Share of the decode's lane-steps whose token a transcript kept: the
tokens the program's ``llm.harvest`` spans appended over the lanes
(``slots``) times the steps of its ``llm.decode`` spans, in the window. Lanes
still landing their prompt and tokens past a request's budget are the rest.
A speculative quantum's tokens (``llm.spec_harvest``) are not counted."""

from perfbench.harness import program_spans


def read(run):
    kept = program_spans.named(run, "llm.harvest")
    chunks = program_spans.named(run, "llm.decode")
    if kept is None or chunks is None:
        return None
    lane_steps = run.cfg["slots"] * sum(s.n for s in chunks)
    return None if lane_steps <= 0 else 100.0 * sum(s.n for s in kept) / lane_steps
