"""Device milliseconds per decode step: the stream time of the program's
``llm.decode`` spans over their steps (``n``). A chunk's stream time starts
when the prefill queued before it has run, so unlike ``step_ms.rag`` it holds
no prefill."""

from perfbench.harness import program_spans


def read(run):
    got = program_spans.named(run, "llm.decode")
    secs = program_spans.device_s(got)
    steps = 0 if got is None else sum(s.n for s in got)
    return None if secs is None or steps <= 0 else sum(secs) / steps * 1e3
