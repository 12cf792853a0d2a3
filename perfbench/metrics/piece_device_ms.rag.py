"""Mean device milliseconds of one prefill piece: the stream time of the
program's ``llm.piece`` spans (one ``prefill_extend`` of up to 256 tokens,
int4 weights dequantized, B6 int8) that end in the window."""

from perfbench.harness import program_spans


def read(run):
    secs = program_spans.device_s(program_spans.named(run, "llm.piece"))
    return None if secs is None else sum(secs) / len(secs) * 1e3
