"""Mean host milliseconds of the BERT forward over one batch, through its
host copy: the program's ``embed.forward`` spans (``BertTextEmbedder.embed``)."""

from perfbench.harness import program_spans


def read(run):
    s = program_spans.mean_s(run, "embed.forward")
    return None if s is None else s * 1e3
