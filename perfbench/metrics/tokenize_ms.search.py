"""Mean host milliseconds of the query encoder's WordPiece over one batch:
the program's ``embed.tokenize`` spans (``BertTextEmbedder.embed``)."""

from perfbench.harness import program_spans


def read(run):
    s = program_spans.mean_s(run, "embed.tokenize")
    return None if s is None else s * 1e3
