"""Corpus ingest: parse + embed + flat index build."""

from mediquery_rag_tpu_torch.ingest.parser import Chunk, parse_corpus, parse_corpus_file  # noqa: F401
from mediquery_rag_tpu_torch.ingest.pipeline import DocumentStore, build_document_store  # noqa: F401
