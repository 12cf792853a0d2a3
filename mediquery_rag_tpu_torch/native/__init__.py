"""ctypes wrappers over the repo's host C++ kernels (``native/*.cpp``):
the IDF lexical embedder, the exact f16 candidate rerank, the
character-hash tokenizer and the HNSW index. Each library
is compiled from its source at first use into ``build/native/``
(git-ignored); the ``.so`` files committed under ``native/`` are never
loaded, since they may not match the host that runs the port."""

from mediquery_rag_tpu_torch.native.hnsw import HNSWIndex, hnsw_available  # noqa: F401
