"""ctypes wrappers over the repo's host C++ kernels (``native/*.cpp``):
the IDF lexical embedder, the exact f16 candidate rerank and the
character-hash tokenizer. Each library
is compiled from its source at first use into ``build/native/``
(git-ignored); the ``.so`` files committed under ``native/`` are never
loaded, since they may not match the host that runs the port."""
