"""MediQuery on PyTorch + CUDA (NVIDIA Hopper).

A port of ``mediquery_rag_tpu`` (JAX + Pallas on a TPU, kept as the
reference). The layout mirrors the JAX package (``ops/``, ``engine/``,
``ingest/``, ``models/``, ``llm/``, ``serve/``, ``obs/``, ``cli/``); every
Pallas kernel on the serving path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use. Modules of
the JAX package that need no JAX (``config``, ``graph``, ``llm.client``,
``llm.messages``, ``llm.web``, ``serve.batcher``, ``SearchServer``,
``app.memory``, the ``native`` wrappers, ...) are copied, each with a
header naming its source. This package imports neither jax nor anything
of ``mediquery_rag_tpu``. Entry points that take a ``device`` default to
``"cuda"``; the tests pass ``device="cpu"``.
"""
