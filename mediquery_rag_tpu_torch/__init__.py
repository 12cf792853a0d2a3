"""MediQuery on PyTorch + CUDA (NVIDIA Hopper).

A port of ``mediquery_rag_tpu`` (JAX + Pallas on a TPU, kept as the
reference). The layout mirrors the JAX package (``ops/``, ``engine/``,
``ingest/``, ``models/``, ``llm/``, ``serve/``, ``obs/``, ``cli/``); every
Pallas kernel on the serving path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use. Framework-free
modules of the JAX package whose package ``__init__`` does not import jax
(``config``, ``graph``, ``llm.client``, ``llm.messages``, ``serve.server``,
``serve.batcher``, ``app.memory``, ``native``) are shared, not copied.
This package never imports jax.
"""
