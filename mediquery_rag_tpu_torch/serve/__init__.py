"""HTTP serving: the port's ``SearchServer`` (a copy of the JAX package's)
and micro-batcher over the port's store and decoder."""

from mediquery_rag_tpu_torch.serve.batcher import BatchingSearchService  # noqa: F401
from mediquery_rag_tpu_torch.serve.server import SearchServer, build_server  # noqa: F401
