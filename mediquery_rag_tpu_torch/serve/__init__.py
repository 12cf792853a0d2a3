"""HTTP serving: the port's ``SearchServer`` (a copy of the JAX package's),
micro-batcher and continuous-batching ``LLMServer`` over the port's store
and decoder."""

from mediquery_rag_tpu_torch.serve.batcher import BatchingSearchService  # noqa: F401
from mediquery_rag_tpu_torch.serve.llm import (  # noqa: F401
    ChatSession, LLMServer, ServedLLMClient, ServerSaturated)
from mediquery_rag_tpu_torch.serve.server import (  # noqa: F401
    SearchServer, build_app_server, build_server)
