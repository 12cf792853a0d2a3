"""HTTP serving: the shared ``SearchServer`` over the port's store and decoder."""

from mediquery_rag_tpu_torch.serve.server import build_server  # noqa: F401
