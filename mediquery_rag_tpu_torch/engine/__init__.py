"""The retrieval core on the card: the exact flat index (float, int8, int4
with a host rerank), the IVF index (bf16, int8, int4 with a host rerank;
built in memory or streamed) and the host-streaming flat index for corpora
past device memory. The sharded indexes are a ROADMAP Queue A item 13."""

from mediquery_rag_tpu_torch.engine.flat import FlatIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.ivf import IVFIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.streaming import StreamingFlatIndex  # noqa: F401
