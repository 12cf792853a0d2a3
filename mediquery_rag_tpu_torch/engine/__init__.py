"""The retrieval core on the card: the exact flat index (float, int8, int4
with a host rerank), the IVF index (bf16, int8, int4 with a host rerank;
built in memory or streamed), the host-streaming flat index for corpora
past device memory, and the sharded flat and IVF indexes, which split a
corpus over the devices of a mesh (``parallel``) and merge the shards'
top-k lists."""

from mediquery_rag_tpu_torch.engine.flat import FlatIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.ivf import IVFIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.sharded import ShardedFlatIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.sharded_ivf import ShardedIVFIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.streaming import StreamingFlatIndex  # noqa: F401
