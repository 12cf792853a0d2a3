"""The retrieval core on the card: the exact flat index (float, int8, int4
with a host rerank) and the IVF index (bf16, int8 with a host rerank). The
sharded and streaming indexes are ROADMAP Queue A items."""

from mediquery_rag_tpu_torch.engine.flat import FlatIndex  # noqa: F401
from mediquery_rag_tpu_torch.engine.ivf import IVFIndex  # noqa: F401
