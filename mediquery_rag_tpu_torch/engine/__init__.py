"""The retrieval core on the card: the exact flat index (float, int8, int4
with a host rerank). The IVF, sharded and streaming indexes are ROADMAP
Queue A items."""

from mediquery_rag_tpu_torch.engine.flat import FlatIndex  # noqa: F401
