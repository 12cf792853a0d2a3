"""The retrieval core on the card: the exact flat index. The IVF, sharded
and streaming indexes are ROADMAP Queue B items."""

from mediquery_rag_tpu_torch.engine.flat import FlatIndex  # noqa: F401
