"""Models: the lexical embedders (copied, numpy only), the byte tokenizer
(copied) and the causal decoder LM with its generator (ported)."""

from mediquery_rag_tpu_torch.models.hash_embedder import HashingEmbedder  # noqa: F401
from mediquery_rag_tpu_torch.models.lexical import IDFHashingEmbedder  # noqa: F401
from mediquery_rag_tpu_torch.models.byte_tokenizer import ByteTokenizer  # noqa: F401
from mediquery_rag_tpu_torch.models.decoder import Decoder, KVCache  # noqa: F401
from mediquery_rag_tpu_torch.models.generate import Generator  # noqa: F401
