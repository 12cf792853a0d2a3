"""Models: the lexical embedders (copied, numpy only), the byte, BPE and
WordPiece tokenizers, the causal decoder LM with its generator and LoRA,
the post-LN BERT encoder and the HF checkpoint importer (ported). The
JAX package's trained encoders and cross-encoder are ROADMAP Queue A item
11."""

from mediquery_rag_tpu_torch.models.hash_embedder import HashingEmbedder  # noqa: F401
from mediquery_rag_tpu_torch.models.lexical import IDFHashingEmbedder  # noqa: F401
from mediquery_rag_tpu_torch.models.lexicon import (  # noqa: F401
    ZH_MEDICAL_SYNONYMS, expand_query,
)
from mediquery_rag_tpu_torch.models.byte_tokenizer import ByteTokenizer  # noqa: F401
from mediquery_rag_tpu_torch.models.bpe_tokenizer import BPETokenizer  # noqa: F401
from mediquery_rag_tpu_torch.models.decoder import Decoder, KVCache  # noqa: F401
from mediquery_rag_tpu_torch.models.generate import Generator  # noqa: F401
from mediquery_rag_tpu_torch.models.bert_encoder import BertEncoder  # noqa: F401
from mediquery_rag_tpu_torch.models.wordpiece_tokenizer import (  # noqa: F401
    WordPieceTokenizer,
)
from mediquery_rag_tpu_torch.models.hf_import import (  # noqa: F401
    BertTextEmbedder, load_bert, load_qwen2, load_qwen2_generator,
    read_safetensors,
)
from mediquery_rag_tpu_torch.models.lora import (  # noqa: F401
    LoraTrainer, load_adapters, lora_init, lora_merge, save_adapters,
)
