# Copy of mediquery_rag_tpu/config.py (the port imports nothing of the JAX package).
"""Typed, centralized configuration.

Replaces the reference's ``config/settings.py`` constants module
(reference: config/settings.py:10-95). The reference leaked magic numbers
(k=5 in nodes.py:93 vs unused RETRIEVAL_K=4 in settings.py:80 vs k=3 default
in medical_engine.py:64); here every knob lives in one frozen dataclass tree
and the retrieval k is resolved deliberately to a single value.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class EngineConfig:
    """Retrieval-engine knobs (the TPU-native replacement of Chroma/hnswlib)."""

    dim: int = 768                  # embedding dim (shaw/dmeta-embedding-zh is 768-d)
    top_k: int = 5                  # reference graph path uses k=5 (nodes.py:93)
    index_kind: str = "flat"        # flat | ivf — the app-level index type
                                    # (flat is exact and fastest under ~1M
                                    # rows; ivf wins at multi-M scale)
    dtype: str = "bfloat16"         # corpus storage: float32 | bfloat16 | int8
                                    # | int4 (flat/sharded-flat only, nibble-
                                    # packed; pair with rerank_factor)
    metric: str = "cosine"          # cosine | dot
    # Pallas kernel tiling
    query_tile: int = 128           # rows of the query block per kernel step
    corpus_tile: int = 0            # corpus rows scored per kernel step;
                                    # 0 = auto per dtype (r4 same-session
                                    # sweep, benchmarks/tile_sweep.py:
                                    # int8 6144 = 89.5% of the HBM floor,
                                    # int4 8192 = 83.6%, bf16/f32 2048 —
                                    # larger int8/int4 tiles VMEM-OOM)
    # IVF
    ivf_nlist: int = 1024           # number of coarse centroids
    ivf_nprobe: int = 32            # clusters probed per query
    ivf_kmeans_iters: int = 10
    ivf_sample: int = 262144        # max training sample for k-means
    ivf_balance: float = 0.05       # k-means size-penalty (0 = classic Lloyd)
    ivf_cap_factor: float = 2.0     # bucket cap <= factor * avg cluster size;
                                    # overflow rows spill to their next-best
                                    # cluster with space (0 = unbounded)
    ivf_split_oversized: bool = True  # balanced-split k-means refinement:
                                    # split clusters whose estimated size
                                    # exceeds the cap, recycling the
                                    # smallest centroids (ops/kmeans.py:
                                    # split_oversized) — dense regions get
                                    # capacity instead of spilling far away
    # two-stage refinement (int8 storage only): the HBM int8 scan fetches
    # rerank_factor*k candidates, a host-RAM float16 copy re-scores them
    # exactly — int8 scan speed and HBM footprint, near-f32 recall
    # (Faiss/HAVEN "refine" tier, TPU-adapted: host RAM is the warm tier)
    rerank_factor: int = 0          # 0 = off; typical 4
    # sharding
    mesh_axis: str = "shard"        # corpus-shard mesh axis name (ICI)
    dcn_axis: str = ""              # multi-slice: outer mesh axis spanning
                                    # slices (DCN links). "" = single-slice.
                                    # When set, corpus rows shard over the
                                    # (dcn, ici) product and the top-k merge
                                    # is hierarchical: wide all-gather on
                                    # ICI, k-finalist exchange on DCN
                                    # (parallel/collectives.py)

    def resolve_corpus_tile(self, n_rows: int) -> "EngineConfig":
        """Resolve ``corpus_tile == 0`` (auto) for a corpus of ``n_rows``.

        Index builders call this ONCE and keep the resolved config, so the
        build-time pad and every later search/add agree on the tile. The
        per-dtype best only pays off when the corpus actually spans it —
        small corpora keep the 2048 baseline instead of padding to one
        oversized tile (which also drags CPU-interpret tests)."""
        if self.corpus_tile != 0:
            return self
        best = {"int8": 6144, "int4": 8192}.get(self.dtype, 2048)
        tile = best if n_rows >= best else 2048
        return dataclasses.replace(self, corpus_tile=tile)


@dataclass(frozen=True)
class EmbedderConfig:
    """TPU embedding model (replaces OllamaEmbeddings dmeta-zh, medical_engine.py:43)."""

    vocab_size: int = 16384
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    dropout: float = 0.0
    dtype: str = "bfloat16"         # activation dtype
    pooling: str = "mean"           # mean | cls


@dataclass(frozen=True)
class BertEmbedderConfig:
    """Post-LN BERT encoder — the exact architecture of pretrained zh
    embedding checkpoints (shaw/dmeta-embedding-zh is a Chinese BERT
    derivative, reference medical_engine.py:43). The from-scratch
    ``EmbedderConfig``/``Embedder`` pair stays pre-LN (the better design to
    train); this one exists so HF weights import bit-faithfully
    (models/hf_import.py:load_bert)."""

    vocab_size: int = 21128         # bert-base-chinese WordPiece vocab
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    pooling: str = "mean"           # mean | cls
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class DecoderConfig:
    """TPU-hosted causal LM (replaces ChatOllama/qwen2.5:7b's GGML inference,
    reference medical_engine.py:46 — SURVEY §2b row 2's optional completion).

    Qwen/llama-class architecture: RMSNorm, RoPE, SwiGLU, causal MHA.
    Byte-level vocabulary (259 used ids padded to a lane-friendly 384).
    """

    vocab_size: int = 384           # 3 specials + 256 bytes, padded to 3*128
    hidden: int = 512
    layers: int = 8
    heads: int = 8
    kv_heads: int | None = None     # GQA: KV heads (None = heads, i.e. MHA);
                                    # qwen2.5-7b uses 28 q / 4 kv — the KV
                                    # cache shrinks by heads/kv_heads
    mlp_dim: int = 1536             # SwiGLU inner dim
    max_len: int = 1024             # max prompt+generation length (KV cache cap)
    rope_theta: float = 10000.0
    qkv_bias: bool = False          # qwen2/2.5 checkpoints carry q/k/v biases
    rms_eps: float = 1e-6           # rms_norm_eps in HF configs
    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "float32"    # weight storage: float32 for training
                                    # masters; bfloat16 halves serving HBM
                                    # traffic (decode is weight-bandwidth
                                    # bound — see Generator.to_serving_dtype)
    kv_dtype: str = ""              # KV-cache storage: "" = activation dtype;
                                    # "int8" = per-column-per-head absmax
                                    # quantization — halves cache HBM (2x the
                                    # lanes or context at a given budget) and
                                    # the attention read bytes at long context
    attn_impl: str = "einsum"       # prefill/apply attention: "einsum"
                                    # (XLA, materializes [B,H,S,S] logits) or
                                    # "flash" (Pallas online-softmax kernel,
                                    # ops/attention.py — never materializes
                                    # [S,S]; the long-context prefill choice)


@dataclass(frozen=True)
class LoraConfig:
    """Low-rank adaptation of the decoder (models/lora.py): rank-r deltas
    on the projection matrices, merged back into the base for serving."""

    rank: int = 8
    alpha: float = 16.0             # delta scale = alpha / rank
    targets: Tuple[str, ...] = (    # stacked [L, in, out] block weights
        "qkv", "attn_out", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class TrainConfig:
    """Contrastive trainer for the embedder."""

    batch_size: int = 256
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    decay_steps: int = 10_000       # cosine horizon; set to the RUN's
                                    # total steps — a short run under a
                                    # 10k horizon trains at ~peak lr the
                                    # whole time (the r4 1B-class
                                    # 'plateaued at random' failure)
    temperature: float = 0.05       # InfoNCE temperature
    mesh_shape: Tuple[int, int] = (1, 1)   # (data, model)
    remat: bool | str = True        # False | True (full per-block) |
                                    # "names" (save bf16-cast matmul
                                    # outputs only — backward recomputes
                                    # nothing but elementwise; the LM
                                    # training-MFU choice when the ~230
                                    # MB/layer of checkpoints fit) |
                                    # "dots" (f32 matmul outputs saved)
    optimizer: str = "adamw"        # adamw | adafactor (factored 2nd
                                    # moment, no 1st: ~params-free opt
                                    # state — 1B-class LM training fits
                                    # one 16 GB chip)


@dataclass(frozen=True)
class GraphConfig:
    """Self-RAG workflow caps (reference: settings.py:82, s_c.py:40)."""

    max_retrieval_loops: int = 3
    grade_docs: int = 2             # reference grades only the first 2 docs (core/utils.py:64)
    web_results: int = 3


@dataclass(frozen=True)
class MemoryConfig:
    """Two-tier memory thresholds (reference: settings.py:40-42)."""

    summarize_after_messages: int = 16
    keep_recent_messages: int = 6
    summary_truncate_chars: int = 500


@dataclass(frozen=True)
class ConsultationConfig:
    max_followup_rounds: int = 3    # reference: structured_consultation.py:40
    risk_fail_mode: str = "low"     # LLM-triage parse failure: "low" (reference
    #                                 fail-open, s_c.py:914-919) or "medium"
    #                                 (clinically safer). Explicit design decision
    #                                 flagged in SURVEY §5.


@dataclass(frozen=True)
class PathsConfig:
    data_dir: str = "data"
    corpus_file: str = "data/medical_data.txt"
    index_dir: str = "index_db"
    user_data_dir: str = "user_data"
    chat_db: str = "user_data/chat_history.sqlite"
    profile_db: str = "user_data/profiles.sqlite"
    review_dir: str = "user_data/reviews"


@dataclass(frozen=True)
class Config:
    engine: EngineConfig = field(default_factory=EngineConfig)
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    consultation: ConsultationConfig = field(default_factory=ConsultationConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()


def load(root: str | None = None) -> Config:
    """Return the default config, with paths rooted at ``root`` if given."""
    cfg = DEFAULT
    if root:
        p = cfg.paths
        cfg = cfg.replace(
            paths=PathsConfig(
                data_dir=os.path.join(root, p.data_dir),
                corpus_file=os.path.join(root, p.corpus_file),
                index_dir=os.path.join(root, p.index_dir),
                user_data_dir=os.path.join(root, p.user_data_dir),
                chat_db=os.path.join(root, p.chat_db),
                profile_db=os.path.join(root, p.profile_db),
                review_dir=os.path.join(root, p.review_dir),
            )
        )
    return cfg
