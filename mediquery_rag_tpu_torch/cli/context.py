"""Application wiring on PyTorch (port of ``mediquery_rag_tpu/cli/context.py``).

``AppContext.build`` picks the same components as the JAX package: the
embedder (an HF BERT checkpoint named by ``MEDIQUERY_HF_EMBEDDER``, served
from ``device``, else the corpus-fitted IDF lexical embedder), the flat or
IVF document store on ``device``, the LLM (an HF qwen2-class checkpoint
named by ``MEDIQUERY_HF_LLM``, quantized per ``MEDIQUERY_HF_LLM_QUANT``
with the KV cache per ``MEDIQUERY_HF_LLM_KV``, or a decoder checkpoint,
each served by ``TorchLLMClient``; else an HTTP or scripted client) and
the embedding-similarity grader, and the port's copies of the rest (graph,
memory). The store's index is whatever the saved ``index/`` holds, rebuilt
when its kind differs from the one requested, or what ``config.engine``
builds. ``MEDIQUERY_HYBRID=1`` with a trained encoder checkpoint
(``checkpoints/embedder``, from ``models.train``) fuses it with the IDF
lexical channel (``HybridEmbedder``, the encoder on ``device``); a grader
checkpoint (``checkpoints/grader``, from ``models.train_grader``) grades
documents with the cross-encoder on ``device``, and a stale one falls back
to the similarity grader without aborting startup.
``EngineConfig(dtype="int4")`` with ``--index ivf`` builds the int4 IVF
store.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

from mediquery_rag_tpu_torch.app.memory import (
    HITLManager, ProfileStore, UserProfileMarkdown,
    extract_health_info, load_health_profile,
)
from mediquery_rag_tpu_torch.config import Config, load as load_config
from mediquery_rag_tpu_torch.graph import build_medical_graph, create_nodes
from mediquery_rag_tpu_torch.graph.engine import SqliteCheckpointer
from mediquery_rag_tpu_torch.llm.client import FakeLLM, HTTPChatClient
from mediquery_rag_tpu_torch.ingest import DocumentStore, build_document_store

FAKE_ANSWER = ("（演示模式：未连接本地 LLM 服务，回答为占位内容。"
               "启动兼容 OpenAI 接口的本地服务后去掉 --fake-llm 即可。）")


@dataclass
class AppContext:
    cfg: Config
    llm: object
    embedder: Callable
    store: DocumentStore
    profile_store: ProfileStore
    hitl: HITLManager
    graph_app: object
    web_search: Callable | None = None
    grade_fn: Callable | None = None      # the graph's document grader (None: the LLM's)

    @staticmethod
    def lexical_embedder(root: str, cfg: Config):
        """The corpus-fitted IDF n-gram embedder, persisted under
        ``checkpoints/`` (the same file and format as the JAX package, so
        either package reloads it); the flat hasher only without a corpus."""
        from mediquery_rag_tpu_torch.models import HashingEmbedder, IDFHashingEmbedder
        state = os.path.join(root, "checkpoints", "lexical_idf.json")
        if os.path.exists(state):
            try:
                return IDFHashingEmbedder.load(state)
            except (ValueError, KeyError, OSError) as e:
                print(f"（词面 IDF 状态损坏，重新拟合：{e}）")
        if os.path.exists(cfg.paths.corpus_file):
            from mediquery_rag_tpu_torch.ingest.parser import parse_corpus_file
            emb = IDFHashingEmbedder.fit_chunks(
                parse_corpus_file(cfg.paths.corpus_file))
            try:
                emb.save(state)
            except OSError:
                pass
            return emb
        return HashingEmbedder(cfg.embedder.hidden)

    @staticmethod
    def load_or_build_store(cfg: Config, embedder, device,
                            index_kind: str = "flat") -> DocumentStore:
        """Load the saved index, or (re)build it from the corpus when it is
        missing, of another kind than ``index_kind``, built by another
        embedder, or stale against the corpus."""
        from mediquery_rag_tpu_torch.engine import IVFIndex
        from mediquery_rag_tpu_torch.ingest.parser import parse_corpus_file
        idx = cfg.paths.index_dir
        store = None
        if os.path.exists(os.path.join(idx, "chunks.jsonl")):
            try:
                store = DocumentStore.load(idx, embedder, device=device)
                loaded_kind = "ivf" if isinstance(store.index, IVFIndex) else "flat"
                if loaded_kind != index_kind:
                    print(f"（索引类型已切换：{loaded_kind} -> {index_kind}，重新构建）")
                    store = None
                if store is not None and os.path.exists(cfg.paths.corpus_file):
                    want = {c.chunk_id
                            for c in parse_corpus_file(cfg.paths.corpus_file)}
                    have = {c.chunk_id for c in store.chunks if c is not None}
                    if want != have:
                        print(f"（语料已更新：{len(have)} -> {len(want)} "
                              "条，重新构建索引）")
                        store = None
            except (ValueError, NotImplementedError) as e:
                print(f"（索引不可用，重新构建：{e}）")
                store = None
        if store is None:
            store = build_document_store(cfg.paths.corpus_file, embedder,
                                         cfg.engine, kind=index_kind, device=device)
            try:
                store.save(idx)
            except OSError:
                pass
        return store

    @classmethod
    def build(
        cls,
        root: str = ".",
        *,
        fake_llm: bool = False,
        llm_url: str = "http://localhost:11434",
        web_search: Callable | None = None,
        index_kind: str | None = None,
        device: str = "cuda",
    ) -> "AppContext":
        cfg = load_config(root)
        index_kind = (index_kind or os.environ.get("MEDIQUERY_INDEX", "")
                      or cfg.engine.index_kind)
        if index_kind not in ("flat", "ivf"):
            raise ValueError(f"unknown index_kind {index_kind!r}")
        # embedder: a pretrained HF zh encoder (dmeta-class BERT,
        # MEDIQUERY_HF_EMBEDDER=<dir>) > the hybrid fusion of the IDF lexical
        # channel and a trained encoder (MEDIQUERY_HYBRID=1 and a checkpoint;
        # JAX's gate also asks for a TPU, the port's runs on ``device``) >
        # the corpus-fitted IDF lexical embedder (the JAX package's
        # measured-best default)
        hf_emb = os.environ.get("MEDIQUERY_HF_EMBEDDER", "")
        ckpt = os.path.join(root, "checkpoints", "embedder")
        lexical = cls.lexical_embedder(root, cfg)
        if hf_emb and os.path.isdir(hf_emb):
            from mediquery_rag_tpu_torch.models.hf_import import BertTextEmbedder
            embedder = BertTextEmbedder.from_hf(hf_emb, device=device)
            print(f"  预训练 HF 嵌入模型已加载（{device} 本地推理）")
        elif (os.environ.get("MEDIQUERY_HYBRID", "") == "1"
              and os.path.exists(os.path.join(ckpt, "params.npz"))
              and os.path.exists(os.path.join(ckpt, "config.json"))):
            from mediquery_rag_tpu_torch.models import HybridEmbedder
            embedder = HybridEmbedder.from_checkpoint(
                ckpt, lex_dim=cfg.embedder.hidden, lexical=lexical, w_lex=0.9,
                device=device)
            print(f"  混合嵌入已启用（IDF 词面通道 + 训练编码器，{device} 推理）")
        else:
            embedder = lexical
        store = cls.load_or_build_store(cfg, embedder, device, index_kind)

        # LLM: scripted fake > HF qwen2-class checkpoint > decoder checkpoint,
        # each served from ``device`` > HTTP client to a local server
        hf_llm = os.environ.get("MEDIQUERY_HF_LLM", "")
        lm_ckpt = os.path.join(root, "checkpoints", "lm")
        if fake_llm:
            llm = FakeLLM(default=FAKE_ANSWER)
        elif hf_llm and os.path.isdir(hf_llm):
            from mediquery_rag_tpu_torch.llm import TorchLLMClient
            # MEDIQUERY_HF_LLM_QUANT: "8" (default) int8, "4" int4, "0" off;
            # MEDIQUERY_HF_LLM_KV=int8: quantized KV cache
            qflag = os.environ.get("MEDIQUERY_HF_LLM_QUANT", "8")
            llm = TorchLLMClient.from_hf(
                hf_llm, quantize=0 if qflag == "0" else (4 if qflag == "4" else 8),
                kv_dtype=os.environ.get("MEDIQUERY_HF_LLM_KV", ""), device=device)
            print(f"  预训练 HF 语言模型已加载（{device} 本地推理，无需外部服务）")
        elif os.path.exists(os.path.join(lm_ckpt, "params.npz")):
            try:
                from mediquery_rag_tpu_torch.llm import TorchLLMClient
                llm = TorchLLMClient.from_checkpoint(lm_ckpt, device=device)
                print("  本地语言模型已加载（GPU 推理，无需外部 LLM 服务）")
            except Exception as e:    # stale checkpoint: fall back, don't abort
                print(f"  ⚠️ GPU LLM 加载失败，回退 HTTP 客户端：{e}")
                llm = HTTPChatClient(llm_url)
        else:
            llm = HTTPChatClient(llm_url)

        if web_search is None:
            from mediquery_rag_tpu_torch.llm.web import TavilyClient
            tavily = TavilyClient(max_results=cfg.graph.web_results)
            web_search = tavily if tavily.available else None

        os.makedirs(cfg.paths.user_data_dir, exist_ok=True)
        profile_store = ProfileStore(
            cfg.paths.profile_db,
            markdown_sync=UserProfileMarkdown(
                os.path.join(cfg.paths.user_data_dir, "profiles_md")),
        )
        hitl = HITLManager(cfg.paths.review_dir, profile_store)

        # a trained cross-encoder grader replaces the per-loop LLM document
        # grading when its checkpoint exists (models/train_grader)
        grade_fn = None
        grader_dir = os.path.join(root, "checkpoints", "grader")
        if os.path.exists(os.path.join(grader_dir, "params.npz")):
            from mediquery_rag_tpu_torch.models.cross_encoder import TrainedGrader
            try:
                grade_fn = TrainedGrader.from_checkpoint(grader_dir, device=device)
                print("  交叉编码器文档评分器已加载（替代 LLM grade）")
            except Exception as e:     # stale/mismatched checkpoint must
                grade_fn = None        # fall back, never abort startup
                print(f"  ⚠️ 评分器加载失败，回退 LLM grade：{e}")
        from mediquery_rag_tpu_torch.models import (
            HashingEmbedder, HybridEmbedder, IDFHashingEmbedder)
        if grade_fn is None and not isinstance(embedder, HashingEmbedder):
            # bi-encoder similarity grade, at the JAX package's measured
            # per-embedder thresholds: IDF lexical 0.1, hybrid 0.2, semantic 0.3
            from mediquery_rag_tpu_torch.models.cross_encoder import SimilarityGrader
            thr = (0.1 if isinstance(embedder, IDFHashingEmbedder)
                   else 0.2 if isinstance(embedder, HybridEmbedder) else 0.3)
            grade_fn = SimilarityGrader(embedder, threshold=thr)
            print("  嵌入相似度评分器已启用（替代 LLM grade）")

        nodes = create_nodes(
            llm, store,
            web_search=web_search,
            extract_health=lambda q, uid: extract_health_info(
                q, uid, llm, profile_store, hitl=hitl),
            load_profile=lambda uid: load_health_profile(uid, profile_store),
            cfg=cfg.graph,
            top_k=cfg.engine.top_k,
            grade_fn=grade_fn,
        )
        graph_app = build_medical_graph(nodes, SqliteCheckpointer(cfg.paths.chat_db))
        return cls(cfg, llm, embedder, store, profile_store, hitl,
                   graph_app, web_search, grade_fn)
