"""DocumentStore: chunks + index + embedder (port of ``mediquery_rag_tpu/ingest/pipeline.py``).

Same ``similarity_search`` / ``batch_search`` contract the ``SearchServer``
and the Self-RAG graph call, the same live ``add_documents`` /
``delete_documents``, and the same on-disk layout (``chunks.jsonl``,
``store.json``, ``index/``). The flat index (float, int8, int4), the IVF
index (bf16, int8, int4), the host-streaming flat index and the sharded
flat index are ported (the streaming and sharded indexes are immutable, so
``add_documents``/``delete_documents`` fail on them as in JAX).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine.flat import FlatIndex
from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
from mediquery_rag_tpu_torch.engine.sharded import ShardedFlatIndex
from mediquery_rag_tpu_torch.engine.streaming import StreamingFlatIndex
from mediquery_rag_tpu_torch.ingest.parser import Chunk, parse_corpus_file
from mediquery_rag_tpu_torch.obs import tracing

_SENTINEL = "指纹校验：高血压与糖尿病"


def embedder_fingerprint(embedder: Callable) -> str:
    """Hash of the embedder's output on a fixed sentinel (the JAX package's
    fingerprint, so either package detects an index built by a different
    embedder)."""
    v = np.asarray(embedder([_SENTINEL])[0], dtype=np.float32)
    return hashlib.sha1(np.round(v, 4).tobytes()).hexdigest()[:16]


@dataclass
class RetrievedDoc:
    text: str
    metadata: dict
    score: float


class DocumentStore:
    def __init__(self, chunks: list[Chunk | None],
                 index: FlatIndex | IVFIndex | StreamingFlatIndex | ShardedFlatIndex,
                 embedder: Callable):
        # position in ``chunks`` == stable engine doc id; None = deleted
        self.chunks = chunks
        self.index = index
        self.embedder = embedder
        self._live = sum(c is not None for c in chunks)

    @property
    def live_count(self) -> int:
        return self._live

    def similarity_search(self, query: str, k: int = 5,
                          where: dict | None = None) -> list[RetrievedDoc]:
        return self.batch_search([query], k, where=where)[0]

    @staticmethod
    def _matches(meta: dict, where: dict) -> bool:
        """Chroma-style metadata filter: every key must match; a list or a
        delimited string matches if it contains the wanted value."""
        for key, want in where.items():
            have = meta.get(key)
            if isinstance(have, (list, tuple)):
                if want not in have:
                    return False
            elif isinstance(have, str) and isinstance(want, str):
                if want != have and want not in re.split(r"[，,、;；]\s*", have):
                    return False
            elif have != want:
                return False
        return True

    def _rows(self, scores: np.ndarray, idx: np.ndarray, r: int, k: int,
              allowed=None) -> list[RetrievedDoc]:
        row = []
        for j in range(idx.shape[1]):
            i = int(idx[r, j])
            if i < 0 or scores[r, j] == -np.inf:
                continue
            c = self.chunks[i]
            if c is None or (allowed is not None and not allowed(i, c)):
                continue
            row.append(RetrievedDoc(c.text, c.metadata, float(scores[r, j])))
            if len(row) == k:
                break
        return row

    def batch_search(self, queries: Sequence[str], k: int = 5,
                     where: dict | None = None) -> list[list[RetrievedDoc]]:
        """Batched retrieval. ``where`` filters by metadata: overfetch 4x k,
        then widen to the deepest fetch the kernel takes (k <= 128) for
        rows the overfetch left short. The index search (through its host
        copy) and the building of the results are the ``store.scan`` and
        ``store.assemble`` spans."""
        k = min(k, self.live_count)
        q = np.asarray(self.embedder(list(queries)))
        fetch = k if where is None else min(4 * k, self.live_count, 128)
        with tracing.span("store.scan", n=len(queries)):
            scores, idx = (t.cpu().numpy() for t in self.index.search(q, k=fetch))
        match = None if where is None else (
            lambda i, c: self._matches(c.metadata, where))
        with tracing.span("store.assemble", n=len(queries)):
            out = [self._rows(scores, idx, r, k, match) for r in range(len(queries))]
        widen = [r for r, row in enumerate(out)
                 if where is not None and len(row) < k and fetch < self.live_count]
        if widen:
            with tracing.span("store.scan", n=len(widen)):
                full_s, full_i = (t.cpu().numpy() for t in self.index.search(
                    q[widen], k=min(128, self.live_count)))
            with tracing.span("store.assemble", n=len(widen)):
                for rr, r in enumerate(widen):
                    out[r] = self._rows(full_s, full_i, rr, k, match)
        return out

    # -- live mutation (port of the JAX package's add/delete) -----------------

    def add_documents(self, new_chunks: list[Chunk], batch_size: int = 64
                      ) -> list[int]:
        """Embed and insert chunks; returns their stable doc ids."""
        if not new_chunks:
            return []
        vecs = _embed_chunks(self.embedder, new_chunks, batch_size)
        start = self.index.next_id
        if start != len(self.chunks):
            raise RuntimeError("doc-id/chunk alignment broken")
        new_index = self.index.add(vecs)
        # publication order matters for concurrent readers: grow ``chunks``
        # BEFORE swapping the index, so a reader that sees the new index
        # never looks up a doc id past len(chunks)
        self.chunks.extend(new_chunks)
        self.index = new_index
        self._live += len(new_chunks)
        return list(range(start, start + len(new_chunks)))

    def delete_documents(self, chunk_ids: Sequence[str]) -> int:
        """Delete by chunk_id (the corpus-format key); returns #deleted."""
        want = set(chunk_ids)
        doc_ids = [i for i, c in enumerate(self.chunks)
                   if c is not None and c.chunk_id in want]
        if not doc_ids:
            return 0
        self.index = self.index.delete(np.asarray(doc_ids, np.int32))
        for i in doc_ids:
            self.chunks[i] = None
        self._live -= len(doc_ids)
        return len(doc_ids)

    # -- persistence (the JAX package's layout) -------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "chunks.jsonl"), "w", encoding="utf-8") as f:
            for doc_id, c in enumerate(self.chunks):
                if c is None:
                    continue
                f.write(json.dumps({
                    "doc_id": doc_id,
                    "chunk_id": c.chunk_id, "title": c.title,
                    "content": c.content, "source": c.source, "tags": c.tags,
                }, ensure_ascii=False) + "\n")
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump({"embedder_fingerprint": embedder_fingerprint(self.embedder)}, f)
        self.index.save(os.path.join(path, "index"))

    @classmethod
    def load(cls, path: str, embedder: Callable,
             device: str | torch.device = "cuda") -> "DocumentStore":
        rows = []
        with open(os.path.join(path, "chunks.jsonl"), encoding="utf-8") as f:
            for line in f:
                d = json.loads(line)
                rows.append((d.pop("doc_id", len(rows)), Chunk(**d)))
        chunks: list[Chunk | None] = [None] * (max(i for i, _ in rows) + 1)
        for i, c in rows:
            chunks[i] = c
        meta_path = os.path.join(path, "store.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                want = json.load(f).get("embedder_fingerprint")
            got = embedder_fingerprint(embedder)
            if want and got != want:
                raise ValueError(
                    f"index at {path} was built with a different embedder "
                    f"(fingerprint {want} != {got}); rebuild the index or "
                    "pass the matching embedder")
        ix_path = os.path.join(path, "index")
        with open(os.path.join(ix_path, "meta.json")) as f:
            kind = json.load(f)["kind"]
        if kind not in ("flat", "ivf"):
            raise NotImplementedError(
                f"index kind {kind!r}: only the flat and IVF indexes are ported")
        index = (IVFIndex if kind == "ivf" else FlatIndex).load(ix_path, device=device)
        # trailing deletes can leave next_id past the last live chunk;
        # re-pad so position == doc id stays true for future adds
        chunks.extend([None] * (index.next_id - len(chunks)))
        return cls(chunks, index, embedder)


def _embed_chunks(embedder: Callable, chunks: Sequence[Chunk],
                  batch_size: int) -> np.ndarray:
    """Batched document embedding; embedders with ``embed_docs`` (the
    field-weighted lexical channel) get the structured chunks."""
    fn = getattr(embedder, "embed_docs", None)
    embs = []
    for i in range(0, len(chunks), batch_size):
        part = chunks[i:i + batch_size]
        embs.append(np.asarray(fn(part) if fn is not None
                               else embedder([c.text for c in part])))
    return np.concatenate(embs, axis=0)


def build_document_store(
    source: str | list[Chunk],
    embedder: Callable,
    cfg: EngineConfig | None = None,
    *,
    kind: str = "flat",
    batch_size: int = 64,
    device: str | torch.device = "cuda",
    mesh=None,
) -> DocumentStore:
    """Parse (if a path), embed in batches, build the flat, IVF or
    host-streaming index on ``device`` (streaming: searchable, but
    immutable, as in JAX), or with ``kind="sharded"`` a ``ShardedFlatIndex``
    over ``mesh`` (default: ``parallel.corpus_mesh()`` over the visible
    cards; searchable, but without add, delete or save, as in JAX)."""
    if kind not in ("flat", "ivf", "streaming", "sharded"):
        raise NotImplementedError(f"kind={kind!r}: one of flat, ivf, streaming, sharded")
    chunks = parse_corpus_file(source) if isinstance(source, str) else source
    if not chunks:
        raise ValueError("empty corpus")
    vecs = _embed_chunks(embedder, chunks, batch_size)
    if cfg is None:
        cfg = EngineConfig(dim=vecs.shape[1])
    if cfg.dim != vecs.shape[1]:
        cfg = EngineConfig(**{**cfg.__dict__, "dim": vecs.shape[1]})
    if kind == "sharded":
        if mesh is None:
            from mediquery_rag_tpu_torch.parallel import corpus_mesh
            mesh = corpus_mesh()
        return DocumentStore(chunks, ShardedFlatIndex.build(vecs, mesh, cfg), embedder)
    index_cls = {"flat": FlatIndex, "ivf": IVFIndex, "streaming": StreamingFlatIndex}[kind]
    return DocumentStore(chunks, index_cls.build(vecs, cfg, device=device), embedder)
