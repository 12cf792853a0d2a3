# Copy of mediquery_rag_tpu/models/lexical.py (the port imports nothing of the JAX package).
"""IDF-weighted char n-gram hashing embedder — the upgraded lexical channel.

Replaces the flat-bigram ``HashingEmbedder`` as the lexical half of the
shipping retrieval stack (reference capability: the lexical component of
``shaw/dmeta-embedding-zh`` retrieval, medical_engine.py:43). Three
measured upgrades over the flat hasher (held-out sweep in
benchmarks/retrieval_eval.py; r2 VERDICT item 1):

1. **Corpus-fitted IDF, softened and zero-floored.** Grams are weighted
   ``idf(g) ** alpha`` with BM25-style idf and ``alpha=0.35`` — full
   IDF *hurts* paraphrase retrieval here (the grams a colloquial query
   shares with its document are the common clinical terms, not the rare
   phrasing-specific ones), and grams absent from the corpus get weight
   0: they cannot match anything and only inject hash-collision noise
   into the query vector. Measured: flat bigrams r@1 .50 / r@10 .76 →
   this channel .71 / .93.
2. **Field-weighted documents.** A QA chunk is embedded as
   ``w_head * vec(title + tags) + (1-w_head) * vec(content)`` — queries
   paraphrase titles, and tags are curated discriminative terms.
3. **Query-side lexicon expansion** (models/lexicon.py): colloquial
   triggers append their clinical-register equivalents before hashing —
   the zero-egress substitute for pretrained synonymy.

Feature hashing (signed, murmur-style mix) keeps the embedder a fixed
``dim``-d dense vector so the whole TPU engine stack — Pallas scan
kernels, int8/int4 quantization, IVF, sharding — is unchanged; it just
sees unit-norm rows.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterable, Sequence

import numpy as np

from mediquery_rag_tpu_torch.models.hash_embedder import _mix, hash_str
from mediquery_rag_tpu_torch.models.lexicon import (
    ZH_MEDICAL_SYNONYMS, expand_doc, expand_query)

_HEAD_RE_TITLE = "问题："
_HEAD_RE_BODY = "\n答案："


def char_ngrams(text: str, orders: Sequence[int] = (1, 2)) -> list[str]:
    """Non-space character n-grams, all requested orders concatenated."""
    chars = [c for c in text if not c.isspace()]
    out: list[str] = []
    for n in orders:
        out += ["".join(chars[i:i + n]) for i in range(len(chars) - n + 1)]
    return out


class IDFHashingEmbedder:
    """Corpus-fitted lexical embedder. ``fit_chunks`` / ``fit`` then call
    like any embedder: ``embed(texts)`` for queries, ``embed_docs(chunks)``
    for field-weighted document vectors (the ingest pipeline prefers it
    via the ``embed_docs`` hook when present)."""

    def __init__(self, dim: int = 1536, orders: Sequence[int] = (1, 2),
                 idf_alpha: float = 0.35, head_weight: float = 0.4,
                 expand: bool = True, doc_expand: bool = True,
                 uni_weight: float = 0.5, uni_dim: int = 1536):
        if not 0.0 <= head_weight <= 1.0:
            raise ValueError(f"head_weight must be in [0,1], got {head_weight}")
        if not 0.0 <= uni_weight < 1.0:
            raise ValueError(f"uni_weight must be in [0,1), got {uni_weight}")
        self.base_dim = int(dim)
        self.orders = tuple(int(o) for o in orders)
        self.idf_alpha = float(idf_alpha)
        self.head_weight = float(head_weight)
        self.expand = bool(expand)
        # inverse (document-side) lexicon expansion — lexicon.expand_doc.
        # Only effective via fit_chunks/embed_docs (plain fit() has no
        # chunk structure; unfitted expansion grams weigh 0, so the
        # combination degrades to a no-op rather than noise).
        self.doc_expand = bool(doc_expand)
        # r5 unigram-fusion channel (VERDICT r4 item 5): a parallel
        # unigram-ONLY sub-embedder in its own hash subspace. A tier-2
        # periphrasis query often shares single CHARS with its document
        # (油脂→血脂, 镜子→肠镜) that the bigram-dominated base vector
        # dilutes; a separate unit-normalized unigram cosine restores
        # that signal at full weight. Output = concat(sqrt(1-w)*base,
        # sqrt(w)*uni) — one dense vector, cosine == the weighted sum of
        # the two channel cosines, so the whole TPU engine stack is
        # unchanged. Measured (benchmarks/retrieval_eval.py): tier-2
        # r@1 .70→.75, r@5 .90→.925 at tier-1 .886→.871 — mined entirely
        # from corpus statistics, no curation (six alternative corpus-
        # only mechanisms measured and rejected; see RESULTS.md).
        self.uni_weight = float(uni_weight)
        self.uni_dim = int(uni_dim)
        self._uni: IDFHashingEmbedder | None = None
        if self.uni_weight > 0 and self.uni_dim > 0 and self.orders != (1,):
            self._uni = IDFHashingEmbedder(
                dim=self.uni_dim, orders=(1,), idf_alpha=idf_alpha,
                head_weight=head_weight, expand=expand,
                doc_expand=doc_expand, uni_weight=0.0, uni_dim=0)
        self.dim = self.base_dim + (self.uni_dim if self._uni else 0)
        self._idf: dict[str, float] = {}
        self._native_keys: np.ndarray | None = None
        self._native_weights: np.ndarray | None = None

    # -- fitting ---------------------------------------------------------------

    def fit(self, corpus_texts: Iterable[str]) -> "IDFHashingEmbedder":
        """Document-frequency statistics over the corpus. Grams never seen
        here embed to weight 0 (they cannot match any document)."""
        texts = list(corpus_texts)
        if not texts:
            raise ValueError("cannot fit IDF on an empty corpus")
        df: dict[str, int] = {}
        for t in texts:
            for g in set(char_ngrams(t, self.orders)):
                df[g] = df.get(g, 0) + 1
        n = len(texts)
        a = self.idf_alpha
        self._idf = {
            g: math.log(1.0 + (n - d + 0.5) / (d + 0.5)) ** a
            for g, d in df.items()
        }
        self._build_native_table()
        if self._uni is not None:
            self._uni.fit(texts)
        return self

    def _build_native_table(self) -> None:
        """Sorted (fnv64 key, weight) arrays for the C++ fast path
        (native/lexical.cpp). Only the default (1,2) gram orders have a
        native kernel, and a 64-bit key collision between distinct grams
        (p ~ 1e-11 at 18K grams) disables it — the Python loop is always
        the semantic reference."""
        self._native_keys = None
        self._native_weights = None
        # (1,) is served by the same (1,2)-gram kernel: its bigram lookups
        # miss the unigram-only table and contribute exactly 0
        if self.orders not in ((1, 2), (1,)) or not self._idf:
            return
        from mediquery_rag_tpu_torch.native.lexical import fnv1a64
        keys = np.fromiter(
            (fnv1a64(g.encode("utf-8")) for g in self._idf),
            dtype=np.uint64, count=len(self._idf))
        if len(np.unique(keys)) != len(keys):
            return                                    # collision: Python path
        order = np.argsort(keys)
        self._native_keys = keys[order]
        self._native_weights = np.fromiter(
            self._idf.values(), dtype=np.float64,
            count=len(self._idf))[order]

    def _vecs(self, texts: Sequence[str]) -> np.ndarray:
        """Batch of raw (single-field) vectors — C++ fast path when
        available (bit-identical to the Python loop, tests/test_native.py),
        else the per-text Python loop."""
        if self._native_keys is not None:
            from mediquery_rag_tpu_torch.native.lexical import (
                lex_vec_batch, native_available)
            if native_available():
                return lex_vec_batch(list(texts), self._native_keys,
                                     self._native_weights, self.base_dim)
        return np.stack([self._vec(t) for t in texts]) if texts else \
            np.zeros((0, self.base_dim), np.float32)

    @classmethod
    def fit_chunks(cls, chunks, **kwargs) -> "IDFHashingEmbedder":
        """Fit on rendered chunk texts + tags (tags participate in doc
        vectors, so their grams need IDF mass too). With ``doc_expand``
        the per-chunk inverse-lexicon expansion is fitted as well — the
        appended colloquial triggers need IDF mass to carry weight."""
        self = cls(**kwargs)
        return self.fit([
            c.text + "\n" + "，".join(c.tags or [])
            + ("\n" + expand_doc(self._doc_head(c)) if self.doc_expand
               else "")
            for c in chunks])

    @property
    def fitted(self) -> bool:
        return bool(self._idf)

    # -- embedding ---------------------------------------------------------------

    def _vec(self, text: str) -> np.ndarray:
        v = np.zeros(self.base_dim, np.float32)
        cnt: dict[str, int] = {}
        for g in char_ngrams(text, self.orders):
            cnt[g] = cnt.get(g, 0) + 1
        for g, c in cnt.items():
            w = self._idf.get(g, 0.0)
            if w == 0.0:
                continue
            h = _mix(hash_str(g))
            sign = 1.0 if (h >> 16) & 1 else -1.0
            v[h % self.base_dim] += sign * math.log1p(c) * w
        # f64-accumulated norm, f32 divisor: the exact float recipe the
        # C++ fast path uses (native/lexical.cpp) — keeps the two paths
        # bit-identical so the embedder fingerprint never depends on
        # which one ran
        n = float(np.linalg.norm(v.astype(np.float64)))
        return v / np.float32(n) if n > 0 else v

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Query-style embedding (lexicon-expanded). Rendered chunk text
        (the ``问题：…\\n答案：…`` corpus contract, ingest/parser.py) is
        recognized and field-weighted so ``embed`` on doc renders stays
        consistent with ``embed_docs`` (minus tags, which the render
        doesn't carry)."""
        if not self.fitted:
            raise RuntimeError("IDFHashingEmbedder used before fit()")
        raw: list[str] = []
        plan: list[tuple[str, int]] = []
        for t in texts:
            if t.startswith(_HEAD_RE_TITLE) and _HEAD_RE_BODY in t:
                head, body = t.split(_HEAD_RE_BODY, 1)
                plan.append(("d", len(raw)))
                raw += [head[len(_HEAD_RE_TITLE):], body]
            else:
                plan.append(("q", len(raw)))
                raw.append(expand_query(t) if self.expand else t)
        vecs = self._vecs(raw)
        out = np.zeros((len(texts), self.base_dim), np.float32)
        for r, (kind, i) in enumerate(plan):
            out[r] = (vecs[i] if kind == "q"
                      else self._combine(vecs[i], vecs[i + 1]))
        return self._fuse(out, lambda: self._uni.embed(texts))

    def _combine(self, hv: np.ndarray, bv: np.ndarray) -> np.ndarray:
        w = self.head_weight
        v = w * hv + (1.0 - w) * bv
        n = float(np.linalg.norm(v.astype(np.float64)))
        return v / np.float32(n) if n > 0 else v

    def _fuse(self, base: np.ndarray, uni_fn) -> np.ndarray:
        """Concat the unit-norm base and unigram channels scaled by
        sqrt(1-w) / sqrt(w): the fused cosine is exactly the weighted sum
        of the per-channel cosines, in ONE dense vector."""
        if self._uni is None:
            return base
        w = self.uni_weight
        return np.concatenate(
            [base * np.float32(math.sqrt(1.0 - w)),
             uni_fn() * np.float32(math.sqrt(w))], axis=1)

    def _doc_vec(self, head: str, body: str) -> np.ndarray:
        base = self._combine(self._vec(head), self._vec(body))
        return self._fuse(
            base[None], lambda: self._uni._doc_vec(head, body)[None])[0]

    @staticmethod
    def _doc_head(c) -> str:
        tags = "，".join(c.tags) if c.tags else ""
        return c.title + ("，" + tags if tags else "")

    def embed_docs(self, chunks) -> np.ndarray:
        """Field-weighted document vectors: head = title + tags (+ the
        inverse-lexicon colloquial expansion when ``doc_expand``), body =
        content. Preferred by ``build_document_store``/``add_documents``
        over ``embed`` (tags aren't in the rendered text)."""
        if not self.fitted:
            raise RuntimeError("IDFHashingEmbedder used before fit()")
        raw: list[str] = []
        for c in chunks:
            head = self._doc_head(c)
            if self.doc_expand:
                ex = expand_doc(head)
                head = head + (" " + ex if ex else "")
            raw += [head, c.content]
        vecs = self._vecs(raw)
        out = np.zeros((len(chunks), self.base_dim), np.float32)
        for r in range(len(chunks)):
            out[r] = self._combine(vecs[2 * r], vecs[2 * r + 1])
        return self._fuse(out, lambda: self._uni.embed_docs(chunks))

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed(texts)

    # -- persistence ---------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({
                "dim": self.base_dim, "orders": list(self.orders),
                "idf_alpha": self.idf_alpha,
                "head_weight": self.head_weight, "expand": self.expand,
                "doc_expand": self.doc_expand,
                "uni_weight": self.uni_weight, "uni_dim": self.uni_dim,
                "idf": self._idf,
                "uni_idf": self._uni._idf if self._uni else None,
            }, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "IDFHashingEmbedder":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        self = cls(dim=d["dim"], orders=d["orders"],
                   idf_alpha=d["idf_alpha"], head_weight=d["head_weight"],
                   expand=d.get("expand", True),
                   doc_expand=d.get("doc_expand", True),
                   uni_weight=d.get("uni_weight", 0.0),
                   uni_dim=d.get("uni_dim", 0))
        self._idf = {g: float(w) for g, w in d["idf"].items()}
        self._build_native_table()
        if self._uni is not None and d.get("uni_idf"):
            self._uni._idf = {g: float(w) for g, w in d["uni_idf"].items()}
            self._uni._build_native_table()
        return self
