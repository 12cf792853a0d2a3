# Copy of mediquery_rag_tpu/models/data.py (numpy); batches are torch tensors.
"""Training-pair pipeline for the embedder.

The reference consumed a pre-trained embedding model; a complete framework
must make its retriever trainable on its own corpus. The natural supervision
already in the QA corpus format: ``title`` (the question) is the query,
``content`` (the answer) is the positive document — in-batch negatives do
the rest (models/trainer.py). Batches are CPU tensors; the trainer
moves them to its device. Includes light augmentation (random span
crops) so small corpora still give variation per epoch.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from mediquery_rag_tpu_torch.ingest.parser import Chunk
from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
from mediquery_rag_tpu_torch.models.trainer import Batch


def pairs_from_chunks(chunks: Sequence[Chunk]) -> list[tuple[str, str]]:
    """(query, positive-doc) pairs: QA title -> content."""
    out = []
    for c in chunks:
        if c.title and c.content:
            out.append((c.title, c.content))
    return out


def _rev_lexicon() -> dict[str, list[str]]:
    """canonical term -> colloquial triggers, inverted from the
    query-expansion lexicon (models/lexicon.py)."""
    from mediquery_rag_tpu_torch.models.lexicon import ZH_MEDICAL_SYNONYMS
    rev: dict[str, list[str]] = {}
    for trigger, canon in ZH_MEDICAL_SYNONYMS.items():
        for term in canon.split():
            if len(term) >= 2:   # single chars (铁, 汤…) swap absurdly
                rev.setdefault(term, []).append(trigger)
    return rev


def colloquialize(text: str, rng: np.random.Generator,
                  rev: dict[str, list[str]] | None = None,
                  p: float = 0.5) -> str:
    """Swap canonical clinical terms for colloquial equivalents (reverse
    lexicon) — synthesizes patient-register paraphrases from clinical
    titles, the query distribution the encoder must serve but the corpus
    never contains. Each matched term flips with probability ``p``."""
    if rev is None:
        rev = _rev_lexicon()
    # single pass over the ORIGINAL text: collect non-overlapping match
    # spans (longest terms first so 高血压 wins over 血压), then splice —
    # replacement output is never re-matched (no 力量训练->举铁->铁->贫血
    # cascades)
    spans: list[tuple[int, int, str]] = []
    taken: list[tuple[int, int]] = []
    for term in sorted(rev, key=len, reverse=True):
        start = text.find(term)
        while start != -1:
            end = start + len(term)
            if (not any(s < end and start < e for s, e in taken)
                    and rng.random() < p):
                sub = rev[term][int(rng.integers(0, len(rev[term])))]
                spans.append((start, end, sub))
                taken.append((start, end))
            start = text.find(term, end)
    for start, end, sub in sorted(spans, reverse=True):
        text = text[:start] + sub + text[end:]
    return text


def ssl_examples_from_chunks(
    chunks: Sequence[Chunk], seed: int = 0, per_chunk: int = 4,
) -> list[tuple[str, str, int]]:
    """Corpus-scale self-supervised (query, doc, chunk_row) examples:

    - title -> content (the QA supervision already in the format);
    - colloquialized title -> content (reverse-lexicon paraphrase views);
    - tags -> content (topic words as queries);
    - content span -> full rendered chunk (inverse-cloze: any sentence of
      the answer should retrieve its chunk).

    The chunk row index rides along so hard-negative mining and eval can
    exclude the gold document.
    """
    rng = np.random.default_rng(seed)
    rev = _rev_lexicon()
    out: list[tuple[str, str, int]] = []
    for row, c in enumerate(chunks):
        if not (c.title and c.content):
            continue
        out.append((c.title, c.content, row))
        for _ in range(max(0, per_chunk - 3)):
            q = colloquialize(c.title, rng, rev)
            if q != c.title:
                out.append((q, c.content, row))
        if c.tags:
            out.append(("，".join(c.tags), c.content, row))
        out.append((_crop(c.content, rng, min_len=12), c.text, row))
    return out


def mine_hard_negatives(
    examples: Sequence[tuple[str, str, int]],
    chunks: Sequence[Chunk],
    lexical_embed, *, k: int = 8, seed: int = 0,
) -> list[str]:
    """Per-example hard-negative documents mined from the *lexical*
    channel's top-k (VERDICT r2 item 1): the highest-scoring non-gold
    neighbors are exactly the lexically-confusable documents the semantic
    encoder must learn to separate."""
    rng = np.random.default_rng(seed)
    docs = getattr(lexical_embed, "embed_docs", None)
    d = np.asarray(docs(chunks) if docs is not None
                   else lexical_embed([c.text for c in chunks]))
    q = np.asarray(lexical_embed([q for q, _, _ in examples]))
    scores = q @ d.T
    order = np.argsort(-scores, axis=1)[:, :k]
    out = []
    for i, (_, _, gold) in enumerate(examples):
        cand = [int(j) for j in order[i] if int(j) != gold]
        j = cand[0] if cand else int(rng.integers(0, len(chunks)))
        out.append(chunks[j].content)
    return out


def _crop(text: str, rng: np.random.Generator, min_len: int = 16) -> str:
    if len(text) <= min_len:
        return text
    span = rng.integers(min_len, len(text) + 1)
    start = rng.integers(0, len(text) - span + 1)
    return text[start : start + span]


class TripletLoader:
    """Shuffled batches of (query, doc, hard-negative) triplets — the
    corpus-scale self-supervised recipe (ssl_examples_from_chunks +
    mine_hard_negatives). Text-space augmentation (span crops) happens
    per epoch; dropout-view augmentation happens in the trainer."""

    def __init__(self, examples: Sequence[tuple[str, str, int]],
                 negatives: Sequence[str],
                 tokenizer: HashCharTokenizer,
                 batch_size: int, seed: int = 0, augment: bool = True,
                 max_len: int = 128):
        if not examples:
            raise ValueError("no training examples")
        if len(examples) != len(negatives):
            raise ValueError("examples and negatives must align")
        self.examples = list(examples)
        self.negatives = list(negatives)
        self.tok = tokenizer
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.augment = augment
        self.max_len = max_len

    def batches(self, epochs: int = 1) -> Iterator[Batch]:
        for _ in range(epochs):
            order = self.rng.permutation(len(self.examples))
            for i in range(0, len(order) - self.bs + 1, self.bs):
                idx = order[i:i + self.bs]
                qs, ds, ns = [], [], []
                for j in idx:
                    q, d, _ = self.examples[j]
                    n = self.negatives[j]
                    if self.augment:
                        d = _crop(d, self.rng)
                        n = _crop(n, self.rng)
                    qs.append(q)
                    ds.append(d)
                    ns.append(n)
                q_ids, q_mask = self.tok.batch_encode(qs, self.max_len)
                d_ids, d_mask = self.tok.batch_encode(ds, self.max_len)
                n_ids, n_mask = self.tok.batch_encode(ns, self.max_len)
                yield Batch(*map(torch.from_numpy, (q_ids, q_mask, d_ids, d_mask,
                                                    n_ids, n_mask)))


class PairLoader:
    """Shuffled, augmented, tokenized batches of contrastive pairs."""

    def __init__(self, pairs: list[tuple[str, str]],
                 tokenizer: HashCharTokenizer,
                 batch_size: int, seed: int = 0, augment: bool = True,
                 max_len: int = 128):
        if not pairs:
            raise ValueError("no training pairs")
        self.pairs = pairs
        self.tok = tokenizer
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.augment = augment
        self.max_len = max_len

    def batches(self, epochs: int = 1) -> Iterator[Batch]:
        for _ in range(epochs):
            order = self.rng.permutation(len(self.pairs))
            for i in range(0, len(order) - self.bs + 1, self.bs):
                idx = order[i : i + self.bs]
                qs, ds = [], []
                for j in idx:
                    q, d = self.pairs[j]
                    if self.augment:
                        d = _crop(d, self.rng)
                    qs.append(q)
                    ds.append(d)
                q_ids, q_mask = self.tok.batch_encode(qs, self.max_len)
                d_ids, d_mask = self.tok.batch_encode(ds, self.max_len)
                yield Batch(*map(torch.from_numpy, (q_ids, q_mask, d_ids, d_mask)))
