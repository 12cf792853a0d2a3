"""Cross-encoder relevance scorer and the document graders (port of
``mediquery_rag_tpu/models/cross_encoder.py``).

The reference grades retrieved documents with an LLM round trip per loop
step ("yes"/"no" on the first two docs, reference core/utils.py:64-72). The
alternative is a small cross-encoder: query and document jointly encoded in
ONE sequence (segment embeddings mark which is which) and scored by a head
on the pooled state, trainable on the corpus's (title, content) pairs
(positives = true pairs, negatives = rolled mismatches).

``CrossEncoder`` reuses the embedder's blocks (``models/embedder.py``) and
adds segment embeddings and a scalar score head. ``make_grader`` and
``TrainedGrader`` adapt it to the graph's ``grade_fn`` plug point;
``TrainedGrader`` checkpoints keep the JAX package's format, so either
package loads the other's. ``SimilarityGrader`` is the numpy bi-encoder
threshold grader the CLI uses by default.

STATUS: experimental below real data scale. At the shipping 160-chunk
corpus the trained grader memorizes, so the CLI grades with
``SimilarityGrader`` unless a grader checkpoint exists.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EmbedderConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.embedder import (
    Embedder, init_params, load_params, save_params, skeleton, trainable, tree_to)
from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer


def init_cross_params(cfg: EmbedderConfig, *, generator: torch.Generator | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """The embedder's tree plus ``seg_embed`` [2, D] (N(0, 0.02^2)),
    ``score_w`` [D] (N(0, 1/D)) and ``score_b`` [] (0), drawn from
    ``generator`` (seed 0 when None)."""
    device = torch.device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator=gen, device=device)
    D = cfg.hidden
    params["seg_embed"] = torch.randn((2, D), generator=gen, device=device) * 0.02
    params["score_w"] = torch.randn((D,), generator=gen, device=device) * D ** -0.5
    params["score_b"] = torch.zeros((), device=device)
    return params


class CrossEncoder(Embedder):
    """(query, doc) scorer over a JAX-layout tree: ``forward(ids, mask, seg)
    -> [B]`` f32 relevance logits (seg: 0 = query chars, 1 = doc chars)."""

    def __init__(self, cfg: EmbedderConfig, params: dict):
        super().__init__(cfg, params)
        for name in ("seg_embed", "score_w", "score_b"):
            self.register_buffer(name, params[name])

    def forward(self, ids, mask, seg, *, remat: bool = False) -> torch.Tensor:
        x, mask = self.hidden(ids, mask, seg=seg, seg_embed=self.seg_embed, remat=remat)
        return self.pool(x, mask) @ self.score_w + self.score_b


def encode_pairs(tok: HashCharTokenizer, queries: list[str],
                 docs: list[str], max_len: int | None = None):
    """[CLS] query-chars doc-chars as one sequence + segment ids.

    No explicit SEP token is needed: segment embeddings carry the boundary
    (and the hash vocabulary has no reserved id to spare).
    Returns (ids [B, L] i32, mask [B, L] f32, seg [B, L] i32).
    """
    max_len = tok.max_len if max_len is None else max_len
    rows, segs = [], []
    for q, d in zip(queries, docs):
        q_ids = tok.encode(q)[: max_len // 2]
        d_ids = tok.encode(d)[1:]                  # drop the doc's CLS
        ids = (q_ids + d_ids)[:max_len]
        seg = ([0] * len(q_ids) + [1] * len(d_ids))[:max_len]
        rows.append(ids)
        segs.append(seg)
    longest = max((len(r) for r in rows), default=1)
    L = min(-(-longest // 128) * 128, max_len)
    ids = np.zeros((len(rows), L), np.int32)
    mask = np.zeros((len(rows), L), np.float32)
    seg = np.zeros((len(rows), L), np.int32)
    for i, (r, s) in enumerate(zip(rows, segs)):
        r, s = r[:L], s[:L]
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1.0
        seg[i, : len(s)] = s
    return ids, mask, seg


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean stable BCE-with-logits, JAX's formula."""
    losses = (torch.clamp(logits, min=0) - logits * labels
              + torch.log1p(torch.exp(-logits.abs())))
    return losses.mean()


class CrossEncoderTrainer:
    """Binary relevance fine-tuning on (query, doc, label) triples: optax's
    ``adamw(lr)`` (weight decay 1e-4) on the stable BCE-with-logits. The
    step updates the params IN PLACE (the JAX step donates them)."""

    def __init__(self, cfg: EmbedderConfig, lr: float = 1e-4, *,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.opt = optim.adamw(lr)
        self._model: tuple[dict, CrossEncoder] | None = None

    def init(self, generator: torch.Generator | None = None, params: dict | None = None):
        """(params, opt_state): drawn from ``generator``, or the given tree
        (e.g. JAX's), as leaves on the trainer's device that require grad."""
        if params is None:
            params = init_cross_params(self.cfg, generator=generator, device=self.device)
        params = trainable(params, self.device)
        return params, self.opt.init(optim.tree_leaves(params))

    def model(self, params: dict) -> CrossEncoder:
        if self._model is None or self._model[0] is not params:
            self._model = (params, CrossEncoder(self.cfg, params))
        return self._model[1]

    def step(self, params: dict, opt_state, ids, mask, seg, labels):
        """One update. Returns (params, opt_state, loss)."""
        leaves = optim.tree_leaves(params)
        logits = self.model(params)(ids, mask, seg)
        labels = torch.as_tensor(np.asarray(labels, np.float32)).to(self.device)
        loss = bce_with_logits(logits, labels)
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = self.opt.update(list(grads), opt_state, leaves)
        optim.apply_updates(leaves, updates)
        return params, opt_state, loss.detach()


def train_cross_encoder(pairs: list[tuple[str, str]], cfg: EmbedderConfig, *,
                        epochs: int = 10, batch_size: int = 8, lr: float = 1e-4,
                        seed: int = 0, device: str | torch.device = "cuda",
                        params: dict | None = None):
    """Train on true pairs vs rolled-mismatch negatives, with JAX's numpy
    permutation. Initial params come from ``params`` or a ``torch.Generator``
    seeded with ``seed``. Returns (params, tokenizer, final_loss)."""
    rng = np.random.default_rng(seed)
    tok = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
    tr = CrossEncoderTrainer(cfg, lr=lr, device=device)
    gen = torch.Generator(device=tr.device).manual_seed(seed)
    params, opt_state = tr.init(gen, params)
    loss = float("nan")
    n = len(pairs)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            sel = order[i:i + batch_size]
            qs = [pairs[j][0] for j in sel]
            ds = [pairs[j][1] for j in sel]
            # negatives: each query against a rolled (mismatched) doc
            neg_ds = [ds[(j + 1) % len(ds)] for j in range(len(ds))]
            if len(sel) < 2:
                continue
            ids, mask, seg = encode_pairs(tok, qs + qs, ds + neg_ds)
            labels = np.r_[np.ones(len(qs)), np.zeros(len(qs))]
            params, opt_state, l = tr.step(params, opt_state, ids, mask, seg, labels)
            loss = float(l)
    return params, tok, loss


@torch.no_grad()
def score_pairs(params: dict, cfg: EmbedderConfig, queries, docs,
                batch: int = 32) -> np.ndarray:
    """Raw relevance logits for (query, doc) pairs -> [n] f32, on the
    params' device (the threshold-free form of the grader)."""
    tok = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
    ce = CrossEncoder(cfg, params)
    out = []
    for i in range(0, len(queries), batch):
        ids, mask, seg = encode_pairs(
            tok, list(queries[i:i + batch]), list(docs[i:i + batch]))
        out.append(ce(ids, mask, seg).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


def make_grader(params: dict, tok: HashCharTokenizer, cfg: EmbedderConfig,
                *, threshold: float = 0.0):
    """Adapt a trained cross-encoder to the graph's ``grade_fn`` plug point
    (``grade_fn(question, doc_texts) -> bool``): relevant iff any graded
    doc's logit clears the threshold. Runs on the params' device."""
    ce = CrossEncoder(cfg, params)

    @torch.no_grad()
    def grade(question: str, doc_texts: list[str]) -> bool:
        if not doc_texts:
            return False
        ids, mask, seg = encode_pairs(
            tok, [question] * len(doc_texts), list(doc_texts))
        return bool(ce(ids, mask, seg).max().item() >= threshold)

    return grade


class TrainedGrader:
    """Persistable document grader: cross-encoder params + config +
    threshold, loadable by the CLI (``AppContext`` wires it into the graph
    when ``checkpoints/grader`` exists)."""

    def __init__(self, params: dict, cfg: EmbedderConfig, threshold: float = 0.0, *,
                 device: str | torch.device = "cuda"):
        self.params = tree_to(params, device)
        self.cfg = cfg
        self.threshold = threshold
        tok = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
        self._grade = make_grader(self.params, tok, cfg, threshold=threshold)

    def __call__(self, question: str, doc_texts: list[str]) -> bool:
        return self._grade(question, doc_texts)

    def save(self, path: str) -> None:
        save_params(self.params, path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"cfg": asdict(self.cfg), "threshold": self.threshold}, f)

    @classmethod
    def from_checkpoint(cls, path: str, *,
                        device: str | torch.device = "cuda") -> "TrainedGrader":
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        cfg = EmbedderConfig(**meta["cfg"])
        try:
            params = load_params(path, skeleton(cross=True), device)
        except ValueError as e:
            raise ValueError(f"grader checkpoint at {path} does not match "
                             "this architecture") from e
        return cls(params, cfg, threshold=meta.get("threshold", 0.0), device=device)


class SimilarityGrader:
    """Bi-encoder threshold grader: the graph's ``grade_fn(question,
    doc_texts) -> bool`` plug point, true when any document's embedding
    cosine with the question reaches ``threshold``."""

    def __init__(self, embedder, threshold: float = 0.3):
        self.embedder = embedder          # texts -> [n, d] unit rows
        self.threshold = threshold

    def __call__(self, question: str, doc_texts: list[str]) -> bool:
        if not doc_texts:
            return False
        embs = np.asarray(self.embedder([question] + list(doc_texts)))
        return bool((embs[1:] @ embs[0]).max() >= self.threshold)
