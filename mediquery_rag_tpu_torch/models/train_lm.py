"""Causal-LM trainer + ``python -m mediquery_rag_tpu_torch.models.train_lm``
(port of ``mediquery_rag_tpu/models/train_lm.py``).

Next-token cross-entropy over chat-templated corpus text with the JAX
package's recipe: ``Decoder.apply`` (flash attention: B6 forward, B10a and
B10b backward) with per-block recompute, global-norm clipping at 1.0, then
AdamW (or Adafactor with decay scaled by the schedule) under a warmup +
cosine schedule (``models/optim.py``, equal to optax's). One card: the JAX
trainer's data/model mesh is ROADMAP Queue A item 13 of the port.
"""

from __future__ import annotations

import argparse
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mediquery_rag_tpu_torch.config import DecoderConfig, TrainConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.byte_tokenizer import PAD_ID, ByteTokenizer
from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params

MULTI_GPU = "multi-GPU training is not ported (ROADMAP Queue A item 13)"


class LMBatch(NamedTuple):
    ids: torch.Tensor      # [B, S] int, right-padded, BOS...EOS
    mask: torch.Tensor     # [B, S] f32


class LMTrainState(NamedTuple):
    params: dict           # leaf tensors that require grad, updated in place
    opt_state: list
    step: int


def lm_loss(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32. Only positions where both the input token
    and the target token are real contribute."""
    ids, mask = ids.to(logits.device).long(), mask.to(logits.device).float()
    B, S, V = logits.shape
    ce = F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                         ids[:, 1:].reshape(-1), reduction="none").reshape(B, S - 1)
    lmask = mask[:, :-1] * mask[:, 1:]
    return (ce * lmask).sum() / torch.clamp(lmask.sum(), min=1.0)


class LMLoader:
    """Right-padded LM batches from raw texts (BOS + bytes + EOS), padded to
    128-column multiples; the same seeded shuffle as the JAX loader."""

    def __init__(self, texts: Sequence[str], tokenizer: ByteTokenizer,
                 batch_size: int, seed: int = 0):
        if not texts:
            raise ValueError("no training texts")
        self.tok = tokenizer
        self.texts = list(texts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        longest = max(len(tokenizer.encode(t, eos=True)) for t in self.texts)
        self.seq_len = min(-(-longest // 128) * 128, tokenizer.max_len)

    def _encode(self, batch_texts) -> LMBatch:
        ids = np.full((len(batch_texts), self.seq_len), PAD_ID, np.int64)
        mask = np.zeros((len(batch_texts), self.seq_len), np.float32)
        for r, t in enumerate(batch_texts):
            e = self.tok.encode(t, eos=True)[: self.seq_len]
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1.0
        return LMBatch(torch.from_numpy(ids), torch.from_numpy(mask))

    def batches(self, epochs: int) -> Iterator[LMBatch]:
        n, b = len(self.texts), self.batch_size
        for _ in range(epochs):
            order = self.rng.permutation(n)
            for i in range(0, n - b + 1, b):
                yield self._encode([self.texts[j] for j in order[i: i + b]])
            rem = n % b
            if rem:  # wrap the tail so every batch keeps its shape
                tail = list(order[n - rem:]) + list(order[: b - rem])
                yield self._encode([self.texts[j] for j in tail])


class LMTrainer:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``, the
    JAX trainer's step. The state's params are updated IN PLACE (the JAX
    step donates its state); drop the old state, as the JAX loop does."""

    def __init__(self, model_cfg: DecoderConfig = DecoderConfig(),
                 train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(MULTI_GPU)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)
        sched = optim.warmup_cosine_decay_schedule(
            0.0, train_cfg.lr, train_cfg.warmup_steps, train_cfg.decay_steps)
        if train_cfg.optimizer == "adafactor":
            # decay is not handed to adafactor (optax applies its rate
            # unscaled by the schedule); a decoupled decay scaled by the
            # same schedule follows it, as in the JAX trainer
            inner = optim.chain(optim.adafactor(sched, min_dim_size_to_factor=32),
                                optim.scheduled_decay(sched, train_cfg.weight_decay))
        else:
            inner = optim.adamw(sched, weight_decay=train_cfg.weight_decay)
        self.tx = optim.chain(optim.clip_by_global_norm(1.0), inner)
        self._model: tuple[dict, Decoder] | None = None

    def init_state(self, seed: int = 0, params: dict | None = None) -> LMTrainState:
        """Float params drawn from ``seed`` (``decoder.init_params``), or the
        given tree (e.g. ``params_from_jax``), moved to the trainer's device
        as leaves that require grad."""
        if params is None:
            params = init_params(self.model_cfg, seed=seed, device=self.device)
        params = _leaves_on(params, self.device)
        return LMTrainState(params, self.tx.init(optim.tree_leaves(params)), 0)

    def model(self, params: dict) -> Decoder:
        """The decoder over ``params`` (its buffers ARE those leaves), built
        once per params dict: the cache holds the dict itself, so a new dict
        never meets a decoder built on freed leaves."""
        if self._model is None or self._model[0] is not params:
            self._model = (params, Decoder(self.model_cfg, params))
        return self._model[1]

    def train_step(self, state: LMTrainState, batch: LMBatch):
        leaves = optim.tree_leaves(state.params)
        logits = self.model(state.params).apply(batch.ids, batch.mask, remat=self.cfg.remat)
        loss = lm_loss(logits, batch.ids, batch.mask)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optim.global_norm(grads)
        updates, opt_state = self.tx.update(list(grads), state.opt_state, leaves)
        optim.apply_updates(leaves, updates)
        return (LMTrainState(state.params, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})


def _leaves_on(tree: dict, device) -> dict:
    """A copy of ``tree`` whose leaves are detached copies on ``device``
    that require grad."""
    return {k: _leaves_on(v, device) if isinstance(v, dict)
            else v.detach().to(device).clone().requires_grad_(True)
            for k, v in tree.items()}


def corpus_lm_texts(chunks) -> list[str]:
    """Chat-templated LM samples from parsed corpus chunks: the template the
    serving client renders, so train and serve distributions match."""
    from mediquery_rag_tpu_torch.llm.messages import ai, user
    from mediquery_rag_tpu_torch.llm.torch_client import render_chat

    return [render_chat([user(c.title), ai(c.content)], for_training=True)
            for c in chunks]


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/lm")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import time

    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.generate import Generator

    if args.dp * args.tp > 1:
        raise NotImplementedError(MULTI_GPU)
    mcfg = DecoderConfig() if args.layers is None else DecoderConfig(layers=args.layers)

    chunks = parse_corpus_file(args.corpus)
    texts = corpus_lm_texts(chunks)
    print(f"corpus: {len(chunks)} chunks -> {len(texts)} LM samples")

    tok = ByteTokenizer(mcfg.max_len)
    loader = LMLoader(texts, tok, args.batch_size, seed=args.seed)
    trainer = LMTrainer(mcfg, TrainConfig(batch_size=args.batch_size, lr=args.lr,
                                          warmup_steps=20), device=args.device)
    state = trainer.init_state(args.seed)

    step, t0 = 0, time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if step % 10 == 0 or step == 1:
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)")

    Generator(mcfg, state.params, device=args.device).save(args.out)
    print(f"saved LM -> {args.out}")


if __name__ == "__main__":
    main()
