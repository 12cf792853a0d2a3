"""Causal-LM trainer + ``python -m mediquery_rag_tpu_torch.models.train_lm``
(port of ``mediquery_rag_tpu/models/train_lm.py``).

Next-token cross-entropy over chat-templated corpus text with the JAX
package's recipe: ``Decoder.apply`` (flash attention: B6 forward, B10a and
B10b backward) with per-block recompute, global-norm clipping at 1.0, then
AdamW (or Adafactor with decay scaled by the schedule) under a warmup +
cosine schedule (``models/optim.py``, equal to optax's).

``LMTrainer(mesh=)`` runs the JAX trainer's ``("data", "model")`` mesh as
one process per rank (``parallel/dist.py``; ``main --dp/--tp`` spawns
them): every rank draws the same full parameters and keeps its Megatron
shard (``decoder_layout``), takes its rows of the global batch, and sums
its masked CE over the GLOBAL batch's count, so the data ranks' summed
gradients are the one-process step's; clipping and the optimizer see the
whole tree's norms. Rank 0 saves the gathered parameters in JAX's layout.
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
from mediquery_rag_tpu_torch.models.decoder import Decoder, decoder_layout, init_params
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import check_batch, check_mesh, launch


class LMBatch(NamedTuple):
    ids: torch.Tensor      # [B, S] int, right-padded, BOS...EOS
    mask: torch.Tensor     # [B, S] f32


class LMTrainState(NamedTuple):
    params: dict           # leaf tensors that require grad, updated in place
    opt_state: list
    step: int


def loss_count(mask: torch.Tensor) -> torch.Tensor:
    """Positions ``lm_loss`` averages over: input and target both real."""
    mask = mask.float()
    return (mask[:, :-1] * mask[:, 1:]).sum()


def lm_loss(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
            count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in f32. Only positions where both the input token
    and the target token are real contribute. ``count``: divide by this
    (a data rank's rows of a global batch: the global ``loss_count``)."""
    ids, mask = ids.to(logits.device).long(), mask.to(logits.device).float()
    B, S, V = logits.shape
    ce = F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                         ids[:, 1:].reshape(-1), reduction="none").reshape(B, S - 1)
    lmask = mask[:, :-1] * mask[:, 1:]
    count = lmask.sum() if count is None else count.to(logits.device)
    return (ce * lmask).sum() / torch.clamp(count, min=1.0)


def mesh_loss(logits_fn, batch: LMBatch, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's term, the global loss) of ``lm_loss`` over ``mesh``:
    ``logits_fn`` runs this data rank's rows; the term divides their masked
    CE sum by the global batch's count, so the data ranks' terms (and
    their gradients) sum to the one-process step's."""
    if mesh is None:
        loss = lm_loss(logits_fn(batch.ids, batch.mask), batch.ids, batch.mask)
        return loss, loss.detach()
    rows = mesh.rows(batch.ids.shape[0])
    ids, mask = batch.ids[rows], batch.mask[rows]
    term = lm_loss(logits_fn(ids, mask), ids, mask, count=loss_count(batch.mask))
    return term, cc.all_reduce(term.detach(), mesh.data_group)


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
    step donates its state); drop the old state, as the JAX loop does.

    ``mesh``: a ``parallel.dist.TrainMesh``; the trainer then runs on its
    device (``device`` is ignored), the state holds this rank's shard, and
    ``train_step`` takes the GLOBAL batch (every rank the same one)."""

    def __init__(self, model_cfg: DecoderConfig = DecoderConfig(),
                 train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                 device: str | torch.device = "cuda"):
        check_mesh(mesh)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        meta = init_params(model_cfg, seed=0, device="meta")
        self.layout = decoder_layout(model_cfg, meta, mesh)
        shards = self.layout.shards
        sched = optim.warmup_cosine_decay_schedule(
            0.0, train_cfg.lr, train_cfg.warmup_steps, train_cfg.decay_steps)
        if train_cfg.optimizer == "adafactor":
            # decay is not handed to adafactor (optax applies its rate
            # unscaled by the schedule); a decoupled decay scaled by the
            # same schedule follows it, as in the JAX trainer
            inner = optim.chain(
                optim.adafactor(sched, min_dim_size_to_factor=32, shards=shards),
                optim.scheduled_decay(sched, train_cfg.weight_decay))
        else:
            inner = optim.adamw(sched, weight_decay=train_cfg.weight_decay)
        self.tx = optim.chain(optim.clip_by_global_norm(1.0, shards), inner)
        self._model: tuple[dict, Decoder] | None = None

    def init_state(self, seed: int = 0, params: dict | None = None) -> LMTrainState:
        """Float params drawn from ``seed`` (``decoder.init_params``), or the
        given full tree (e.g. ``params_from_jax``), this rank's shard of it
        moved to the trainer's device as leaves that require grad."""
        if params is None:
            params = init_params(self.model_cfg, seed=seed, device=self.device)
        params = _leaves_on(self.layout.shard(params), self.device)
        return LMTrainState(params, self.tx.init(optim.tree_leaves(params)), 0)

    def model(self, params: dict) -> Decoder:
        """The decoder over ``params`` (its buffers ARE those leaves), built
        once per params dict: the cache holds the dict itself, so a new dict
        never meets a decoder built on freed leaves."""
        if self._model is None or self._model[0] is not params:
            self._model = (params, Decoder(self.model_cfg, params, mesh=self.mesh))
        return self._model[1]

    def gather_params(self, params: dict) -> dict:
        """The full tree in JAX's layout (every rank's part gathered; a
        collective: every rank calls it)."""
        return self.layout.gather(params)

    def train_step(self, state: LMTrainState, batch: LMBatch):
        leaves = optim.tree_leaves(state.params)
        model = self.model(state.params)
        term, loss = mesh_loss(lambda i, m: model.apply(i, m, remat=self.cfg.remat),
                               batch, self.mesh)
        grads = self.layout.reduce_grads(list(torch.autograd.grad(term, leaves)))
        gnorm = optim.global_norm(grads, self.layout.shards)
        updates, opt_state = self.tx.update(grads, state.opt_state, leaves)
        optim.apply_updates(leaves, updates)
        return (LMTrainState(state.params, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})


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


def _train(mesh, args) -> None:
    """The corpus loop of ``main`` on one rank (``mesh`` None: one process)."""
    import time

    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.generate import Generator

    mcfg = DecoderConfig() if args.layers is None else DecoderConfig(layers=args.layers)
    lead = mesh is None or torch.distributed.get_rank() == 0
    chunks = parse_corpus_file(args.corpus)
    texts = corpus_lm_texts(chunks)
    if lead:
        print(f"corpus: {len(chunks)} chunks -> {len(texts)} LM samples", flush=True)

    tok = ByteTokenizer(mcfg.max_len)
    loader = LMLoader(texts, tok, args.batch_size, seed=args.seed)
    trainer = LMTrainer(mcfg, TrainConfig(batch_size=args.batch_size, lr=args.lr,
                                          warmup_steps=20), mesh=mesh, device=args.device)
    state = trainer.init_state(args.seed)

    step, t0 = 0, time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if lead and (step % 10 == 0 or step == 1):
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

    params = trainer.gather_params(state.params)
    if lead:
        Generator(mcfg, params, device=trainer.device).save(args.out)
        print(f"saved LM -> {args.out}", flush=True)


def main(argv: Sequence[str] | None = None) -> None:
    """``--dp``/``--tp`` above 1 spawn ``dp * tp`` ranks on ``--device``
    (``cuda``: rank r on ``cuda:r`` over NCCL; ``cpu``: gloo)."""
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
    check_batch(args.batch_size, args.dp)
    if args.dp * args.tp > 1:
        launch(_train, args.dp, args.tp, args, device=args.device)
    else:
        _train(None, args)


if __name__ == "__main__":
    main()
