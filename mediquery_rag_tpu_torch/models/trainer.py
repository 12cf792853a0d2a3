"""Contrastive trainer: InfoNCE fine-tuning of the embedder (port of
``mediquery_rag_tpu/models/trainer.py``).

In-batch-negative InfoNCE over (query, doc) pairs, optionally with mined
hard negatives, under the JAX package's recipe: global-norm clipping at
1.0, then AdamW under a warmup + cosine schedule (``models/optim.py``,
equal to optax's), with per-block recompute (``TrainConfig.remat``). One
card: the JAX trainer's data/model mesh is ROADMAP Queue A item 13.
Dropout (``EmbedderConfig.dropout > 0``) draws its masks from a
``torch.Generator`` seeded 42, so they differ from JAX's (ROADMAP Queue C 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mediquery_rag_tpu_torch.config import EmbedderConfig, TrainConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.embedder import (
    MULTI_GPU, Embedder, init_params, trainable)


class TrainState(NamedTuple):
    params: dict           # leaf tensors that require grad, updated in place
    opt_state: list
    step: int


class Batch(NamedTuple):
    q_ids: torch.Tensor    # [B, S]
    q_mask: torch.Tensor
    d_ids: torch.Tensor    # [B, S]
    d_mask: torch.Tensor
    n_ids: torch.Tensor | None = None    # [B, S] mined hard negatives
    n_mask: torch.Tensor | None = None


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, temperature: float,
                  n_emb: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional in-batch-negative InfoNCE. Embeddings L2-normalized.
    ``n_emb`` ([B, D] mined hard negatives) extends the q->d direction's
    candidate set to [d; n]: every negative is shared across the batch."""
    logits = q_emb.float() @ d_emb.float().T
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_dq = F.cross_entropy(logits.T / temperature, labels)
    if n_emb is not None:
        logits = torch.cat([logits, q_emb.float() @ n_emb.float().T], dim=1)
    l_qd = F.cross_entropy(logits / temperature, labels)
    return 0.5 * (l_qd + l_dq)


class ContrastiveTrainer:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``, the
    JAX trainer's step. The state's params are updated IN PLACE (the JAX
    step donates its state); drop the old state, as the JAX loop does."""

    def __init__(self, model_cfg: EmbedderConfig = EmbedderConfig(),
                 train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(MULTI_GPU)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)
        self.tx = optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(optim.warmup_cosine_decay_schedule(
                0.0, train_cfg.lr, train_cfg.warmup_steps, train_cfg.decay_steps),
                weight_decay=train_cfg.weight_decay))
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self._model: tuple[dict, Embedder] | None = None

    def init_state(self, generator: torch.Generator | None = None,
                   params: dict | None = None) -> TrainState:
        """Params drawn from ``generator`` (``embedder.init_params``), or the
        given tree (e.g. JAX's), as leaves on the trainer's device that
        require grad."""
        if params is None:
            params = init_params(self.model_cfg, generator=generator, device=self.device)
        params = trainable(params, self.device)
        return TrainState(params, self.tx.init(optim.tree_leaves(params)), 0)

    def model(self, params: dict) -> Embedder:
        """The encoder over ``params``, built once per params dict."""
        if self._model is None or self._model[0] is not params:
            self._model = (params, Embedder(self.model_cfg, params))
        return self._model[1]

    def loss(self, params: dict, batch: Batch) -> torch.Tensor:
        """The two towers (and the negatives) see their own dropout masks
        (SimCSE-style views) when ``dropout > 0``."""
        model = self.model(params)
        gen = self.generator if self.model_cfg.dropout > 0.0 else None

        def emb(ids, mask):
            return model(ids, mask, remat=bool(self.cfg.remat), generator=gen)

        n = None if batch.n_ids is None else emb(batch.n_ids, batch.n_mask)
        return info_nce_loss(emb(batch.q_ids, batch.q_mask), emb(batch.d_ids, batch.d_mask),
                             self.cfg.temperature, n_emb=n)

    def train_step(self, state: TrainState, batch: Batch):
        leaves = optim.tree_leaves(state.params)
        loss = self.loss(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optim.global_norm(grads)
        updates, opt_state = self.tx.update(list(grads), state.opt_state, leaves)
        optim.apply_updates(leaves, updates)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})
