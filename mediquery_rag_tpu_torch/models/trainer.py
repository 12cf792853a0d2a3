"""Contrastive trainer: InfoNCE fine-tuning of the embedder (port of
``mediquery_rag_tpu/models/trainer.py``).

In-batch-negative InfoNCE over (query, doc) pairs, optionally with mined
hard negatives, under the JAX package's recipe: global-norm clipping at
1.0, then AdamW under a warmup + cosine schedule (``models/optim.py``,
equal to optax's), with per-block recompute (``TrainConfig.remat``).
Dropout (``EmbedderConfig.dropout > 0``) draws its masks from a
``torch.Generator`` seeded 42, so they differ from JAX's (ROADMAP Queue C 4).

``ContrastiveTrainer(mesh=)`` runs the JAX trainer's ``("data", "model")``
mesh as one process per rank (``parallel/dist.py``): this rank's Megatron
shard of the encoder (``embedder_layout``), its rows of the global batch
(and those rows of the dropout masks the one-process step draws), and
InfoNCE over the GLOBAL batch: q, d and n are gathered over "data" with
their gradients (``gather_from_data``), so the labels are global row
numbers and the data ranks' summed gradients are the one-process step's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mediquery_rag_tpu_torch.config import EmbedderConfig, TrainConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.embedder import (
    Embedder, embedder_layout, init_params, trainable)
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import check_mesh


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
    step donates its state); drop the old state, as the JAX loop does.

    ``mesh``: a ``parallel.dist.TrainMesh``; the trainer then runs on its
    device, the state holds this rank's shard, and ``train_step`` takes
    the GLOBAL batch (every rank the same one)."""

    def __init__(self, model_cfg: EmbedderConfig = EmbedderConfig(),
                 train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                 device: str | torch.device = "cuda"):
        check_mesh(mesh)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.layout = embedder_layout(model_cfg, init_params(model_cfg, device="meta"), mesh)
        self.tx = optim.chain(
            optim.clip_by_global_norm(1.0, self.layout.shards),
            optim.adamw(optim.warmup_cosine_decay_schedule(
                0.0, train_cfg.lr, train_cfg.warmup_steps, train_cfg.decay_steps),
                weight_decay=train_cfg.weight_decay))
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        self._model: tuple[dict, Embedder] | None = None

    def init_state(self, generator: torch.Generator | None = None,
                   params: dict | None = None) -> TrainState:
        """Params drawn from ``generator`` (``embedder.init_params``), or the
        given full tree (e.g. JAX's), this rank's shard of it as leaves on
        the trainer's device that require grad."""
        if params is None:
            params = init_params(self.model_cfg, generator=generator, device=self.device)
        params = trainable(self.layout.shard(params), self.device)
        return TrainState(params, self.tx.init(optim.tree_leaves(params)), 0)

    def model(self, params: dict) -> Embedder:
        """The encoder over ``params``, built once per params dict."""
        if self._model is None or self._model[0] is not params:
            self._model = (params, Embedder(self.model_cfg, params, mesh=self.mesh))
        return self._model[1]

    def gather_params(self, params: dict) -> dict:
        """The full tree in JAX's layout (a collective: every rank calls it)."""
        return self.layout.gather(params)

    def loss(self, params: dict, batch: Batch) -> torch.Tensor:
        """The two towers (and the negatives) see their own dropout masks
        (SimCSE-style views) when ``dropout > 0``. Over a mesh: this data
        rank's rows, gathered over "data" before the loss (the same global
        loss on every rank)."""
        model = self.model(params)
        gen = self.generator if self.model_cfg.dropout > 0.0 else None
        n_rows = batch.q_ids.shape[0]
        rows = slice(None) if self.mesh is None else self.mesh.rows(n_rows)
        group = None if self.mesh is None else self.mesh.data_group

        def emb(ids, mask):
            e = model(torch.as_tensor(ids)[rows], torch.as_tensor(mask)[rows],
                      remat=bool(self.cfg.remat), generator=gen, rows=(n_rows, rows))
            return cc.gather_from_data(e, group)

        n = None if batch.n_ids is None else emb(batch.n_ids, batch.n_mask)
        return info_nce_loss(emb(batch.q_ids, batch.q_mask), emb(batch.d_ids, batch.d_mask),
                             self.cfg.temperature, n_emb=n)

    def train_step(self, state: TrainState, batch: Batch):
        leaves = optim.tree_leaves(state.params)
        loss = self.loss(state.params, batch)
        grads = self.layout.reduce_grads(list(torch.autograd.grad(loss, leaves)))
        gnorm = optim.global_norm(grads, self.layout.shards)
        updates, opt_state = self.tx.update(grads, state.opt_state, leaves)
        optim.apply_updates(leaves, updates)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})
