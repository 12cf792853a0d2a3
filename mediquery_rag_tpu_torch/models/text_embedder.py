"""TextEmbedder: tokenizer + encoder + params behind one embed() call
(port of ``mediquery_rag_tpu/models/text_embedder.py``).

The in-process replacement for the reference's HTTP round trip to Ollama
per embedding call (medical_engine.py:43), served from ``device``.
Checkpoints keep the JAX package's format (``params.npz`` with leaves keyed
``"0".."n"`` in ``jax.tree_util.tree_flatten`` order, ``config.json`` the
``EmbedderConfig``), so either package loads the other's.

STATUS: experimental below real data scale. The from-scratch trained
encoder memorizes at the 160-chunk corpus, so the zero-egress default
retrieval stack is ``IDFHashingEmbedder`` and the hybrid fusion stays
behind ``MEDIQUERY_HYBRID=1``.

Each batch runs at its own size; JAX pads it to a power of two for its jit
cache, which changes no result (ROADMAP Queue C 4). A ``mesh`` (data-
parallel embedding) is ROADMAP Queue A item 13 and raises.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Sequence

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EmbedderConfig
from mediquery_rag_tpu_torch.models.embedder import (
    MULTI_GPU, Embedder, init_params, load_params, save_params, skeleton, tree_to)
from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer


class TextEmbedder:
    def __init__(self, cfg: EmbedderConfig = EmbedderConfig(), params: dict | None = None,
                 generator: torch.Generator | None = None, mesh=None, *,
                 device: str | torch.device = "cuda"):
        """``params``: a JAX-layout tree of tensors (moved to ``device``),
        else drawn from ``generator`` (``embedder.init_params``)."""
        if mesh is not None:
            raise NotImplementedError(MULTI_GPU)
        self.cfg = cfg
        self.device = torch.device(device)
        self.tokenizer = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
        if params is None:
            params = init_params(cfg, generator=generator, device=self.device)
        self.params = tree_to(params, self.device)
        self.model = Embedder(cfg, self.params)

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    @torch.no_grad()
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Returns [len(texts), hidden] L2-normalized f32 embeddings."""
        if not texts:
            return np.zeros((0, self.cfg.hidden), np.float32)
        ids, mask = self.tokenizer.batch_encode(list(texts))
        return self.model(ids, mask).cpu().numpy()

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed(texts)

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        save_params(self.params, path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(asdict(self.cfg), f)

    def load_params(self, path: str) -> None:
        self.params = load_params(path, skeleton(), self.device)
        self.model = Embedder(self.cfg, self.params)

    @classmethod
    def from_checkpoint(cls, path: str, *,
                        device: str | torch.device = "cuda") -> "TextEmbedder":
        """Rebuild with the architecture recorded at save time."""
        with open(os.path.join(path, "config.json")) as f:
            cfg = EmbedderConfig(**json.load(f))
        params = load_params(path, skeleton(), device)
        return cls(cfg, params, device=device)
