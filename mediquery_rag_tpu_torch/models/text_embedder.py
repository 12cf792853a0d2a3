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
cache, which changes no result (ROADMAP Queue C 4).

``mesh`` (a ``parallel.mesh.Mesh`` with a "data" axis) embeds data-
parallel for ingest, as JAX's ``P("data", None)`` batch over replicated
params: one process drives a copy of the params on each data device, the
rows are padded to a multiple of the data axis (JAX's rule), each part
is launched on its device, then the parts are gathered to the host.
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
    Embedder, init_params, load_params, save_params, skeleton, tree_to)
from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
from mediquery_rag_tpu_torch.parallel.mesh import Mesh


class TextEmbedder:
    def __init__(self, cfg: EmbedderConfig = EmbedderConfig(), params: dict | None = None,
                 generator: torch.Generator | None = None, mesh=None, *,
                 device: str | torch.device = "cuda"):
        """``params``: a JAX-layout tree of tensors (moved to ``device``),
        else drawn from ``generator`` (``embedder.init_params``). With a
        ``mesh``, ``device`` is its first data device."""
        self.cfg = cfg
        self.mesh = mesh
        self.devices = None
        if mesh is not None:
            if not isinstance(mesh, Mesh) or "data" not in mesh.axis_names:
                raise ValueError("mesh must be a parallel.mesh.Mesh with a 'data' axis")
            data = np.moveaxis(mesh.devices, mesh.axis_names.index("data"), 0)
            self.devices = list(data.reshape(data.shape[0], -1)[:, 0])
            device = self.devices[0]
        self.device = torch.device(device)
        self.tokenizer = HashCharTokenizer(cfg.vocab_size, cfg.max_len)
        if params is None:
            params = init_params(cfg, generator=generator, device=self.device)
        self._place(tree_to(params, self.device))

    def _place(self, params: dict) -> None:
        """The model on ``device``, and with a mesh one per data device (a
        device that repeats shares one copy)."""
        self.params = params
        self.model = Embedder(self.cfg, params)
        if self.devices is not None:
            models = {str(self.device): self.model}
            for d in self.devices:
                if str(d) not in models:
                    models[str(d)] = Embedder(self.cfg, tree_to(params, d))
            self._parts = [models[str(d)] for d in self.devices]

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    @torch.no_grad()
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Returns [len(texts), hidden] L2-normalized f32 embeddings."""
        if not texts:
            return np.zeros((0, self.cfg.hidden), np.float32)
        ids, mask = self.tokenizer.batch_encode(list(texts))
        if self.mesh is None:
            return self.model(ids, mask).cpu().numpy()
        b, dp = ids.shape[0], len(self.devices)
        pad = -(-b // dp) * dp - b            # rows must divide the data axis
        ids = np.pad(ids, ((0, pad), (0, 0)))
        mask = np.pad(mask, ((0, pad), (0, 0)))
        per = ids.shape[0] // dp
        outs = [m(ids[i * per:(i + 1) * per], mask[i * per:(i + 1) * per])
                for i, m in enumerate(self._parts)]     # every part launched first
        return torch.cat([o.cpu() for o in outs]).numpy()[:b]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed(texts)

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        save_params(self.params, path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(asdict(self.cfg), f)

    def load_params(self, path: str) -> None:
        self._place(load_params(path, skeleton(), self.device))

    @classmethod
    def from_checkpoint(cls, path: str, *,
                        device: str | torch.device = "cuda") -> "TextEmbedder":
        """Rebuild with the architecture recorded at save time."""
        with open(os.path.join(path, "config.json")) as f:
            cfg = EmbedderConfig(**json.load(f))
        params = load_params(path, skeleton(), device)
        return cls(cfg, params, device=device)
