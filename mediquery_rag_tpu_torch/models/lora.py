"""LoRA fine-tuning of the decoder (port of ``mediquery_rag_tpu/models/lora.py``).

Rank-r deltas for the stacked projection matrices (``a: [L, in, r]``,
``b: [L, r, out]``); the step trains them against a frozen float base by
running ``Decoder.apply`` over ``W + (alpha/r) a@b``, and the tuned
adapters merge back into the base for serving, so the serving path pays
nothing. Adapter files (``adapters.npz`` + ``meta.json``) are the JAX
package's format, read by both packages.

``LoraTrainer(mesh=)`` trains over a ``("data", "model")`` mesh as
``LMTrainer`` does (``parallel/dist.py``): the frozen base is this rank's
Megatron shard, ``a`` follows its target's in-dim and ``b`` its out-dim
(``lora_partition_specs``), and the factor that stays whole enters the
merge through ``copy_to_model``, so its gradient sums every rank's part.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import DecoderConfig, LoraConfig, TrainConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.decoder import (
    Decoder, decoder_layout, init_params, partition_specs)
from mediquery_rag_tpu_torch.models.train_lm import LMBatch, mesh_loss
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import (
    Layout, check_batch, check_mesh, head_parts, launch)

Adapters = dict  # {target: {"a": [L, in, r], "b": [L, r, out]}}


def lora_init(seed: int, params: dict, cfg: LoraConfig) -> Adapters:
    """Fresh adapters for ``params`` on their device: ``a`` gaussian
    (fan-in scaled, from a ``torch.Generator`` seeded with ``seed``), ``b``
    zero, so the merged model starts exactly at the base."""
    adapters: Adapters = {}
    for t in cfg.targets:
        if t not in params["blocks"]:
            raise ValueError(f"unknown LoRA target {t!r}; blocks have "
                             f"{sorted(params['blocks'])}")
        w = params["blocks"][t]
        if isinstance(w, dict):
            raise ValueError(
                f"target {t!r} is weight-quantized; LoRA trains against FLOAT base "
                "params (load the float checkpoint, merge, then quantize for serving)")
        layers, fan_in, out = w.shape
        gen = torch.Generator(device=w.device).manual_seed(seed + len(adapters))
        adapters[t] = {
            "a": torch.randn((layers, fan_in, cfg.rank), generator=gen, device=w.device)
            * fan_in ** -0.5,
            "b": torch.zeros((layers, cfg.rank, out), device=w.device),
        }
    return adapters


def lora_delta(ab: dict, scale: float) -> torch.Tensor:
    """``(alpha/r) a@b`` as one product batched over layers, f32."""
    return torch.einsum("lir,lro->lio", ab["a"].float(), ab["b"].float()) * scale


def lora_merge(params: dict, adapters: Adapters, cfg: LoraConfig) -> dict:
    """Base params with adapters folded in: ``W' = W + (alpha/r) a@b``. A
    new tree sharing every untouched leaf."""
    scale = cfg.alpha / cfg.rank
    blocks = dict(params["blocks"])
    for t, ab in adapters.items():
        w = blocks[t]
        if isinstance(w, dict):
            raise ValueError(f"cannot merge into quantized target {t!r}")
        blocks[t] = (w.float() + lora_delta(ab, scale)).to(w.dtype)
    return {**params, "blocks": blocks}


def lora_partition_specs(model, cfg: LoraConfig) -> dict:
    """Adapter layouts from the base's Megatron specs (JAX
    ``lora_partition_specs``; ``model``: a ``Decoder`` or its config):
    ``a`` follows the target's in-dim, ``b`` its out-dim, and the rank axis
    is replicated."""
    base = partition_specs(getattr(model, "cfg", model))["blocks"]
    specs = {}
    for t in cfg.targets:
        if t not in base:
            raise ValueError(f"unknown LoRA target {t!r}; blocks have {sorted(base)}")
        _, in_ax, out_ax = base[t]
        specs[t] = {"a": (None, in_ax, None), "b": (None, None, out_ax)}
    return specs


def lora_layout(model_cfg: DecoderConfig, cfg: LoraConfig, mesh) -> Layout:
    """This rank's layout of the adapters: ``b`` of qkv by heads, as the
    base's columns (``decoder_layout``)."""
    params = init_params(model_cfg, device="meta")
    adapters = {t: {"a": torch.empty(w.shape[0], w.shape[1], cfg.rank, device="meta"),
                    "b": torch.empty(w.shape[0], cfg.rank, w.shape[2], device="meta")}
                for t in cfg.targets for w in [params["blocks"][t]]}
    parts = {}
    if mesh is not None and mesh.tp > 1 and "qkv" in cfg.targets:
        parts[("qkv", "b")] = head_parts(model_cfg.heads, model_cfg.kv_heads or model_cfg.heads,
                                         model_cfg.hidden // model_cfg.heads, mesh.tp)
    return Layout(adapters, lora_partition_specs(model_cfg, cfg), mesh, parts)


class LoraTrainState(NamedTuple):
    adapters: Adapters     # leaf tensors that require grad, updated in place
    opt_state: list
    step: int


class LoraTrainer:
    """``LMTrainer``'s step with the base FROZEN: optimizer state exists
    only for the adapters (Adam, no weight decay: decaying a and b pulls the
    delta toward zero at a rate set by the a/b split, not by the delta)."""

    def __init__(self, model_cfg: DecoderConfig = DecoderConfig(),
                 lora_cfg: LoraConfig = LoraConfig(),
                 train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                 device: str | torch.device = "cuda"):
        check_mesh(mesh)
        self.model_cfg = model_cfg
        self.lora = lora_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.base_layout = decoder_layout(model_cfg, init_params(model_cfg, device="meta"), mesh)
        self.layout = lora_layout(model_cfg, lora_cfg, mesh)
        self.tx = optim.chain(optim.clip_by_global_norm(1.0, self.layout.shards), optim.adam(
            optim.warmup_cosine_decay_schedule(0.0, train_cfg.lr, train_cfg.warmup_steps,
                                               train_cfg.decay_steps)))
        self._base: tuple[dict, dict] | None = None

    def init_state(self, seed: int, base_params: dict,
                   adapters: Adapters | None = None) -> LoraTrainState:
        """Adapters drawn from ``seed`` for the full ``base_params`` (or the
        given ones, e.g. converted from JAX), this rank's shard of them on
        the trainer's device, as leaves that require grad."""
        if adapters is None:
            adapters = lora_init(seed, base_params, self.lora)
        adapters = self.layout.shard(adapters)
        adapters = {t: {k: x.detach().to(self.device).clone().requires_grad_(True)
                        for k, x in ab.items()} for t, ab in adapters.items()}
        return LoraTrainState(adapters, self.tx.init(optim.tree_leaves(adapters)), 0)

    def gather_adapters(self, adapters: Adapters) -> Adapters:
        """The full adapters (a collective: every rank calls it)."""
        return self.layout.gather(adapters)

    def _local_base(self, base_params: dict) -> dict:
        """This rank's frozen shard of the full base, cut once per dict."""
        if self._base is None or self._base[0] is not base_params:
            local = self.base_layout.shard(base_params)
            local = {"blocks": {k: v.detach() for k, v in local["blocks"].items()},
                     **{k: v.detach() for k, v in local.items() if k != "blocks"}}
            self._base = (base_params, local)
        return self._base[1]

    def _whole_factors(self, adapters: Adapters) -> Adapters:
        """Each target's factor that stays whole while the other is split
        goes through ``copy_to_model``: its gradient then sums the ranks'."""
        group = None if self.mesh is None else self.mesh.model_group
        shard = dict(zip(self.layout.paths, self.layout.shards))
        out = {}
        for t, ab in adapters.items():
            split_a, split_b = shard[(t, "a")] is not None, shard[(t, "b")] is not None
            out[t] = {"a": cc.copy_to_model(ab["a"], group) if split_b else ab["a"],
                      "b": cc.copy_to_model(ab["b"], group) if split_a else ab["b"]}
        return out

    def train_step(self, state: LoraTrainState, base_params: dict, batch: LMBatch):
        """``base_params``: the FULL base tree (sharded here once per dict)."""
        leaves = optim.tree_leaves(state.adapters)
        merged = lora_merge(self._local_base(base_params), self._whole_factors(state.adapters),
                            self.lora)
        model = Decoder(self.model_cfg, merged, mesh=self.mesh)
        term, loss = mesh_loss(lambda i, m: model.apply(i, m, remat=self.cfg.remat),
                               batch, self.mesh)
        grads = self.layout.reduce_grads(list(torch.autograd.grad(term, leaves)))
        gnorm = optim.global_norm(grads, self.layout.shards)
        updates, opt_state = self.tx.update(grads, state.opt_state, leaves)
        optim.apply_updates(leaves, updates)
        # the delta's size is LoRA's honest progress meter (loss alone cannot
        # separate base quality from adaptation)
        with torch.no_grad():
            scale = self.lora.alpha / self.lora.rank
            shard = dict(zip(self.base_layout.paths, self.base_layout.shards))
            dnorm = optim.global_norm([lora_delta(ab, scale) for ab in state.adapters.values()],
                                      [shard[("blocks", t)] for t in state.adapters])
        return (LoraTrainState(state.adapters, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "delta_norm": dnorm})


def save_adapters(path: str, adapters: Adapters, cfg: LoraConfig) -> None:
    """Adapters + config as one ``adapters.npz`` + ``meta.json`` (the JAX
    package's format)."""
    os.makedirs(path, exist_ok=True)
    flat = {}
    for t, ab in adapters.items():
        flat[f"{t}.a"] = ab["a"].detach().float().cpu().numpy()
        flat[f"{t}.b"] = ab["b"].detach().float().cpu().numpy()
    np.savez(os.path.join(path, "adapters.npz"), **flat)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"rank": cfg.rank, "alpha": cfg.alpha,
                   "targets": list(cfg.targets)}, f)


def load_adapters(path: str, *, device: str | torch.device = "cuda"
                  ) -> tuple[Adapters, LoraConfig]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = LoraConfig(rank=meta["rank"], alpha=meta["alpha"],
                     targets=tuple(meta["targets"]))
    with np.load(os.path.join(path, "adapters.npz")) as z:
        adapters = {t: {"a": torch.from_numpy(z[f"{t}.a"]).to(device),
                        "b": torch.from_numpy(z[f"{t}.b"]).to(device)}
                    for t in cfg.targets}
    return adapters, cfg


def _train(mesh, args) -> None:
    """The corpus loop of ``main`` on one rank (``mesh`` None: one process)."""
    import time

    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.models.train_lm import LMLoader, corpus_lm_texts

    device = args.device if mesh is None else mesh.device
    lead = mesh is None or torch.distributed.get_rank() == 0
    gen = Generator.from_checkpoint(args.base, device=device)
    lcfg = LoraConfig(rank=args.rank, alpha=args.alpha)
    texts = corpus_lm_texts(parse_corpus_file(args.corpus))
    loader = LMLoader(texts, gen.tokenizer, args.batch_size, seed=args.seed)
    trainer = LoraTrainer(gen.cfg, lcfg, TrainConfig(batch_size=args.batch_size, lr=args.lr,
                                                     warmup_steps=20), mesh=mesh, device=device)
    state = trainer.init_state(args.seed, gen.params)

    step, t0 = 0, time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, gen.params, batch)
        step += 1
        if lead and (step % 10 == 0 or step == 1):
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"delta {float(metrics['delta_norm']):.3f} ({time.time() - t0:.1f}s)",
                  flush=True)

    adapters = trainer.gather_adapters(state.adapters)
    if not lead:
        return
    save_adapters(args.out, adapters, lcfg)
    print(f"saved adapters -> {args.out}", flush=True)
    if args.merged_out:
        with torch.no_grad():
            merged = lora_merge(gen.params, adapters, lcfg)
        Generator(gen.cfg, merged, device=device,
                  tokenizer=gen.tokenizer).save(args.merged_out)
        print(f"saved merged model -> {args.merged_out}", flush=True)


def main(argv=None) -> None:
    """``python -m mediquery_rag_tpu_torch.models.lora``: fine-tune a saved
    decoder checkpoint on corpus chat samples, save the adapters and,
    optionally, the merged model. ``--dp``/``--tp`` above 1 spawn ``dp *
    tp`` ranks on ``--device``, as ``train_lm`` does."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="Generator checkpoint dir (models/generate.py save)")
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/lora")
    ap.add_argument("--merged-out", default="", help="also save the merged model here")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
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
