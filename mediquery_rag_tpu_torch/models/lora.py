"""LoRA fine-tuning of the decoder (port of ``mediquery_rag_tpu/models/lora.py``).

Rank-r deltas for the stacked projection matrices (``a: [L, in, r]``,
``b: [L, r, out]``); the step trains them against a frozen float base by
running ``Decoder.apply`` over ``W + (alpha/r) a@b``, and the tuned
adapters merge back into the base for serving, so the serving path pays
nothing. Adapter files (``adapters.npz`` + ``meta.json``) are the JAX
package's format, read by both packages. One card: the JAX trainer's mesh
is ROADMAP Queue A item 13 of the port.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import DecoderConfig, LoraConfig, TrainConfig
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models.decoder import Decoder
from mediquery_rag_tpu_torch.models.train_lm import MULTI_GPU, LMBatch, lm_loss

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


def lora_partition_specs(model, cfg: LoraConfig):
    """Adapter shardings over a device mesh: not ported (one card)."""
    raise NotImplementedError(MULTI_GPU)


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
        if mesh is not None:
            raise NotImplementedError(MULTI_GPU)
        self.model_cfg = model_cfg
        self.lora = lora_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)
        self.tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(
            optim.warmup_cosine_decay_schedule(0.0, train_cfg.lr, train_cfg.warmup_steps,
                                               train_cfg.decay_steps)))

    def init_state(self, seed: int, base_params: dict,
                   adapters: Adapters | None = None) -> LoraTrainState:
        """Adapters drawn from ``seed`` (or the given ones, e.g. converted
        from JAX) on the trainer's device, as leaves that require grad."""
        if adapters is None:
            adapters = lora_init(seed, base_params, self.lora)
        adapters = {t: {k: x.detach().to(self.device).clone().requires_grad_(True)
                        for k, x in ab.items()} for t, ab in adapters.items()}
        return LoraTrainState(adapters, self.tx.init(optim.tree_leaves(adapters)), 0)

    def train_step(self, state: LoraTrainState, base_params: dict, batch: LMBatch):
        leaves = optim.tree_leaves(state.adapters)
        base = {"blocks": {k: v.detach() for k, v in base_params["blocks"].items()},
                **{k: v.detach() for k, v in base_params.items() if k != "blocks"}}
        merged = lora_merge(base, state.adapters, self.lora)
        logits = Decoder(self.model_cfg, merged).apply(batch.ids, batch.mask,
                                                       remat=self.cfg.remat)
        loss = lm_loss(logits, batch.ids, batch.mask)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optim.global_norm(grads)
        updates, opt_state = self.tx.update(list(grads), state.opt_state, leaves)
        optim.apply_updates(leaves, updates)
        # the delta's size is LoRA's honest progress meter (loss alone cannot
        # separate base quality from adaptation)
        with torch.no_grad():
            scale = self.lora.alpha / self.lora.rank
            dnorm = optim.global_norm([lora_delta(ab, scale)
                                       for ab in state.adapters.values()])
        return (LoraTrainState(state.adapters, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm, "delta_norm": dnorm})


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


def main(argv=None) -> None:
    """``python -m mediquery_rag_tpu_torch.models.lora``: fine-tune a saved
    decoder checkpoint on corpus chat samples, save the adapters and,
    optionally, the merged model."""
    import argparse
    import time

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

    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.models.train_lm import LMLoader, corpus_lm_texts

    if args.dp * args.tp > 1:
        raise NotImplementedError(MULTI_GPU)
    gen = Generator.from_checkpoint(args.base, device=args.device)
    lcfg = LoraConfig(rank=args.rank, alpha=args.alpha)
    texts = corpus_lm_texts(parse_corpus_file(args.corpus))
    loader = LMLoader(texts, gen.tokenizer, args.batch_size, seed=args.seed)
    trainer = LoraTrainer(gen.cfg, lcfg, TrainConfig(batch_size=args.batch_size, lr=args.lr,
                                                     warmup_steps=20), device=args.device)
    state = trainer.init_state(args.seed, gen.params)

    step, t0 = 0, time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, gen.params, batch)
        step += 1
        if step % 10 == 0 or step == 1:
            print(f"step {step}: loss {float(metrics['loss']):.4f} "
                  f"delta {float(metrics['delta_norm']):.3f} ({time.time() - t0:.1f}s)")

    save_adapters(args.out, state.adapters, lcfg)
    print(f"saved adapters -> {args.out}")
    if args.merged_out:
        with torch.no_grad():
            merged = lora_merge(gen.params, state.adapters, lcfg)
        Generator(gen.cfg, merged, device=args.device,
                  tokenizer=gen.tokenizer).save(args.merged_out)
        print(f"saved merged model -> {args.merged_out}")


if __name__ == "__main__":
    main()
