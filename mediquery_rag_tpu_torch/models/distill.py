"""Draft distillation for speculative decoding (port of ``mediquery_rag_tpu/models/distill.py``).

Speculation's speed is set by how often the draft's greedy proposals match
the target's. A draft with random weights matches about 1 in the vocabulary
size; sequence-level distillation fixes that: the target greedy-generates
continuations of a prompt distribution, and the draft trains next-token
cross-entropy on exactly those token streams (``Generator.generate_tokens``,
not decoded text, since acceptance compares raw ids). Training runs through
the port's ``LMTrainer`` (``Decoder.apply``; B6 forward and B10a/B10b
backward with flash attention on the card).

``python -m mediquery_rag_tpu_torch.models.distill --target DIR`` writes the
draft checkpoint that ``serve --draft`` and ``LLMServer(draft=...)`` load.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import DecoderConfig, TrainConfig
from mediquery_rag_tpu_torch.models.generate import Generator, _round_up
from mediquery_rag_tpu_torch.models.train_lm import LMBatch, LMTrainer


def distill_draft(
    target: Generator,
    draft_cfg: DecoderConfig,
    prompts: Sequence[str],
    *,
    max_new_tokens: int = 64,
    epochs: int = 30,
    train_cfg: TrainConfig | None = None,
    seed: int = 0,
    mesh=None,
    init_params: dict | None = None,
    extra_texts: Sequence[str] | None = None,
    device: str | torch.device = "cuda",
) -> Generator:
    """Train a ``draft_cfg`` model on ``device`` to imitate ``target``'s
    greedy continuations of ``prompts`` (JAX ``distill_draft``: the same
    right-padded batch, minibatches of at most 64 in the order of
    ``np.random.default_rng(seed)``, tails wrapped around). Returns a
    ``Generator`` sharing the target's tokenizer, with ``last_loss`` the
    last step's loss. ``init_params`` warm-starts the draft;
    ``extra_texts`` are rehearsal sequences mixed into the batch."""
    if draft_cfg.vocab_size != target.cfg.vocab_size:
        raise ValueError("draft vocab must match the target's")
    tok = target.tokenizer
    prompts = list(prompts)
    gen_rows = []
    for i0 in range(0, len(prompts), 64):
        gen_rows += target.generate_tokens(prompts[i0:i0 + 64], max_new_tokens=max_new_tokens)
    seqs = [tok.encode(p) + row for p, row in zip(prompts, gen_rows)]
    seqs += [tok.encode(t) for t in extra_texts or ()]

    S = _round_up(max(len(s) for s in seqs), 128)
    ids = np.full((len(seqs), S), int(tok.pad_id), np.int64)
    mask = np.zeros((len(seqs), S), np.float32)
    for r, s in enumerate(seqs):
        s = s[:S]
        ids[r, : len(s)] = s
        mask[r, : len(s)] = 1.0

    tcfg = train_cfg or TrainConfig(lr=3e-3, warmup_steps=20, remat=False)
    trainer = LMTrainer(draft_cfg, tcfg, mesh=mesh, device=device)
    state = trainer.init_state(seed, params=init_params)
    loss = float("inf")
    bs = min(max(tcfg.batch_size, 1), len(seqs), 64)
    shuf = np.random.default_rng(seed)
    for _ in range(epochs):
        order = shuf.permutation(len(seqs))
        for i0 in range(0, len(order), bs):
            sel = order[i0:i0 + bs]
            if len(sel) < bs:
                sel = np.concatenate([sel, order[: bs - len(sel)]])
            state, metrics = trainer.train_step(
                state, LMBatch(torch.from_numpy(ids[sel]), torch.from_numpy(mask[sel])))
            loss = metrics["loss"]
    params = _detached(state.params)
    draft = Generator(draft_cfg, params=params, device=device, tokenizer=tok)
    draft.last_loss = float(loss)
    return draft


def _detached(tree: dict) -> dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach() for k, v in tree.items()}


# draft shape presets (hidden, layers, heads, kv_heads, mlp_dim), as in the JAX package
PRESETS = {
    "tiny": (64, 2, 4, None, 128),          # CPU smoke / tests
    "draft-20M": (256, 4, 4, None, 768),
    "draft-60M": (512, 8, 8, None, 1536),
}


def main(argv: Sequence[str] | None = None) -> None:
    """Distill a draft for the target checkpoint ``--target`` (an HF
    qwen2-class directory or a ``Generator.save`` one) and save it to
    ``--out``. Prompts come
    from ``--prompts-file`` (one per line) or the corpus titles. The draft
    restores with ``Generator.from_checkpoint``; its tokenizer is the
    default one, which is harmless for serving, where only ids flow."""
    ap = argparse.ArgumentParser(prog="python -m mediquery_rag_tpu_torch.models.distill")
    ap.add_argument("--target", required=True,
                    help="an HF qwen2-class dir or a Generator checkpoint directory")
    ap.add_argument("--out", default="checkpoints/draft")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="draft-60M")
    ap.add_argument("--prompts-file", default=None,
                    help="one prompt per line (default: corpus titles)")
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(os.path.join(args.target, "config.json"), encoding="utf-8") as f:
        hf = "model_type" in json.load(f)     # an HF checkpoint, not a Generator save
    if hf:
        from mediquery_rag_tpu_torch.models.hf_import import load_qwen2_generator
        target = load_qwen2_generator(args.target, device=args.device)
    else:
        target = Generator.from_checkpoint(args.target, device=args.device)

    if args.prompts_file:
        with open(args.prompts_file, encoding="utf-8") as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        from mediquery_rag_tpu_torch.ingest.parser import parse_corpus_file
        prompts = [c.title for c in parse_corpus_file(args.corpus)]
    if not prompts:
        raise SystemExit("no prompts to distill on")

    h, layers, heads, kvh, mlp = PRESETS[args.preset]
    dcfg = DecoderConfig(vocab_size=target.cfg.vocab_size, hidden=h, layers=layers,
                         heads=heads, kv_heads=kvh, mlp_dim=mlp, max_len=target.cfg.max_len,
                         dtype=target.cfg.dtype)
    draft = distill_draft(target, dcfg, prompts, max_new_tokens=args.max_new,
                          epochs=args.epochs, device=args.device)
    draft.save(args.out)
    print(json.dumps({"out": args.out, "preset": args.preset,
                      "last_loss": round(draft.last_loss, 4), "prompts": len(prompts)}))


if __name__ == "__main__":
    main()
