#!/usr/bin/env python3
"""Speculative acceptance of a model drafting for itself, on the CPU.

    python3 tools/self_draft_acceptance.py [--root CHECKOUT] [--seeds 0-11]
                                           [--product tree|f32|bf16 | --jax]
                                           [--dtype float32]
                                           [--attn einsum]

For each seed: a small bf16 decoder (3 layers, hidden 256, 4/2 heads, MLP
512, q/k/v bias, byte vocabulary) with random int4 weights and an int8 KV
cache serves 8 greedy requests of 32 tokens (prompts of 300-1,300 bytes of
the corpus, so prefill pieces run the dequantized product past 128 rows)
through ``LLMServer(draft=the same generator, gamma=4)``, the setting of
``chip_smoke.py`` 5c (b) at small widths. Prints one JSON line per seed:
lane rounds, emitted tokens and tokens per lane round (5 at most: every
proposal accepted). ``--root`` takes the port from another checkout;
``--product f32`` or ``bf16`` makes ``QLinear``'s dequantized int4 product
keep the f32 sum (``ops.matmul.mm_f32``) or round it to bf16, whatever the
checkout does (``tree``, the default).

``--dtype float32`` runs the same model with f32 activations (the int4
weights and the int8 cache stay), where the two products are one.
``--attn einsum`` replaces flash attention by the einsum path in both
packages. Compiled JAX keeps some bf16 intermediates in f32 unless XLA is
told otherwise: run with ``XLA_FLAGS=--xla_allow_excess_precision=false``
to hold the port to JAX's rounding step by step.

``--jax`` serves each seed three times and prints the three side by side:
the JAX package's ``LLMServer`` on the same parameters (carried across leaf
by leaf; its interpreted kernels make a seed take minutes), and the port
with each of the two products. JAX runs a lane to the end of its
quantum and drops the surplus, where the port stops it once its budget is
emitted, so JAX's verify calls are recorded (a debug callback on the
target's ``extend_slots``) and counted by the port's rule: a lane round
counts while the lane is live and short of its budget. Also printed: whether
the replies are equal across the three (and where each first departs from
JAX's), and the target's logit gap between
its own token and the rejected proposal at each of JAX's rejections.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PROMPT_BYTES = (300, 700, 1100, 500, 900, 400, 1300, 600)
MAX_NEW, GAMMA, SLOTS, CHUNK = 32, 4, 4, 32


def port_model(seed, decoder, Generator, DecoderConfig, dtype="bfloat16", attn="flash"):
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=3, heads=4, kv_heads=2,
                        mlp_dim=512, max_len=2048, qkv_bias=True, dtype=dtype,
                        kv_dtype="int8", attn_impl=attn)
    params = decoder.init_params(cfg, seed=seed, device="cpu", bits=4)
    return cfg, params, Generator(cfg, params, device="cpu")


def serve_port(gen, prompts, LLMServer, max_new=MAX_NEW, slots=SLOTS) -> dict:
    with LLMServer(gen, slots=slots, chunk=CHUNK, draft=gen, gamma=GAMMA) as srv:
        texts = [f.result() for f in [srv.submit(p, max_new_tokens=max_new) for p in prompts]]
        st = srv.stats
    return {"lane_rounds": st["spec_lane_rounds"], "tokens": st["spec_tokens"],
            "tokens_per_lane_round": st["spec_tokens"] / st["spec_lane_rounds"],
            "texts": texts}


def serve_jax(cfg, params, prompts, max_new=MAX_NEW, slots=SLOTS) -> dict:
    """The JAX package's speculative server on the port's parameters,
    counted by the port's lane rule (module docstring)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import ml_dtypes
    import numpy as np
    import torch

    from mediquery_rag_tpu.config import DecoderConfig as JCfg
    from mediquery_rag_tpu.models.generate import Generator as JGenerator
    from mediquery_rag_tpu.serve.llm import LLMServer as JServer

    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else leaf(v) for k, v in d.items()}

    gen = JGenerator(JCfg(**cfg.__dict__), params=tree(params))
    G = GAMMA + 1
    records: list = []

    with JServer(gen, slots=slots, chunk=CHUNK, draft=gen, gamma=GAMMA) as srv:
        eos = srv._eos
        orig_extend = srv.model.extend_slots

        def record(cursor, toks, logits, live):
            records.append((np.asarray(toks), np.asarray(logits, np.float32),
                            np.asarray(live)))

        def extend_slots(p, cache, toks, active):
            logits, kv = orig_extend(p, cache, toks, active)
            if toks.shape[1] == G:          # the target's verify of a round
                jax.debug.callback(record, cache.cursor, toks, logits, active, ordered=True)
            return logits, kv

        srv.model.extend_slots = extend_slots
        orig_program = srv._spec_program
        count = {"lane_rounds": 0, "tokens": 0, "gaps": []}

        def spec_program():
            fn = orig_program()

            def run(*a):
                left = [r.max_new - len(r.tokens) if r is not None else 0 for r in srv._slots]
                start = len(records)
                out = fn(*a)
                jax.effects_barrier()
                ncol = [0] * slots
                for toks, logits, live in records[start:]:
                    u = logits.argmax(-1)
                    not_eos = toks != eos
                    keep = np.concatenate(
                        [not_eos[:, :1], (toks[:, 1:] == u[:, :-1]) & not_eos[:, 1:]], 1)
                    n_acc = np.cumprod(keep, 1).sum(1)
                    for b in range(slots):
                        if not live[b] or ncol[b] >= left[b]:
                            continue
                        count["lane_rounds"] += 1
                        emit = max(int(n_acc[b]), 1)
                        ncol[b] += emit
                        count["tokens"] += emit
                        j = int(n_acc[b])
                        if 1 <= j < G and not_eos[b, j]:
                            row = logits[b, j - 1]
                            count["gaps"].append(float(row[u[b, j - 1]] - row[toks[b, j]]))
                return out

            return run

        srv._spec_program = spec_program
        texts = [f.result() for f in [srv.submit(p, max_new_tokens=max_new) for p in prompts]]
    count["tokens_per_lane_round"] = count["tokens"] / count["lane_rounds"]
    count["texts"] = texts
    count["gaps"] = sorted(count["gaps"])
    return count


def first_diff(a: str, b: str) -> int | None:
    """Index of the first character where two replies differ (None: equal)."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seeds", default="0-11")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--product", default="tree", choices=("tree", "f32", "bf16"))
    mode.add_argument("--jax", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--attn", default="flash", choices=("flash", "einsum"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models import decoder
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.ops.matmul import mm_f32
    from mediquery_rag_tpu_torch.serve.llm import LLMServer

    forward = decoder.QLinear.forward

    def dequant(product):
        """QLinear.forward with the dequantized int4 product (past
        MATVEC_MAX_ROWS rows) keeping the f32 sum or rounded to bf16."""
        def fwd(self, x, adt, layer=None, weight=None):
            rows = x.numel() // x.shape[-1]
            if self.form != "int4" or rows <= decoder.MATVEC_MAX_ROWS:
                return forward(self, x, adt, layer, weight)
            wd = decoder.dequantize_weight_int4(self._int4(layer), adt)
            return mm_f32(x, wd.T, adt) if product == "f32" else (x.to(adt) @ wd.T).float()
        return fwd

    def set_product(product: str) -> None:
        decoder.QLinear.forward = forward if product == "tree" else dequant(product)

    torch.set_num_threads(4)
    lo, _, hi = args.seeds.partition("-")
    raw = open(os.path.join(args.root, "data", "medical_data.txt"), encoding="utf-8").read()
    prompts = [raw.encode()[:n].decode("utf-8", errors="ignore") for n in PROMPT_BYTES]
    for seed in range(int(lo), int(hi or lo) + 1):
        cfg, params, gen = port_model(seed, decoder, Generator, DecoderConfig, args.dtype,
                                      args.attn)
        if not args.jax:
            set_product(args.product)
            r = serve_port(gen, prompts, LLMServer)
            del r["texts"]
            print(json.dumps({"seed": seed, "dtype": args.dtype, "product": args.product,
                              **r}), flush=True)
            continue
        runs = {}
        for product in ("f32", "bf16"):
            set_product(product)
            runs[f"port_{product}"] = serve_port(gen, prompts, LLMServer)
        set_product("tree")
        runs["jax"] = serve_jax(cfg, params, prompts)
        texts = {k: r.pop("texts") for k, r in runs.items()}
        gaps = runs["jax"].pop("gaps")
        print(json.dumps({
            "seed": seed, "dtype": args.dtype, "attn": args.attn,
            "xla_flags": os.environ.get("XLA_FLAGS", ""), **runs,
            "replies_equal": {k: texts[k] == texts["jax"] for k in ("port_f32", "port_bf16")},
            "replies_first_diff": {k: [first_diff(a, b) for a, b in zip(texts[k], texts["jax"])]
                                   for k in ("port_f32", "port_bf16")},
            "jax_reject_gaps": {"n": len(gaps), "smallest": gaps[:5]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
