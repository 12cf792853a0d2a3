#!/usr/bin/env python3
"""Speculative acceptance of a model drafting for itself, on the CPU.

    python3 tools/self_draft_acceptance.py [--root CHECKOUT] [--seeds 0-11]
                                           [--dequant-f32]

For each seed: a small bf16 decoder (3 layers, hidden 256, 4/2 heads, MLP
512, q/k/v bias, byte vocabulary) with random int4 weights and an int8 KV
cache serves 8 greedy requests of 32 tokens (prompts of 300-1,300 bytes of
the corpus, so prefill pieces run the dequantized product past 128 rows)
through ``LLMServer(draft=the same generator, gamma=4)``, the setting of
``chip_smoke.py`` 5c (b) at small widths. Prints one JSON line per seed:
lane rounds, emitted tokens and tokens per lane round (5 at most: every
proposal accepted). ``--root`` takes the port from another checkout;
``--dequant-f32`` makes ``QLinear``'s dequantized product keep the f32 sum
(``ops.matmul.mm_f32``) instead of rounding it to bf16.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seeds", default="0-11")
    ap.add_argument("--dequant-f32", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models import decoder
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.serve.llm import LLMServer

    if args.dequant_f32:
        from mediquery_rag_tpu_torch.ops.matmul import mm_f32
        forward = decoder.QLinear.forward

        def f32_dequant(self, x, adt, layer=None, weight=None):
            rows = x.numel() // x.shape[-1]
            if self.form != "int4" or rows <= decoder.MATVEC_MAX_ROWS:
                return forward(self, x, adt, layer, weight)
            return mm_f32(x, decoder.dequantize_weight_int4(self._int4(layer), adt).T, adt)

        decoder.QLinear.forward = f32_dequant
    torch.set_num_threads(4)
    lo, _, hi = args.seeds.partition("-")
    raw = open(os.path.join(args.root, "data", "medical_data.txt"), encoding="utf-8").read()
    prompts = [raw.encode()[:n].decode("utf-8", errors="ignore")
               for n in (300, 700, 1100, 500, 900, 400, 1300, 600)]
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=3, heads=4, kv_heads=2,
                        mlp_dim=512, max_len=2048, qkv_bias=True, dtype="bfloat16",
                        kv_dtype="int8", attn_impl="flash")
    for seed in range(int(lo), int(hi or lo) + 1):
        gen = Generator(cfg, decoder.init_params(cfg, seed=seed, device="cpu", bits=4),
                        device="cpu")
        with LLMServer(gen, slots=4, chunk=32, draft=gen, gamma=4) as srv:
            for f in [srv.submit(p, max_new_tokens=32) for p in prompts]:
                f.result()
            st = srv.stats
        print(json.dumps({"seed": seed, "dequant_f32": args.dequant_f32,
                          "lane_rounds": st["spec_lane_rounds"], "tokens": st["spec_tokens"],
                          "tokens_per_lane_round": st["spec_tokens"] / st["spec_lane_rounds"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
