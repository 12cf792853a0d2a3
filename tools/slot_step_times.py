#!/usr/bin/env python3
"""Time one continuous-batching decode step (``Decoder.decode_step_slots``)
of the PyTorch port on one NVIDIA GPU, through the einsum and the flash
attention route, over a bf16 and an int8 KV cache.

    python3 tools/slot_step_times.py [--root CHECKOUT] [--out FILE]

Two decoders with random weights from seed 0: ``DecoderConfig()``'s
(hidden 512, 8 layers, 8 MHA heads, a 1,024-column cache: what
``train_lm`` trains and saves by default) and the 1B-class widths (hidden
2048, 16 layers, 16 MHA heads, MLP 5632). Lane ``b`` of ``B`` (1 or 8)
holds 512 + 37 * b live columns of random K/V. Each case reports the
median and the minimum wall time of 50 steps after 3 warm-up steps (the
card synchronized after each step), the card's busy time and device ops
per step from ``torch.profiler`` over 16 more steps (``obs.cuda_busy``),
and the B5 launches (``flash_decode*_cuda``) of one step. ``--root``
imports the port from another checkout (the timing helper comes from this
one), so that two trees are timed by one script on one card (run parent,
change, change, parent). Prints the card line, then one JSON object per
case; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM, STEPS = 3, 50


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from dataclasses import replace

    import torch

    if not torch.cuda.is_available():
        print("slot_step_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "timing", os.path.join(HERE, "mediquery_rag_tpu_torch", "obs", "metrics.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params
    from mediquery_rag_tpu_torch.ops import attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; root {os.path.abspath(args.root)}", flush=True)
    counters = [attention.flash_decode_cuda, attention.flash_decode_int8_cuda,
                attention.flash_decode_ml_cuda]
    configs = {"DecoderConfig()": DecoderConfig(),
               "1B-class": DecoderConfig(vocab_size=384, hidden=2048, layers=16, heads=16,
                                         mlp_dim=5632, max_len=1024)}
    rows = []
    for cname, base in configs.items():
        params = init_params(base, seed=0, device="cuda")
        for kv in ("", "int8"):
            for impl in ("einsum", "flash"):
                dec = Decoder(replace(base, kv_dtype=kv, attn_impl=impl), params)
                for B in (1, 8):
                    rows.append(_case(torch, timing, dec, counters, B, cname, kv or "bf16",
                                      impl))
                    print(json.dumps(rows[-1]), flush=True)
                del dec
        del params
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "root": os.path.abspath(args.root), "cases": rows},
                      f, indent=1)
    return 0


def _case(torch, timing, dec, counters, B: int, cname: str, kv: str, impl: str) -> dict:
    """``dec``'s slot step at ``B`` lanes over a half-full cache."""
    C = dec.cfg.max_len
    gen = torch.Generator(device="cuda").manual_seed(B)
    cache = dec.empty_cache(B, C)
    lens = torch.tensor([C // 2 + 37 * b for b in range(B)], device="cuda")
    live = torch.arange(C, device="cuda")[None, :] < lens[:, None]
    for t in (cache.k, cache.v):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda"))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    for t in (cache.k_scale, cache.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda") * 0.02)
    cache.key_mask.copy_(live.float())
    cache.cursor.copy_(lens)
    cache.next_pos.copy_(lens.to(cache.next_pos.dtype))
    token = torch.randint(3, 259, (B,), generator=gen, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    times = []
    for i in range(WARM + STEPS):
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = dec.decode_step_slots(cache, token, active)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        token = logits.argmax(-1)
    launches = sum(fn.launches for fn in counters)

    def step():
        nonlocal token
        token = dec.decode_step_slots(cache, token, active).argmax(-1)

    prof = timing.cuda_busy(step, iters=16, top=0)
    return {"config": cname, "kv": kv, "attn_impl": impl, "B": B,
            "median_ms": statistics.median(times[WARM:]), "min_ms": min(times[WARM:]),
            "busy_ms": prof["busy_ms"], "device_ops": prof["device_ops"],
            "b5_launches_per_step": launches}


if __name__ == "__main__":
    sys.exit(main())
