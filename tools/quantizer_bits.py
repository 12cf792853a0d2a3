#!/usr/bin/env python3
"""Count the row quantizers' scale and code mismatches between the CPU and
one NVIDIA GPU.

    python3 tools/quantizer_bits.py [--root CHECKOUT] [--rows N] [--out FILE]

Each of the port's seven absmax quantizers (``ops.matvec``:
``quantize_rows_absmax``, ``quantize_weight``, ``quantize_weight_int4``;
``ops.quant``: ``quantize_rows``, ``quantize_rows_int4``, ``int4_codes``;
``models.decoder._kv_quantize``) runs on the same ``N`` (default 10^5)
random f32 rows of 64 values on the CPU and on the card, and every scale
and code is compared bit for bit. The rows, made with numpy from seed 0:
a quarter standard normal, half scaled by 2^u with u uniform in
[-140, 120] (absmax from the subnormals to 2^123), and a quarter at the
floors: all zero, absmax exactly 1e-12, exactly 1e-6, or just above and
below them. ``quantize_weight_int4``'s equalizer ``t = amax^0.5 /
exp(mean(log))`` goes through ``log`` and ``exp``: its own mismatches are
counted apart, and its ``/ 7`` step is also held on the card's own ``t``
(the CPU's quotient of the card's ``wn``). The CPU quotients are also
compared with numpy's correctly rounded f32 division. ``--root`` imports
the port from another checkout, so that a parent and a change are counted
by one script in one call. Prints the card line, then one JSON object per
quantizer; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 64


def rows(n: int, seed: int = 0) -> np.ndarray:
    """``[n, WIDTH]`` f32 rows at every scale the quantizers meet, floors included."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, WIDTH)).astype(np.float32)
    q = n // 4
    x[q:3 * q] *= np.exp2(rng.uniform(-140, 120, (2 * q, 1))).astype(np.float32)
    floors = np.float32([0.0, 1e-12, 1e-6, np.nextafter(np.float32(1e-12), 1),
                         np.nextafter(np.float32(1e-12), 0), np.nextafter(np.float32(1e-6), 1),
                         np.nextafter(np.float32(1e-6), 0)])
    tail = x[3 * q:]
    tail /= np.abs(tail).max(axis=1, keepdims=True)
    tail *= floors[np.arange(len(tail)) % len(floors)][:, None]
    return x


def quantizers():
    """name -> (function of a [n, WIDTH] f32 tensor -> {output: tensor}, scale names)."""
    from mediquery_rag_tpu_torch.models import decoder
    from mediquery_rag_tpu_torch.ops import matvec, quant

    def weight_int4(x):
        w = matvec.quantize_weight_int4(x.T.contiguous())      # [in, out]: channels = rows
        return {"q4": w["q4"], "s": w["s"], "t": w["t"]}

    def pair(fn, transpose=False):
        """(codes, scale) of fn on the rows (as [in, out] weights if transpose)."""
        return lambda x: dict(zip(("codes", "scale"), fn(x.T.contiguous() if transpose else x)))

    return {
        "matvec.quantize_rows_absmax": (pair(matvec.quantize_rows_absmax), ("scale",)),
        "matvec.quantize_weight": (pair(matvec.quantize_weight, transpose=True), ("scale",)),
        "matvec.quantize_weight_int4": (weight_int4, ("s",)),
        "quant.quantize_rows": (pair(quant.quantize_rows), ("scale",)),
        "quant.quantize_rows_int4": (pair(quant.quantize_rows_int4), ("scale",)),
        "quant.int4_codes": (pair(quant.int4_codes), ("scale",)),
        "decoder._kv_quantize": (pair(decoder._kv_quantize), ("scale",)),
    }


def bits(t):
    import torch
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("quantizer_bits: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; root {os.path.abspath(args.root)}")
    x_np = rows(args.rows)
    x = torch.from_numpy(x_np)
    out = []
    for name, (fn, scales) in quantizers().items():
        cpu = fn(x)
        gpu = fn(x.cuda())
        torch.cuda.synchronize()
        rec = {"quantizer": name, "rows": args.rows}
        for key in cpu:
            rec[f"{key}_mismatches"] = int((bits(cpu[key]) != bits(gpu[key])).sum())
            rec[f"{key}_values"] = cpu[key].numel()
        levels = np.float32(7.0 if "int4" in name else 127.0)
        floor = np.float32(1e-6 if "kv" in name else 1e-12)

        def quotient_mismatches(got, of):
            want = np.maximum(np.abs(of).max(axis=1), floor) / levels
            return int((got.view(np.int32) != want.view(np.int32)).sum())

        if name == "matvec.quantize_weight_int4":
            # the / 7 step on the card's own t: the CPU's quotient of the card's wn
            wn = (x / gpu["t"].cpu().reshape(1, -1)).numpy()
            rec["s_given_card_t_mismatches"] = quotient_mismatches(
                gpu["s"].cpu().reshape(-1).numpy(), wn)
        else:
            # the CPU's scales against numpy's correctly rounded f32 quotient
            got = cpu[scales[0]]
            if name == "quant.quantize_rows_int4":       # planes: even rows, then odd rows
                got = got.T
            rec["cpu_vs_numpy_scale_mismatches"] = quotient_mismatches(
                got.reshape(-1)[:args.rows].numpy(), x_np)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "root": os.path.abspath(args.root), "rows": out}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
