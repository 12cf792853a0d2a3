#!/usr/bin/env python3
"""Time the 1B-class LM training step of the PyTorch port on one NVIDIA GPU.

    python3 tools/train_step_times.py [--root CHECKOUT] [--out FILE]

Runs ``chip_smoke.py``'s phase 8b (the bf16 gradient of a 2-layer model at
the 1B-class widths, on the card through the flash and einsum paths and on
the CPU, each held to f32) and 8c (``LMTrainer``: 16 layers, hidden 2048,
B=8 over the corpus, AdamW, ``remat=True``, 10 steps: ms per step, tokens/s,
MFU, busy share) from the checkout at ``--root`` (default: this one), with
that checkout's port and kernels, so that two trees are timed by one
script on one card (run parent, change, change, parent, each in its own
process). Prints the card line, then one JSON object; ``--out`` also
writes it to a file. Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.modules["jax"] = None                  # the port runs without JAX
    sys.modules["mediquery_rag_tpu"] = None
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mediquery_rag_tpu_torch.ops import _build, attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = cs.card_line()
    grad = cs.grad_parity(torch)
    counters = [attention.flash_prefill_cuda, attention.flash_dq_cuda,
                attention.flash_dkv_cuda]
    train, _, params = cs.train_lm_1b(torch, counters)
    del params
    res = {"root": root, "card": card, "grad_parity": grad, "train_1b": train}
    print(card)
    line = json.dumps(res, default=float)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
