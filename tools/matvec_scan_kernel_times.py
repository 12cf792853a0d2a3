#!/usr/bin/env python3
"""Time the int4 decode matvec B7 and the int8 flat scan B2 of the PyTorch
port on one NVIDIA GPU.

    python3 tools/matvec_scan_kernel_times.py [--root CHECKOUT] [--out FILE]

B7 (``matvec.matvec_int4_cuda``) at every projection of the 7B-class
decoder (Qwen2.5-7B widths: qkv 3584 -> 4608, attn_out 3584 -> 3584,
w_gate and w_up 3584 -> 18944, w_down 18944 -> 3584, lm_head 3584 -> 384
over the byte vocabulary) at 1, 4, 8, 20 (the B=4, gamma=4 verify pass)
and 128 rows (a short prefill), cold: queued behind a sleeping kernel and
rotating over copies of the packed weights and scales whose bytes pass
twice the L2 between two uses of one (``obs.metrics.cuda_time_cold``), as
28 layers do in a decode step; then B7's sum over one 28-layer step at
each row count. B2 (``quant.int8_topk_cuda``) over 1M x 768 int8 unit
rows at B=64, k=10 and 40, and at B=1 and 128, k=10, with CUDA events over
back-to-back calls (its 768 MB corpus passes the L2 on every call); B3
(``quant.int4_topk_cuda``, not changed by the B2/B7 redesign) at B=64,
k=10 as a control of the card's state between trees. Each line has the
bound (the larger of the bytes over 3.35 TB/s and the int8 operations
over 1,979 TOP/s) and the kernel's share of it. ``--root`` imports the
port's kernels from another checkout (the timing helpers come from this
one), so that two trees are timed by one script on one card (run parent,
change, change, parent). Prints the card line, then one JSON object per
case; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BPS = 3.35e12          # H100 SXM device memory
INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak
PROJECTIONS = {"qkv": (3584, 4608), "attn_out": (3584, 3584), "w_gate": (3584, 18944),
               "w_up": (3584, 18944), "w_down": (18944, 3584), "lm_head": (3584, 384)}
ROWS = (1, 4, 8, 20, 128)
LAYERS = 28


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("matvec_scan_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "timing", os.path.join(HERE, "mediquery_rag_tpu_torch", "obs", "metrics.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    from mediquery_rag_tpu_torch.ops import matvec, quant

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; root {os.path.abspath(args.root)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    rows_out = []

    def emit(name, **kw):
        rec = {"case": name, **kw}
        rows_out.append(rec)
        print(json.dumps(rec), flush=True)

    b7 = {}
    for name, (d, f) in PROJECTIONS.items():
        f2 = f // 2
        wbytes = f2 * d + f * 4
        copies = [(torch.randint(-128, 128, (f2, d), generator=gen, device=dev,
                                 dtype=torch.int8),
                   torch.rand((2, f2), generator=gen, device=dev) * 1e-3)
                  for _ in range(timing.cold_copies(wbytes))]
        for b in ROWS:
            x8 = torch.randint(-127, 128, (b, d), generator=gen, device=dev, dtype=torch.int8)
            corr = 8.0 * x8.to(torch.int32).sum(dim=-1, keepdim=True).float()
            ms = timing.cuda_time_cold([
                lambda q4=q4, s2=s2: matvec.matvec_int4_cuda(x8, corr, q4, s2)
                for q4, s2 in copies])
            bms, by = bound_ms(wbytes + b * d + b * 4 + b * f * 4, 4 * b * f2 * d)
            b7[name, b] = ms
            emit(f"B7 {name} rows={b}", kernel="matvec_int4", F=f, D=d, rows=b,
                 copies=len(copies), cold_ms=ms, bound_ms=bms, bound_by=by, share=bms / ms)
        del copies
        torch.cuda.empty_cache()
    for b in ROWS:
        step = LAYERS * sum(b7[n, b] for n in PROJECTIONS if n != "lm_head") + b7["lm_head", b]
        emit(f"B7 28-layer step rows={b}", kernel="matvec_int4", rows=b, step_ms=step,
             launches=LAYERS * 5 + 1)

    n, d = 1 << 20, 768
    x = torch.randn((n, d), generator=gen, device=dev)
    x /= x.norm(dim=-1, keepdim=True)
    c8, s8 = quant.quantize_rows(x)
    c4, s4 = quant.quantize_rows_int4(x)
    del x
    torch.cuda.empty_cache()
    for b, k in ((64, 10), (64, 40), (1, 10), (128, 10)):
        q = torch.randn((b, d), generator=gen, device=dev)
        q8, _ = quant.quantize_rows(q / q.norm(dim=-1, keepdim=True))
        ms = timing.cuda_time(lambda: quant.int8_topk_cuda(q8, c8, s8, k, n))
        bms, by = bound_ms(n * d + n * 4 + b * d + b * k * 8, 2 * b * n * d)
        emit(f"B2 1Mx768 B={b} k={k}", kernel="int8_topk", B=b, k=k, ms=ms, bound_ms=bms,
             bound_by=by, share=bms / ms)
        if (b, k) == (64, 10):
            corr = (8 * q8.to(torch.int32).sum(dim=1)).float()
            ms = timing.cuda_time(lambda: quant.int4_topk_cuda(q8, corr, c4, s4, k, n))
            bms, by = bound_ms(n * d // 2 + n * 4 + b * d + b * 4 + b * k * 8, 2 * b * n * d)
            emit(f"B3 1Mx768 B={b} k={k} (control)", kernel="int4_topk", B=b, k=k, ms=ms,
                 bound_ms=bms, bound_by=by, share=bms / ms)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows_out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
