#!/usr/bin/env python3
"""Time the int4 decode matvec B7 and the flat scans B1 (bf16, f32), B2
(int8) and B3 (int4) of the PyTorch port on one NVIDIA GPU.

    python3 tools/matvec_scan_kernel_times.py [--root CHECKOUT] [--out FILE]
        [--kernels all|scans]

B7 (``matvec.matvec_int4_cuda``) at every projection of the 7B-class
decoder (Qwen2.5-7B widths: qkv 3584 -> 4608, attn_out 3584 -> 3584,
w_gate and w_up 3584 -> 18944, w_down 18944 -> 3584, lm_head 3584 -> 384
over the byte vocabulary) at 1, 4, 8, 20 (the B=4, gamma=4 verify pass)
and 128 rows (a short prefill), cold: queued behind a sleeping kernel and
rotating over copies of the packed weights and scales whose bytes pass
twice the L2 between two uses of one (``obs.metrics.cuda_time_cold``), as
28 layers do in a decode step; then B7's sum over one 28-layer step at
each row count (``--kernels scans`` leaves B7 out). The scans over the
same 1M x 768 unit rows (bf16, f32, int8, row-pair-packed int4) at B=64,
k=10 and 40, and at B=1 and 128, k=10, with CUDA events over back-to-back
calls (each corpus passes the L2 on every call): B1 bf16 and f32
(``scoring.flat_topk_cuda`` / ``flat_topk_f32_cuda``), B3
(``quant.int4_topk_cuda``) and B2 (``quant.int8_topk_cuda``, not changed
since its redesign: a control of the card's state between trees). Each
line has the bound (the larger of the bytes over 3.35 TB/s and the
operations over the peak for their type: 989 TFLOP/s bf16, 67 TFLOP/s f32
on the CUDA cores, 1,979 TOP/s int8) and the kernel's share of it; where
the tree's wrapper takes ``stats``, one more call counts the share of
scores that pass the in-register filter and the merge rounds per block.
``--root`` imports the
port's kernels from another checkout (the timing helpers come from this
one), so that two trees are timed by one script on one card (run parent,
change, change, parent). Prints the card line, then one JSON object per
case; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BPS = 3.35e12          # H100 SXM device memory
# H100 SXM dense peaks: tensor cores (bf16, int8), CUDA cores (f32)
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PROJECTIONS = {"qkv": (3584, 4608), "attn_out": (3584, 3584), "w_gate": (3584, 18944),
               "w_up": (3584, 18944), "w_down": (18944, 3584), "lm_head": (3584, 384)}
ROWS = (1, 4, 8, 20, 128)
LAYERS = 28


def bound_ms(nbytes: float, ops: float, kind: str = "int8") -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", choices=("all", "scans"), default="all")
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
    from mediquery_rag_tpu_torch.ops import matvec, quant, scoring

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
    for name, (d, f) in PROJECTIONS.items() if args.kernels == "all" else ():
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
    for b in ROWS if args.kernels == "all" else ():
        step = LAYERS * sum(b7[n, b] for n in PROJECTIONS if n != "lm_head") + b7["lm_head", b]
        emit(f"B7 28-layer step rows={b}", kernel="matvec_int4", rows=b, step_ms=step,
             launches=LAYERS * 5 + 1)

    n, d = 1 << 20, 768
    x = torch.randn((n, d), generator=gen, device=dev)
    x /= x.norm(dim=-1, keepdim=True)
    corpora = {"B1 bf16": x.to(torch.bfloat16), "B1 f32": x, "B2": quant.quantize_rows(x),
               "B3": quant.quantize_rows_int4(x)}
    del x
    torch.backends.cuda.matmul.allow_tf32 = False
    # name -> (kernel, (bytes, ops, peak) of one call at (b, k), argument builder)
    scans = {
        "B1 bf16": (scoring.flat_topk_cuda,
                    lambda b, k: (n * d * 2 + b * d * 2 + b * k * 8, 2 * b * n * d, "bf16")),
        "B1 f32": (scoring.flat_topk_f32_cuda,
                   lambda b, k: (n * d * 4 + b * d * 4 + b * k * 8, 2 * b * n * d, "f32")),
        "B3": (quant.int4_topk_cuda,
               lambda b, k: (n * d // 2 + n * 4 + b * d + b * 4 + b * k * 8, 2 * b * n * d,
                             "int8")),
        "B2": (quant.int8_topk_cuda,
               lambda b, k: (n * d + n * 4 + b * d + b * k * 8, 2 * b * n * d, "int8")),
    }
    for b, k in ((64, 10), (64, 40), (1, 10), (128, 10)):
        q = torch.randn((b, d), generator=gen, device=dev)
        q /= q.norm(dim=-1, keepdim=True)
        q8, _ = quant.quantize_rows(q)
        corr = (8 * q8.to(torch.int32).sum(dim=1)).float()
        inputs = {"B1 bf16": (q.to(torch.bfloat16), corpora["B1 bf16"]),
                  "B1 f32": (q, corpora["B1 f32"]), "B2": (q8, *corpora["B2"]),
                  "B3": (q8, corr, *corpora["B3"])}
        for name, (kern, work) in scans.items():
            a = inputs[name]
            ms = timing.cuda_time(lambda: kern(*a, k, n))
            nbytes, ops, kind = work(b, k)
            bms, by = bound_ms(nbytes, ops, kind)
            rec = dict(kernel=kern.__name__.removesuffix("_cuda"), B=b, k=k, ms=ms,
                       bound_ms=bms, bound_by=by, share=bms / ms)
            if "stats" in inspect.signature(kern).parameters:
                stats = torch.zeros(2, dtype=torch.int32, device=dev)
                kern(*a, k, n, stats=stats)
                plan = (quant.int4_scan_plan(-(-b // 16) * 16, d, n // 2, k) if name == "B3"
                        else quant.int8_scan_plan(-(-b // 16) * 16, d, n, k) if name == "B2"
                        else scoring.flat_scan_plan(-(-b // 16) * 16, d, n, k, a[1].dtype))
                rec.update(survivors_share=stats[0].item() / (b * n),
                           merges_per_block=stats[1].item() / (plan.ranges * plan.groups))
            emit(f"{name} 1Mx768 B={b} k={k}", **rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows_out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
