#!/usr/bin/env python3
"""Time the four IVF scan kernels of the PyTorch port on one NVIDIA GPU.

    python3 tools/ivf_kernel_times.py [--root CHECKOUT] [--out FILE]

Builds bf16 and int8 ``IVFIndex`` over the clustered 1M x 768 unit rows of
``chip_smoke.py`` phase 3c (4,096 centers, noise 0.3, seed 2; nlist 1,024,
nprobe 32) and times B8a/B8b (query-major) and B9a/B9b (bucket-major) with
CUDA events at B = 1, 8, 64 and k = 10, 20, 40. ``--root`` imports the port
from another checkout, so that two trees can be timed by one script on one
card (run parent, change, change, parent). Prints the card line, then one
JSON object per (kernel, B, k) with its milliseconds and a checksum of the
returned ids; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("ivf_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time
    from mediquery_rag_tpu_torch.ops import ivf_kernel as ik
    from mediquery_rag_tpu_torch.ops.quant import quantize_rows
    from mediquery_rag_tpu_torch.ops.topk import exact_topk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    n, d, nprobe = 1 << 20, 768, 32
    centers = torch.randn((4096, d), generator=gen, device=dev)
    x = centers[torch.randint(0, 4096, (n,), generator=gen, device=dev)]
    x += 0.3 * torch.randn((n, d), generator=gen, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    q_all = centers[torch.randint(0, 4096, (64,), generator=gen, device=dev)]
    q_all = q_all + 0.3 * torch.randn((64, d), generator=gen, device=dev)
    q_all /= q_all.norm(dim=1, keepdim=True)
    rows = []
    for dtype in ("bfloat16", "int8"):
        ix = IVFIndex.build(x, EngineConfig(dim=d, dtype=dtype), device="cuda")
        int8 = dtype == "int8"
        sc = [ix.bucket_scales] if int8 else []
        for b in (1, 8, 64):
            q = q_all[:b].contiguous()
            pid = exact_topk(q @ ix.centroids.T, nprobe)[1].to(torch.int32).contiguous()
            qk = quantize_rows(q)[0] if int8 else q.to(torch.bfloat16)
            uniq = ik.unique_probes(pid, ix.nlist)
            for k in (10, 20, 40):
                probe = ik.ivf_probe_topk_int8_cuda if int8 else ik.ivf_probe_topk_cuda
                batch = ik.ivf_batch_topk_int8_cuda if int8 else ik.ivf_batch_topk_cuda
                calls = {
                    probe.__name__: lambda: probe(pid, qk, ix.buckets, ix.bucket_ids, *sc, k),
                    batch.__name__: lambda: batch(pid, uniq, qk, ix.buckets, ix.bucket_ids,
                                                  *sc, k)}
                for name, call in calls.items():
                    ids = call()[1]
                    row = {"kernel": name.removesuffix("_cuda"), "B": b, "k": k,
                           "ms": cuda_time(call), "ids_sum": int(ids.long().sum())}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
        del ix
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": os.path.abspath(args.root), "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
