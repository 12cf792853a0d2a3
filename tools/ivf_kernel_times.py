#!/usr/bin/env python3
"""Time the eight IVF scan kernels of the PyTorch port on one NVIDIA GPU.

    python3 tools/ivf_kernel_times.py [--root CHECKOUT] [--out FILE]
                                      [--dtypes int8,int4] [--qb-cap 64]

Builds bf16, f32, int8 and int4 ``IVFIndex`` over the clustered 1M x 768
unit rows of ``chip_smoke.py`` phase 3c (4,096 centers, noise 0.3, seed 2;
nlist 1,024, nprobe 32), one at a time, and times B8a/B8a f32/B8b/B8c
(query-major) and B9a/B9a f32/B9b/B9c (bucket-major) with CUDA events at
B = 1, 8, 64, 256 and k = 10, 40: ``ms``, back-to-back calls
(``obs.metrics.cuda_time``: the wrapper's own device work included, and its
host time where that is the longer), and ``queued_ms``, the calls queued
behind a sleeping kernel (``obs.metrics.cuda_time_warm``: device time
alone, L2 warm). Both on the index's own
tensors as ``IVFIndex.search`` hands them over (its live extent to every
wrapper of the checkout that takes one). After each build, whose host-side layout leaves the card
idle, half a second of matrix products brings its clocks back up before the
first timing. ``--root`` imports the port from another checkout, so
that two trees can be timed by one script on one card (run parent, change,
change, parent). ``--dtypes`` times only the indexes of those storage
types; ``--qb-cap`` caps the probers of a bucket-major chunk (the plan's
``_QB_MAX`` of a checkout that has one), to time a kind's largest chunk
against two smaller ones. Prints the card line, then one JSON object per (kernel,
B, k) with its milliseconds and a checksum of the returned ids, then one per
Hopper IVF scan instance with ptxas's registers and spill bytes (from the
build log of ``csrc/ivf_topk.cu``) and ptxas's performance advisories
(C75xx); ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys
import time


def calls(ik, ix, q, pid, k):
    """(name, call) of the index's query-major and bucket-major kernels."""
    import torch
    from mediquery_rag_tpu_torch.ops.quant import quantize_rows

    bk, ids, sc = ix.buckets, ix.bucket_ids, ix.bucket_scales
    uniq = ik.unique_probes(pid, ix.nlist)

    def extent_kw(fn):
        """The index's extent for a wrapper that takes one (an older
        checkout's int8/int4 wrappers do not)."""
        return {"extent": ix.extent} if "extent" in inspect.signature(fn).parameters else {}

    if ix.cfg.dtype == "int4":
        q8, corr, _ = ik.int4_query(q)
        kw = extent_kw(ik.ivf_probe_topk_int4_cuda)
        bkw = extent_kw(ik.ivf_batch_topk_int4_cuda)
        return [("ivf_probe_topk_int4", lambda: ik.ivf_probe_topk_int4_cuda(
                    pid, q8, corr, bk, ids, sc, k, **kw)),
                ("ivf_batch_topk_int4", lambda: ik.ivf_batch_topk_int4_cuda(
                    pid, uniq, q8, corr, bk, ids, sc, k, **bkw))]
    if ix.cfg.dtype == "int8":
        q8 = quantize_rows(q)[0]
        kw = extent_kw(ik.ivf_probe_topk_int8_cuda)
        bkw = extent_kw(ik.ivf_batch_topk_int8_cuda)
        return [("ivf_probe_topk_int8", lambda: ik.ivf_probe_topk_int8_cuda(
                    pid, q8, bk, ids, sc, k, **kw)),
                ("ivf_batch_topk_int8", lambda: ik.ivf_batch_topk_int8_cuda(
                    pid, uniq, q8, bk, ids, sc, k, **bkw))]
    f32 = bk.dtype == torch.float32
    qk = q.to(bk.dtype)
    kw = extent_kw(ik.ivf_probe_topk_cuda)
    probe = ik.ivf_probe_topk_f32_cuda if f32 else ik.ivf_probe_topk_cuda
    batch = ik.ivf_batch_topk_f32_cuda if f32 else ik.ivf_batch_topk_cuda
    suffix = "_f32" if f32 else ""
    return [("ivf_probe_topk" + suffix, lambda: probe(pid, qk, bk, ids, k, **kw)),
            ("ivf_batch_topk" + suffix, lambda: batch(pid, uniq, qk, bk, ids, k, **kw))]


def ptxas_rows(log_path: str) -> list:
    """Registers and spill bytes of each IVF scan instance (``ivf_scan_kernel``)
    from nvcc's ``-Xptxas -v`` output, and ptxas's C75xx advisories."""
    kernels, notes, name = {}, [], None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
            if m:
                name = m.group(1)
            row = kernels.setdefault(name, {"ptxas": name}) if name else {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                row.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m.group(1))
            if re.search(r"C75\d\d", line):
                notes.append({"ptxas_advisory": line.strip()})
    return [r for n, r in kernels.items() if "ivf_scan_kernel" in n] + notes


def busy(torch, seconds: float = 0.5) -> None:
    """Keep the card busy for ``seconds`` (its clocks up)."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            a = a @ a
            a /= a.norm()
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtypes", default="bfloat16,float32,int8,int4")
    ap.add_argument("--qb-cap", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("ivf_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time, cuda_time_warm
    from mediquery_rag_tpu_torch.ops import ivf_kernel as ik
    from mediquery_rag_tpu_torch.ops.topk import exact_topk

    if args.qb_cap:
        ik._QB_MAX = {kind: min(qb, args.qb_cap) for kind, qb in ik._QB_MAX.items()}
        ik.ivf_scan_plan.cache_clear()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    n, d, nprobe = 1 << 20, 768, 32
    centers = torch.randn((4096, d), generator=gen, device=dev)
    x = centers[torch.randint(0, 4096, (n,), generator=gen, device=dev)]
    x += 0.3 * torch.randn((n, d), generator=gen, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    q_all = centers[torch.randint(0, 4096, (256,), generator=gen, device=dev)]
    q_all = q_all + 0.3 * torch.randn((256, d), generator=gen, device=dev)
    q_all /= q_all.norm(dim=1, keepdim=True)
    rows = []
    for dtype in args.dtypes.split(","):
        ix = IVFIndex.build(x, EngineConfig(dim=d, dtype=dtype), device="cuda")
        busy(torch)
        for b in (1, 8, 64, 256):
            q = q_all[:b].contiguous()
            pid = exact_topk(q @ ix.centroids.T, nprobe)[1].to(torch.int32).contiguous()
            for k in (10, 40):
                for name, call in calls(ik, ix, q, pid, k):
                    ids = call()[1]
                    row = {"kernel": name, "B": b, "k": k, "ms": cuda_time(call),
                           "queued_ms": cuda_time_warm(call), "ids_sum": int(ids.long().sum())}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
        del ix
        torch.cuda.empty_cache()
    from mediquery_rag_tpu_torch.ops import _build
    for row in ptxas_rows(os.path.join(_build.BUILD_DIR, "ivf_topk.log")):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": os.path.abspath(args.root),
                       "qb_cap": args.qb_cap, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
