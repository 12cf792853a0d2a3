#!/usr/bin/env python3
"""Time the attention kernels of the PyTorch port on one NVIDIA GPU: the
prefill kernel B6, the backward kernels B10a/B10b and the decode kernel B5.

    python3 tools/attention_kernel_times.py [--root CHECKOUT] [--out FILE]

Times, with CUDA events (the median of 5 windows), at the shapes
``chip_smoke.py`` holds these kernels to: B6 bf16 at B=1, S=4096, 28q/4kv,
dh 128 (100 left-pad columns); B6 int8 on the 256-query serving piece at
column 2,048 of an 8,192-column cache; B10a and B10b at S=4096, 16 MHA
heads and 28q/4kv (61 left-pad columns); B6, B10a and B10b at the
1B-class training step's shape (B=8, S=768, 16 MHA heads, dh 128, rows
right-padded to lengths 768, 700, 1, 513, 64, 129, 767, 300); B5 over an
8,192-column cache at 28q/4kv, dh 128, each lane's columns 37 + 97 * lane
.. 4,132 live: bf16 at B=1, int8 with the fresh fold at B=4, int8 with
the (m, l) outputs at B=4, G=5. B5 is timed queued behind a sleeping
kernel (a short kernel launched back to back from Python is otherwise
timed by the host), cold, rotating over copies of the cache whose bytes
pass twice the L2 between two uses of one (a decode step reads 28 layer
caches), and warm (one cache, 16 calls back to back).
Each line also carries SDPA's time for the same function (``is_causal``,
``enable_gqa``; the backward as (fwd+bwd) - fwd; for B5 over the cache,
dequantized to bf16 for int8 with the fresh column appended, timed the
same two ways), a yardstick the port never calls. ``--root`` imports the
port's kernels from another checkout (the timing helpers come from this
one), so that two trees are timed by one script on one card (run parent,
change, change, parent). ``--b5-targets 66,264`` also times B5 at other
split counts (through ``attention._DECODE_BLOCKS``, the grid
``decode_plan`` aims at). Prints the card line, then one JSON object per
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--b5-targets", default="", type=lambda t: [int(x) for x in t.split(",") if x],
                    help="also time B5 cold with attention._DECODE_BLOCKS set to each of "
                         "these block counts (comma-separated; it sets B5's split count)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("attention_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "timing", os.path.join(HERE, "mediquery_rag_tpu_torch", "obs", "metrics.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    cuda_time, cuda_time_cold, cuda_time_warm, cold_copies = (
        timing.cuda_time, timing.cuda_time_cold, timing.cuda_time_warm, timing.cold_copies)
    from mediquery_rag_tpu_torch.ops import attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; root {os.path.abspath(args.root)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def emit(name, **kw):
        rec = {"case": name, **kw}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    def attn_case(name, B, H, KH, S, mask, bwd=True):
        dh = 128
        scale = dh ** -0.5
        q, k, v = bf16(B, H, S, dh), bf16(B, KH, S, dh), bf16(B, KH, S, dh)
        off = torch.zeros((B,), dtype=torch.int32, device=dev)
        fwd = cuda_time(lambda: attention.flash_prefill_cuda(q, k, v, mask, off, scale))
        lib_f = cuda_time(lambda: sdpa(q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        rec = {"B6_ms": fwd, "sdpa_fwd_ms": lib_f}
        if bwd:
            out = attention.flash_prefill_cuda(q, k, v, mask, off, scale)
            dout = (bf16(B, H, S, dh).float() * mask[:, None, :, None]).to(torch.bfloat16)
            D = (dout.float() * out.float()).sum(-1)
            _, lse = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
            rec["B10a_ms"] = cuda_time(lambda: attention.flash_dq_cuda(q, k, v, mask, dout, D,
                                                                       scale))
            rec["B10b_ms"] = cuda_time(lambda: attention.flash_dkv_cuda(q, k, v, mask, dout,
                                                                        lse, D, scale))
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            t_fb = cuda_time(lambda: sdpa(*leaves, is_causal=True, scale=scale,
                                          enable_gqa=True).backward(dout))
            rec["sdpa_bwd_ms"] = t_fb - lib_f
        emit(name, B=B, H=H, KH=KH, S=S, **rec)
        torch.cuda.empty_cache()

    S = 4096
    mask = torch.ones((1, S), device=dev)
    mask[:, :100] = 0
    attn_case("S4096 28q/4kv", 1, 28, 4, S, mask)
    mask = torch.ones((1, S), device=dev)
    mask[:, :61] = 0
    attn_case("S4096 16 MHA", 1, 16, 16, S, mask)
    S = 768
    mask = torch.zeros((8, S), device=dev)
    for r, n in enumerate([768, 700, 1, 513, 64, 129, 767, 300]):
        mask[r, :n] = 1
    attn_case("training B=8 S=768 16 MHA", 8, 16, 16, S, mask)

    # the int8 serving piece: 256 queries at column 2048 of an 8192-column cache
    C, S, col0, H, KH, dh = 8192, 256, 2048, 28, 4, 128
    q = bf16(1, H, S, dh)
    k8 = torch.randint(-127, 128, (1, KH, C, dh), generator=gen, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (1, KH, C, dh), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((1, KH, C), generator=gen, device=dev) * 0.02
    vs = torch.rand((1, KH, C), generator=gen, device=dev) * 0.02
    km = torch.zeros((1, C), device=dev)
    km[:, 11:col0 + S] = 1
    off = torch.tensor([col0], dtype=torch.int32, device=dev)
    t = cuda_time(lambda: attention.flash_prefill_int8_cuda(q, k8, v8, ks, vs, km, off,
                                                            dh ** -0.5))
    kd = (k8.float() * ks[..., None]).to(torch.bfloat16)
    vd = (v8.float() * vs[..., None]).to(torch.bfloat16)
    vis = attention._visible(km, S, C, True, off)
    lt = cuda_time(lambda: sdpa(q, kd, vd, attn_mask=vis, scale=dh ** -0.5, enable_gqa=True))
    emit("int8 piece S=256 col0 2048 C=8192", B=1, H=H, KH=KH, S=S, B6_int8_ms=t,
         sdpa_dequantized_ms=lt)
    del q, k8, v8, ks, vs, kd, vd
    torch.cuda.empty_cache()

    # B5 over an 8192-column cache, each lane's columns 37 + 97 lane .. 4132 live
    H, KH, dh = 28, 4, 128
    scale = dh ** -0.5

    def lanes(bb):
        km = torch.zeros((bb, C), device=dev)
        for lane in range(bb):
            km[lane, 37 + 97 * lane:4133] = 1
        return km

    def int8_cache(bb):
        codes = [torch.randint(-127, 128, (bb, KH, C, dh), generator=gen, device=dev,
                               dtype=torch.int8) for _ in "kv"]
        scales = [torch.rand((bb, KH, C), generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in "kv"]
        return (*codes, *scales)

    def dequant(c8, sc):
        return (c8.float() * sc[..., None]).to(torch.bfloat16)

    def b5_case(name, kern, caches, lib, lib_caches, **meta):
        """Kernel and SDPA, each cold over its copies and warm on the first;
        with --b5-targets, the kernel cold again at each grid target."""
        rec = {}
        for label, fn, cs in (("kernel", kern, caches), ("sdpa", lib, lib_caches)):
            rec[f"{label}_cold_ms"] = cuda_time_cold([lambda c=c: fn(*c) for c in cs])
            rec[f"{label}_warm_ms"] = cuda_time_warm(lambda: fn(*cs[0]))
        for target in args.b5_targets:
            own, attention._DECODE_BLOCKS = attention._DECODE_BLOCKS, target
            rec[f"kernel_cold_ms_target{target}"] = cuda_time_cold(
                [lambda c=c: kern(*c) for c in caches])
            attention._DECODE_BLOCKS = own
        emit(name, H=H, KH=KH, copies=len(caches), **meta, **rec)

    km = lanes(1)
    nbytes = 2 * KH * int(km.sum()) * dh * 2
    qd = bf16(1, H, 1, dh)
    caches = [(bf16(1, KH, C, dh), bf16(1, KH, C, dh)) for _ in range(cold_copies(nbytes))]
    b5_case("B5 bf16 B=1 C=8192 half live",
            lambda k, v: attention.flash_decode_cuda(qd, k, v, km, scale), caches,
            lambda k, v: sdpa(qd, k, v, attn_mask=(km > 0)[:, None, None, :], scale=scale,
                              enable_gqa=True), caches, B=1, G=1, live_MB=nbytes / 1e6)
    del caches
    torch.cuda.empty_cache()

    bb = 4
    km = lanes(bb)
    nbytes = 2 * KH * int(km.sum()) * (dh + 4)
    caches = [int8_cache(bb) for _ in range(cold_copies(nbytes))]
    qd = bf16(bb, H, 1, dh)
    fresh = {"fresh_k": bf16(bb, KH, 1, dh), "fresh_v": bf16(bb, KH, 1, dh),
             "fresh_gate": torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)}
    live_f = torch.cat([km > 0, (fresh["fresh_gate"] > 0)[:, None]], dim=1)[:, None, None, :]
    deq = [(torch.cat([dequant(k8, ks), fresh["fresh_k"]], 2),
            torch.cat([dequant(v8, vs), fresh["fresh_v"]], 2)) for k8, v8, ks, vs in caches]
    b5_case("B5 int8 + fold B=4 C=8192 half live",
            lambda k8, v8, ks, vs: attention.flash_decode_int8_cuda(qd, k8, v8, ks, vs, km,
                                                                    scale, **fresh), caches,
            lambda kd, vd: sdpa(qd, kd, vd, attn_mask=live_f, scale=scale, enable_gqa=True),
            deq, B=bb, G=1, live_MB=nbytes / 1e6)
    G = 5
    qd = bf16(bb, H, G, dh)
    deq = [(dequant(k8, ks), dequant(v8, vs)) for k8, v8, ks, vs in caches]
    b5_case("B5 (m, l) int8 B=4 G=5 C=8192 half live",
            lambda k8, v8, ks, vs: attention.flash_decode_ml_cuda(qd, k8, v8, km, scale,
                                                                  k_scale=ks, v_scale=vs),
            caches, lambda kd, vd: sdpa(qd, kd, vd, attn_mask=(km > 0)[:, None, None, :],
                                        scale=scale, enable_gqa=True),
            deq, B=bb, G=G, live_MB=nbytes / 1e6)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
