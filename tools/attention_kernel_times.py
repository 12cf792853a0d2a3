#!/usr/bin/env python3
"""Time the prefill attention kernel B6 and the backward kernels B10a/B10b of
the PyTorch port on one NVIDIA GPU.

    python3 tools/attention_kernel_times.py [--root CHECKOUT] [--out FILE]

Times, with CUDA events (the median of 5 windows of 10 calls), at the shapes
``chip_smoke.py`` holds these kernels to: B6 bf16 at B=1, S=4096, 28q/4kv,
dh 128 (100 left-pad columns); B6 int8 on the 256-query serving piece at
column 2,048 of an 8,192-column cache; B10a and B10b at S=4096, 16 MHA
heads and 28q/4kv (61 left-pad columns); and B6, B10a and B10b at the
1B-class training step's shape (B=8, S=768, 16 MHA heads, dh 128, rows
right-padded to lengths 768, 700, 1, 513, 64, 129, 767, 300). Each line
also carries SDPA's time for the same function (``is_causal``,
``enable_gqa``; the backward as (fwd+bwd) - fwd), a yardstick the port
never calls. ``--root`` imports the port from another checkout, so that two
trees are timed by one script on one card (run parent, change, change,
parent). Prints the card line, then one JSON object per case; ``--out``
also writes them to a file.
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
        print("attention_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time
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
        rec = {"case": name, **{k: round(v, 4) if isinstance(v, float) else v
                                for k, v in kw.items()}}
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
