#!/usr/bin/env python3
"""Tensor-parallel generation with the port: lockstep ``Generator.generate``
or an ``LLMServer`` on model rank 0 with the other ranks following.

    python3 tools/tp_generate.py [--tp 2] [--device cpu|cuda|cuda:0]
                                 [--checkpoint DIR | --layers N] [--bits 0|4|8]
                                 [--kv int8] [--serve] [--max-new 32] [PROMPT ...]

Spawns ``--tp`` ranks (``parallel.dist.launch``): ``--device cpu`` runs gloo
on the CPU, ``cuda`` puts rank r on ``cuda:r`` over NCCL, ``cuda:0`` puts
every rank on one card over gloo. Each rank builds the generator from a
``Generator.save`` checkpoint (``--checkpoint``) or from seed 0 at the
Qwen2.5-7B widths with ``--layers`` layers (``init_params(bits=)``:
quantized layer by layer), keeps its Megatron shard, and generates; rank 0
prints the replies. With ``--serve`` rank 0 serves the prompts through
``LLMServer`` (submitted at once) and the others ``follow()`` it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(mesh, args) -> list[str] | None:
    """One rank: build the generator over ``mesh`` and generate or serve."""
    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.serve.llm import LLMServer

    if args.checkpoint:
        gen = Generator.from_checkpoint(args.checkpoint, mesh=mesh)
        if args.bits:
            gen.quantize_weights(args.bits)
    else:
        cfg = DecoderConfig(vocab_size=384, hidden=3584, layers=args.layers, heads=28,
                            kv_heads=4, mlp_dim=18944, max_len=8192, rope_theta=1e6,
                            qkv_bias=True, kv_dtype=args.kv,
                            attn_impl="flash" if mesh.device.type == "cuda" else "einsum")
        if mesh.device.type == "cpu":
            cfg = dataclasses.replace(cfg, hidden=256, heads=4, kv_heads=2, mlp_dim=512,
                                      dtype="float32")
        gen = Generator(cfg, init_params(cfg, seed=0, device=mesh.device, bits=args.bits or None),
                        mesh=mesh)
    if not args.serve:
        return gen.generate(args.prompts, max_new_tokens=args.max_new)
    srv = LLMServer(gen, slots=4, chunk=8)
    if mesh.model_rank:
        srv.follow()
        return None
    try:
        return srv.complete_batch(args.prompts, max_new_tokens=args.max_new, timeout=1800)
    finally:
        srv.close()


def main() -> int:
    from mediquery_rag_tpu_torch.parallel.dist import launch

    ap = argparse.ArgumentParser()
    ap.add_argument("prompts", nargs="*", default=["高血压患者平时饮食需要注意什么？", "头痛怎么办"])
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--bits", type=int, default=4, choices=(0, 4, 8))
    ap.add_argument("--kv", default="int8", choices=("", "int8"))
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args()
    replies = launch(run, 1, args.tp, args, device=args.device, timeout=3600)[0]
    for prompt, reply in zip(args.prompts, replies):
        print(f"{prompt!r} -> {reply!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
