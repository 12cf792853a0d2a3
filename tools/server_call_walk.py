#!/usr/bin/env python3
"""Walk the speculative server's decoder calls in both packages, on the CPU.

    XLA_FLAGS=--xla_allow_excess_precision=false \
        python3 tools/server_call_walk.py [--weights int4|float] [--kv int8|float]
                                          [--jax-sum] [--seed 0] [--bytes 300,500]

Serves greedy requests (prompts of ``--bytes`` bytes of the corpus, 32
tokens each) through ``LLMServer(draft=the same generator, gamma=4)`` at f32
activations with einsum attention, the model of
``tools/self_draft_acceptance.py`` (3 layers, hidden 256, 4/2 heads, MLP
512, q/k/v bias), in the port and in the JAX package on the same weights.
With the default two requests the second (500 bytes) lands in 256-token
prefill pieces while speculative rounds run for the first.

Every decoder call either server makes is recorded (``prefill``,
``prefill_extend``, ``extend_slots``, ``decode_step_slots``: inputs and
logits; JAX's through ordered debug callbacks inside its jitted programs)
and the two sequences are compared call by call. Printed: the replies, then
each call whose inputs differ or whose logits differ by more than 1e-5
(the schedule is the order of calls and their inputs: tokens, live lanes,
cursors, positions, key masks). JAX runs a lane to the end of its quantum
where the port stops it at its budget, so past the first quantum's end the
two call orders part by design.

``--jax-sum`` makes the port's dequantized int4 product (past 128 rows)
call JAX's ``_mm`` on the same operands, so that site sums in JAX's order.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("prefill", "prefill_extend", "extend_slots", "decode_step_slots")


def record_port(model, rec: list) -> None:
    """Wrap ``model``'s serving methods to append (name, inputs, logits)."""
    orig = {k: getattr(model, k) for k in METHODS}

    def prefill(ids, mask, C):
        lg, kv = orig["prefill"](ids, mask, C)
        rec.append(("prefill", {"ids": np.asarray(ids)}, lg.numpy().copy()))
        return lg, kv

    def prefill_extend(k, v, km, ids, mask, col0, pos0, all_logits=False, **kw):
        out = orig["prefill_extend"](k, v, km, ids, mask, col0, pos0, all_logits=all_logits, **kw)
        rec.append(("prefill_extend", {"ids": np.asarray(ids), "col0": int(col0),
                                       "pos0": int(pos0), "km": out[3].numpy().copy()},
                    out[0].numpy().copy()))
        return out

    def extend_slots(cache, toks, active):
        inp = {"toks": toks.numpy().copy(), "active": active.numpy().copy(),
               "cursor": cache.cursor.numpy().copy(), "next_pos": cache.next_pos.numpy().copy(),
               "km": cache.key_mask.numpy().copy()}
        lg = orig["extend_slots"](cache, toks, active)
        rec.append(("extend_slots", inp, lg.numpy().copy()))
        return lg

    def decode_step_slots(cache, tok, active):
        inp = {"tok": tok.numpy().copy(), "active": active.numpy().copy(),
               "cursor": cache.cursor.numpy().copy()}
        lg = orig["decode_step_slots"](cache, tok, active)
        rec.append(("decode_step_slots", inp, lg.numpy().copy()))
        return lg

    model.prefill, model.prefill_extend = prefill, prefill_extend
    model.extend_slots, model.decode_step_slots = extend_slots, decode_step_slots


def record_jax(model, rec: list) -> None:
    """The same for the JAX decoder, inside its jitted programs."""
    import jax

    orig = {k: getattr(model, k) for k in METHODS}

    def cb(name):
        return lambda *a: rec.append((name, [np.asarray(x) for x in a]))

    def prefill(p, ids, mask, C):
        lg, kv = orig["prefill"](p, ids, mask, C)
        jax.debug.callback(cb("prefill"), ids, lg, ordered=True)
        return lg, kv

    def prefill_extend(p, k, v, km, ids, mask, col0, pos0, all_logits=False, **kw):
        out = orig["prefill_extend"](p, k, v, km, ids, mask, col0, pos0,
                                     all_logits=all_logits, **kw)
        jax.debug.callback(cb("prefill_extend"), ids, col0, pos0, out[3], out[0], ordered=True)
        return out

    def extend_slots(p, cache, toks, active):
        lg, kv = orig["extend_slots"](p, cache, toks, active)
        jax.debug.callback(cb("extend_slots"), toks, active, cache.cursor, cache.next_pos,
                           cache.key_mask, lg, ordered=True)
        return lg, kv

    def decode_step_slots(p, cache, tok, active):
        lg, kv = orig["decode_step_slots"](p, cache, tok, active)
        jax.debug.callback(cb("decode_step_slots"), tok, active, cache.cursor, lg, ordered=True)
        return lg, kv

    model.prefill, model.prefill_extend = prefill, prefill_extend
    model.extend_slots, model.decode_step_slots = extend_slots, decode_step_slots


def compare(port: list, jax_rec: list, tol: float = 1e-5) -> list[str]:
    """One line per call whose inputs differ or whose logits part by more
    than ``tol``; stops at the first call where the two orders differ."""
    lines = []
    for i, ((name, inp, lg), (jname, ja)) in enumerate(zip(port, jax_rec)):
        if name != jname:
            lines.append(f"{i} call order parts: port {name}, JAX {jname}")
            break
        if name == "prefill":
            same, jl, note = np.array_equal(inp["ids"], ja[0]), ja[1], ""
        elif name == "prefill_extend":
            same = (np.array_equal(inp["ids"], ja[0]) and inp["col0"] == int(ja[1])
                    and inp["pos0"] == int(ja[2]) and np.array_equal(inp["km"], ja[3]))
            jl, note = ja[4], f"col0={inp['col0']} rows={inp['ids'].shape[0]}"
        elif name == "extend_slots":
            same = all(np.array_equal(inp[k], a) for k, a in
                       zip(("toks", "active", "cursor", "next_pos", "km"), ja[:5]))
            live = inp["active"]
            jl = ja[5]
            note = (f"G={inp['toks'].shape[1]} live={live.astype(int).tolist()} "
                    f"cursor={inp['cursor'].tolist()}")
            lg, jl = lg[live], jl[live]
        else:
            same = all(np.array_equal(inp[k], a) for k, a in
                       zip(("tok", "active", "cursor"), ja[:3]))
            jl, note = ja[3], ""
        d = float(np.abs(lg - jl).max()) if lg.size else 0.0
        if same and d <= tol:
            continue
        lines.append(f"{i} {name} inputs {'equal' if same else 'DIFFER'} "
                     f"max|logit diff|={d:.3g} {note}")
        if not same:
            break
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="int4", choices=("int4", "float"))
    ap.add_argument("--kv", default="int8", choices=("int8", "float"))
    ap.add_argument("--jax-sum", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bytes", default="300,500")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from mediquery_rag_tpu.models.decoder import _mm as jax_mm
    from mediquery_rag_tpu.serve import llm as jllm
    from mediquery_rag_tpu_torch.config import DecoderConfig
    from mediquery_rag_tpu_torch.models import decoder
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.serve.llm import LLMServer

    spec = importlib.util.spec_from_file_location(
        "self_draft_acceptance", os.path.join(ROOT, "tools", "self_draft_acceptance.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    torch.set_num_threads(4)
    raw = open(os.path.join(ROOT, "data", "medical_data.txt"), encoding="utf-8").read().encode()
    prompts = [raw[:int(n)].decode("utf-8", errors="ignore") for n in args.bytes.split(",")]
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=3, heads=4, kv_heads=2, mlp_dim=512,
                        max_len=2048, qkv_bias=True, dtype="float32",
                        kv_dtype="int8" if args.kv == "int8" else "", attn_impl="einsum")
    params = decoder.init_params(cfg, seed=args.seed, device="cpu",
                                 bits=4 if args.weights == "int4" else None)
    gen = Generator(cfg, params, device="cpu")

    forward = decoder.QLinear.forward

    def jax_sum(self, x, adt, layer=None, weight=None):
        if self.form != "int4" or x.numel() // x.shape[-1] <= decoder.MATVEC_MAX_ROWS:
            return forward(self, x, adt, layer, weight)
        w = {k: jnp.asarray(v.numpy()) for k, v in self._int4(None).items()}
        return torch.from_numpy(np.array(jax_mm(jnp.asarray(x.float().numpy()), w,
                                                jnp.float32, layer=layer)))

    port_rec: list = []
    record_port(gen.model, port_rec)
    if args.jax_sum:
        decoder.QLinear.forward = jax_sum
    try:
        port = tool.serve_port(gen, prompts, LLMServer)
    finally:
        decoder.QLinear.forward = forward

    jax_rec: list = []
    server = jllm.LLMServer

    class Recorded(server):
        def __init__(self, g, **kw):
            record_jax(g.model, jax_rec)
            super().__init__(g, **kw)

    jllm.LLMServer = Recorded
    try:
        want = tool.serve_jax(cfg, params, prompts)
    finally:
        jllm.LLMServer = server
    jax.effects_barrier()
    print(f"weights={args.weights} kv={args.kv} jax_sum={args.jax_sum} seed={args.seed}")
    for k, (a, b) in enumerate(zip(port["texts"], want["texts"])):
        print(f"request {k}: equal={a == b} first_diff={tool.first_diff(a, b)} "
              f"port={a!r} jax={b!r}")
    print(f"calls: port {len(port_rec)}, JAX {len(jax_rec)}")
    for line in compare(port_rec, jax_rec):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
