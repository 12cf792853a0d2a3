"""Generation runs for ``tests/test_torch_tp_generate.py``: each runs one
serving path of the port over a tensor-parallel mesh (a rank of
``parallel.dist.launch``) or over one process (``mesh=None``) and returns
numpy results. A module of its own, importing neither jax nor the JAX
package, so the spawned ranks import only the port."""

import functools
import os
import time

import numpy as np
import torch

from mediquery_rag_tpu_torch.models import decoder
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.models.generate import Generator
from mediquery_rag_tpu_torch.models.speculative import SpeculativeGenerator
from mediquery_rag_tpu_torch.ops.matvec import (
    quant_matvec, quant_matvec_int4, quantize_weight, quantize_weight_int4)
from mediquery_rag_tpu_torch.parallel import collectives as cc
from mediquery_rag_tpu_torch.parallel.dist import contiguous_parts, tree_get, tree_paths
from mediquery_rag_tpu_torch.serve.llm import LLMServer


def _numpy(tree: dict) -> dict:
    return {p: tree_get(tree, p).detach().numpy().copy() for p in tree_paths(tree)}


def _gen(mesh, case: dict) -> Generator:
    gen = Generator(case["cfg"], params_from_jax(case["params"], device="cpu"), mesh=mesh,
                    device="cpu")
    return gen.quantize_weights(case["bits"]) if case.get("bits") else gen


def run_generate(mesh, case: dict) -> dict:
    gen = _gen(mesh, case)
    constraint = None
    if case.get("schema"):
        from mediquery_rag_tpu_torch.models import constrain
        constraint = constrain.JsonConstraint.compile(
            getattr(constrain, case["schema"]), gen.tokenizer, vocab_size=gen.cfg.vocab_size)
    texts = gen.generate(case["prompts"], max_new_tokens=case["max_new"],
                         temperature=case.get("temperature", 0.0), seed=3,
                         constraint=constraint)
    return {"texts": texts, "pick_mismatches": gen.pick_mismatches}


def run_steps(mesh, case: dict) -> dict:
    """Greedy decode of one prompt step by step: the tokens and each step's
    logits (the bf16 near-tie rule holds them to JAX's on the same tokens)."""
    gen = _gen(mesh, case)
    ids, mask = gen.tokenizer.batch_encode([case["prompt"]])
    logits, cache = gen.model.prefill(torch.from_numpy(ids), torch.from_numpy(mask),
                                      ids.shape[1] + 128)
    toks, rows = [], []
    for _ in range(case["steps"]):
        rows.append(logits.float().numpy()[0].copy())
        tok = gen.share_pick(torch.argmax(logits, dim=-1), True)
        toks.append(int(tok[0]))
        logits = gen.model.decode_step(cache, tok)
    return {"ids": ids, "mask": mask, "tokens": toks, "logits": np.stack(rows),
            "pick_mismatches": gen.pick_mismatches}


def run_layout(mesh, case: dict) -> dict:
    """This rank's cut of a whole quantized tree, and the tree ``gather``
    rebuilds from every rank's cut."""
    full = params_from_jax(case["params"], device="cpu")
    layout = decoder.decoder_layout(case["cfg"], full, mesh)
    local = layout.shard(full)
    back = layout.gather(local)
    return {"local": _numpy(local),
            "gathered_equal": {"/".join(p): bool(torch.equal(tree_get(back, p),
                                                             tree_get(full, p)))
                               for p in tree_paths(full)}}


def run_rowpar(mesh, case: dict) -> dict:
    """A row-parallel product over the ranks: each holds its slice of the
    input dim of ``x`` and of the weight, quantized whole first; the partial
    products are summed over "model". With the group the activation scales
    are maxed over the ranks; ``local`` takes each rank's own absmax."""
    x = torch.from_numpy(case["x"])
    w = torch.from_numpy(case["w"])
    tp, rank, group = (1, 0, None) if mesh is None else (mesh.tp, mesh.model_rank,
                                                         mesh.model_group)
    idx = contiguous_parts(w.shape[0], tp)[rank]
    out = {}
    for name, g in (("group", group), ("local", None)):
        row_max = None if g is None else functools.partial(cc.all_reduce_max, group=g)
        if case["bits"] == 8:
            q, s = quantize_weight(w)
            part = quant_matvec(x[:, idx], q[:, idx].contiguous(), s, row_max=row_max)
        else:
            wq = quantize_weight_int4(w)
            local = {"q4": wq["q4"][:, idx].contiguous(), "s": wq["s"],
                     "t": wq["t"][:, idx].contiguous()}
            part = quant_matvec_int4(x[:, idx], local, row_max=row_max)
        out[name] = cc.all_reduce(part, group).numpy()
    return out


def run_methods(mesh, case: dict) -> dict:
    """The slot methods over the rank's shard (or whole): 4 lanes filled by
    ``prefill_extend``, a ``decode_step_slots`` step and a 5-token
    ``extend_slots`` with lane 2 inactive, then a 7-token ``prefill_extend``
    on lane 0 with all its logits."""
    gen = _gen(mesh, case)
    dec = gen.model
    B, C = 4, 256
    g = torch.Generator().manual_seed(0)
    cache = dec.empty_cache(B, C)
    out = {"fill": []}

    def scales(b):
        return ({} if cache.k_scale is None else
                {"k_scale_row": cache.k_scale[:, b], "v_scale_row": cache.v_scale[:, b]})

    for b in range(B):
        n = 40 + 37 * b          # lane 3 runs 151 rows: the dequantized product
        lg, *_ = dec.prefill_extend(cache.k[:, b], cache.v[:, b], cache.key_mask[b],
                                    torch.randint(3, 259, (n,), generator=g), torch.ones(n),
                                    0, 0, **scales(b))
        out["fill"].append(lg.numpy())
        cache.cursor[b] = cache.next_pos[b] = n
    active = torch.tensor([True, True, False, True])
    out["decode"] = dec.decode_step_slots(cache, torch.randint(3, 259, (B,), generator=g),
                                          active).numpy()
    out["extend"] = dec.extend_slots(cache, torch.randint(3, 259, (B, 5), generator=g),
                                     active).numpy()
    ids, mask = torch.randint(3, 259, (7,), generator=g), torch.tensor([1.0] * 6 + [0.0])
    col = int(cache.cursor[0])
    out["prefill_extend"] = dec.prefill_extend(
        cache.k[:, 0], cache.v[:, 0], cache.key_mask[0], ids, mask, col, col,
        all_logits=True, **scales(0))[0].numpy()
    out["fill"] = np.stack(out["fill"])
    return out


def run_spec(mesh, case: dict) -> dict:
    """``SpeculativeGenerator`` with this generator as its target and a whole
    draft on every rank, beside the target's own greedy generation of each
    prompt alone."""
    target = _gen(mesh, case)
    draft = _gen(None, {**case, "cfg": case["draft_cfg"], "params": case["draft_params"]})
    spec = SpeculativeGenerator(target, draft, gamma=4)
    texts = spec.generate(case["prompts"], max_new_tokens=case["max_new"])
    return {"texts": texts, "stats": spec.last_stats,
            "target": [target.generate([p], max_new_tokens=case["max_new"])[0]
                       for p in case["prompts"]]}


def run_server(mesh, case: dict) -> dict:
    """``LLMServer`` over this generator: model rank 0 serves the prompts
    (all submitted at once), the other ranks follow it. Returns rank 0's
    replies and every rank's finished (request number, tokens)."""
    gen = _gen(mesh, case)
    draft = None
    if case.get("draft_params") is not None:
        draft = _gen(None, {**case, "cfg": case["draft_cfg"], "params": case["draft_params"]})
    srv = LLMServer(gen, slots=case["slots"], chunk=case.get("chunk", 8), draft=draft,
                    prefill_chunk=case["prefill_chunk"])
    if mesh is not None and mesh.model_rank:
        if case.get("die_after") is not None:
            time.sleep(case["die_after"])
            os._exit(3)
        return {"finished": srv.follow(), "stats": dict(srv.stats)}
    try:
        futs = [srv.submit(p, max_new_tokens=case["max_new"]) for p in case["prompts"]]
        texts = [f.result(timeout=case.get("timeout", 240)) for f in futs]
    finally:
        srv.close()
    return {"texts": texts, "finished": list(srv.finished or ()), "stats": dict(srv.stats),
            "pick_mismatches": gen.pick_mismatches}


def run_save(mesh, case: dict) -> dict:
    """``save`` over the mesh (gathered, rank 0 writes), then
    ``from_checkpoint(mesh=)``: this rank's reloaded shard."""
    gen = _gen(mesh, case)
    gen.save(case["path"])
    cc.all_reduce(torch.zeros(1), mesh.model_group)    # a barrier: rank 0 has written it
    again = Generator.from_checkpoint(case["path"], mesh=mesh, device="cpu")
    return {"same_shard": all(torch.equal(tree_get(again.params, p), tree_get(gen.params, p))
                              for p in tree_paths(gen.params))}


RUNS = {"generate": run_generate, "steps": run_steps, "layout": run_layout,
        "rowpar": run_rowpar, "methods": run_methods, "spec": run_spec,
        "server": run_server, "save": run_save}


def run_cases(mesh, cases: dict) -> dict:
    """Every case in turn on this rank: ``{name: result}``."""
    torch.manual_seed(0)
    return {name: RUNS[case["kind"]](mesh, case) for name, case in cases.items()}
