"""Training runs for ``tests/test_torch_mesh_train.py``: each runs one
trainer of the port over a mesh (a rank of ``parallel.dist.launch``) or
over one process (``mesh=None``) and returns numpy results. A module of
its own, importing neither jax nor the JAX package, so the spawned ranks
import only the port."""

import numpy as np
import torch

from mediquery_rag_tpu_torch.engine.checkpoint import save_train_state
from mediquery_rag_tpu_torch.models import lora, train_lm, trainer
from mediquery_rag_tpu_torch.models.bert_encoder import BertEncoder, bert_layout
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.parallel.dist import tree_get, tree_paths


def _numpy(tree: dict) -> dict:
    return {p: tree_get(tree, p).detach().numpy().copy() for p in tree_paths(tree)}


def run_lm(mesh, case: dict) -> dict:
    tr = train_lm.LMTrainer(case["cfg"], case["train"], mesh=mesh, device="cpu")
    state = tr.init_state(params=params_from_jax(case["params"], device="cpu"))
    out = {"loss": [], "grad_norm": []}
    for ids, mask in case["batches"]:
        state, m = tr.train_step(state, train_lm.LMBatch(torch.from_numpy(ids),
                                                         torch.from_numpy(mask)))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _numpy(tr.gather_params(state.params))
    if case.get("save"):
        save_train_state(state, case["save"], layout=tr.layout)
    return out


def run_lora(mesh, case: dict) -> dict:
    tr = lora.LoraTrainer(case["cfg"], case["lora"], case["train"], mesh=mesh, device="cpu")
    base = params_from_jax(case["params"], device="cpu")
    state = tr.init_state(0, base, adapters=params_from_jax(case["adapters"], device="cpu"))
    out = {"loss": [], "grad_norm": [], "delta_norm": []}
    for ids, mask in case["batches"]:
        state, m = tr.train_step(state, base, train_lm.LMBatch(torch.from_numpy(ids),
                                                               torch.from_numpy(mask)))
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = _numpy(tr.gather_adapters(state.adapters))
    return out


def run_contrastive(mesh, case: dict) -> dict:
    tr = trainer.ContrastiveTrainer(case["cfg"], case["train"], mesh=mesh, device="cpu")
    state = tr.init_state(params=params_from_jax(case["params"], device="cpu"))
    out = {"loss": [], "grad_norm": []}
    for arrays in case["batches"]:
        state, m = tr.train_step(state, trainer.Batch(*map(torch.from_numpy, arrays)))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _numpy(tr.gather_params(state.params))
    if case.get("save"):
        save_train_state(state, case["save"], layout=tr.layout)
    return out


def run_bert(mesh, case: dict) -> dict:
    params = params_from_jax(case["params"], device="cpu")
    enc = BertEncoder(case["cfg"], bert_layout(case["cfg"], params, mesh).shard(params), mesh)
    return {"emb": enc(torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"])).numpy()}


RUNS = {"lm": run_lm, "lora": run_lora, "contrastive": run_contrastive, "bert": run_bert}


def run_cases(mesh, cases: dict) -> dict:
    """Every case in turn on this rank: ``{name: result}``."""
    return {name: RUNS[case["kind"]](mesh, case) for name, case in cases.items()}


def same_on_every_rank(results: list) -> dict:
    """Rank 0's results, after checking every rank returned the same."""
    for other in results[1:]:
        for name, res in results[0].items():
            for key, value in res.items():
                if key == "params":
                    for p, a in value.items():
                        np.testing.assert_array_equal(other[name][key][p], a)
                else:
                    np.testing.assert_array_equal(other[name][key], value)
    return results[0]

