"""Small copies of the cells for CPU tests: the same configuration files
and traffic mixes with the widths, depths, clients and lengths cut until a
run takes seconds on a CPU. Only these tests run them; the benchmark runs
the files as they are."""

from __future__ import annotations

import copy

from perfbench.harness import manifest


def chat() -> tuple[dict, dict, dict]:
    bench = manifest.load()
    cell = manifest.workload(bench, "chat7b-rag")
    cfg = copy.deepcopy(manifest.config(bench, cell["config"]))
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
               torch_dtype="float32")
    cfg["slots"] = 4
    cfg["deployment"].update(chunk=8, prefill_chunk=128, cache_len=1024)
    traffic = copy.deepcopy(manifest.traffic(cell["traffic"]))
    traffic.update(clients=4, stagger_s=0.01, ramp_completions=4, ramp_timeout_s=120,
                   drain_s=120, pool=64, check_requests=3,
                   prompt_tokens={"dist": "lognormal", "median": 400, "sigma": 0.3,
                                  "min": 300, "max": 600},
                   output_tokens={"dist": "uniform", "min": 8, "max": 24})
    return cell, cfg, traffic


def search() -> tuple[dict, dict, dict]:
    bench = manifest.load()
    cell = manifest.workload(bench, "search1m-ivf8")
    cfg = copy.deepcopy(manifest.config(bench, cell["config"]))
    cfg.update(chunks=8192, centers=256)
    cfg["encoder"].update(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=256, torch_dtype="float32")
    cfg["index"].update(nlist=64, nprobe=8)
    # at 8 of 64 lists over these rows the exact top-5's recall is about
    # half (0.52-0.56 missed on the CPU): the copy's own limit
    cfg["check"]["recall_miss"] = 0.7
    traffic = copy.deepcopy(manifest.traffic(cell["traffic"]))
    traffic.update(clients=16, ramp_completions=32, ramp_timeout_s=120, drain_s=60,
                   pool=256, check_queries=32)
    return cell, cfg, traffic
