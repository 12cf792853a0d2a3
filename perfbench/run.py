#!/usr/bin/env python3
"""Run one cell of the benchmark of ``mediquery_rag_tpu_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. Prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then ``check``,
each number compared with its limit, which the last lines of standard
error repeat. ``--control 1`` puts the reference one precision step down
in the program's place and judges its numbers as it would the program's,
so such a run comes out not correct; the program's own numbers of that
run are kept under ``program_check`` (the benchmark's runs leave it off).

Exits non-zero, printing no result, without enough CUDA cards for the
cell, when the program is missing, when a run fails, and when JAX or the
JAX package is loaded once the window has closed. Caches of compiled
kernels live at fixed paths under ``build/`` in the checkout.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "build", "perfbench")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "perfbench"):
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import imports, manifest, runner

    bench = manifest.load(ROOT)
    cell = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    head, run, checks = runner.run_cell(cell, cfg, traffic, args.seed, args.seconds,
                                        bool(args.trace), device="cuda", t_process=T_PROCESS,
                                        control=bool(args.control))
    metrics = {}
    for m in manifest.metrics(bench, cell["name"], bool(args.trace)):
        v = run.setup_s if m["name"] == "setup_s" else manifest.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = imports.loaded()
    if found:
        print(f"perfbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    result = {"correct": head["correct"], "attempted": head["attempted"],
              "failed": head["failed"], "metrics": metrics, "device": head["device"]}
    for key in ("breakdown", "errors", "phases", "host", "program_check"):
        if key in head:
            result[key] = head[key]
    result["check"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
