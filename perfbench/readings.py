#!/usr/bin/env python3
"""The readings that each limit of ``correct`` is set from, in one process.

    python3 perfbench/readings.py --workload <name> --seeds <a>-<b> [--seconds 3]
                                  [--fault <name>]

For each seed: one whole run of the cell (set-up, ramp, a short window at
the cell's own load, the check) with the control read beside the program,
and one JSON line on standard output with both sides' numbers. With
``--fault`` the timed path runs with that fault of ``harness/faults.py``
planted underneath, and the program's numbers are the fault's readings.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

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
    ap.add_argument("--seeds", required=True, help="first-last, inclusive")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import faults, manifest, runner

    if not torch.cuda.is_available():
        print("perfbench: the readings need a CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    bench = manifest.load(ROOT)
    cell = manifest.workload(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    first, last = (int(x) for x in args.seeds.split("-"))
    for seed in range(first, last + 1):
        t = time.time()
        head, _, judged = runner.run_cell(cell, cfg, traffic, seed, args.seconds, False,
                                          device="cuda", t_process=t, control=True)
        print(json.dumps({
            "seed": seed, "fault": args.fault, "failed": head["failed"],
            "program": {c["name"]: c["value"] for c in head["program_check"]},
            "control": {c["name"]: c["value"] for c in judged},
            "wall_s": time.time() - t}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
