"""Finds each piece of a cell by its name in ``BENCHMARK.json``.

A configuration is the file its entry names; a traffic mix is
``traffic/<traffic>.json``; the code that builds and checks a system is
``systems/<config's "system">.py``; a metric (end-to-end or per-layer) is
read by ``metrics/<metric name>.py``. A later cell, mix or metric is a new
file and a new entry, and no edit here."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones: an
    entry without ``workloads`` belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system(name: str):
    return _module(os.path.join(BENCH_DIR, "systems", f"{name}.py"), f"perfbench_system_{name}")


def reader(metric: str):
    """The ``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    mod = _module(os.path.join(BENCH_DIR, "metrics", f"{metric}.py"),
                  "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))
    return mod.read
