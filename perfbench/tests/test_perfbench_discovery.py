"""A new configuration, traffic mix or metric is a new file and a new
entry in BENCHMARK.json, picked up by its name with no other edit."""

from __future__ import annotations

import importlib.util
import json
import shutil

from perfbench.harness import manifest


def _copy(tmp_path):
    """A checkout of the benchmark alone, and its own manifest module."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{manifest.ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = importlib.util.spec_from_file_location(
        "perfbench_manifest_copy", tmp_path / "perfbench" / "harness" / "manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_files_found_by_name(tmp_path):
    m = _copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "perfbench/configs/qwen2.5-7b-int4-kv8.json").read_text())
    (tmp_path / "perfbench/configs/other.json").write_text(json.dumps(dict(cfg, name="other")))
    mix = json.loads((tmp_path / "perfbench/traffic/rag-closed32.json").read_text())
    (tmp_path / "perfbench/traffic/rag-open.json").write_text(json.dumps(dict(mix, clients=8)))
    (tmp_path / "perfbench/metrics/queue_wait_ms.rag.py").write_text(
        "def read(run):\n    return 42.0 if run is not None else None\n")
    bench["configs"].append({"name": "other", "source": "https://example.org/other",
                             "file": "perfbench/configs/other.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "other-open", "config": "other", "traffic": "rag-open",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "queue_wait_ms.rag", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "scheduler", "moves": "output_tok_per_s",
                               "workloads": ["chat7b-rag", "other-open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = m.load(str(tmp_path))
    cell = m.workload(bench, "other-open")
    assert m.config(bench, cell["config"], str(tmp_path))["name"] == "other"
    assert m.traffic(cell["traffic"])["clients"] == 8
    assert "queue_wait_ms.rag" in [x["name"] for x in m.metrics(bench, "other-open", True)]
    assert m.reader("queue_wait_ms.rag")(object()) == 42.0
    assert m.system(m.config(bench, "other", str(tmp_path))["system"]).build
    # a metric without ``workloads`` belongs to every cell, the new one too
    assert "setup_s" in [x["name"] for x in m.metrics(bench, "other-open", False)]
