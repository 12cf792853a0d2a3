"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, bounds and the time a full check of 24 cells would take."""

from __future__ import annotations

import os
import re

import pytest

from perfbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert not p.endswith("_torch") and ".." not in p


def test_names_and_units(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert all(NAME.match(n) for n in names), names
    for group in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in bench[group]}) == len(bench[group])
        for m in bench[group]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == KEYS["config"]
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) <= KEYS["end_to_end"] and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= KEYS["per_layer"] and _line(m["layer"])


def test_files_and_references(bench):
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.exists(
            os.path.join(manifest.ROOT, c["file"]))
        assert manifest.config(bench, c["name"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        manifest.traffic(w["traffic"])
        cfg = manifest.config(bench, w["config"])
        assert os.path.exists(os.path.join(manifest.BENCH_DIR, "systems", f"{cfg['system']}.py"))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        if m["name"] != "setup_s":
            assert callable(manifest.reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        mover = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mover.get("workloads", cells))
    for cell in cells:     # setup_s, another end-to-end metric and a per-layer one
        assert len(manifest.metrics(bench, cell, False)) >= 2
        assert manifest.metrics(bench, cell, True)


def test_check_budget(bench):
    """2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s of compiling a
    cell and 1,200 s spare fit 43,200 s with the full 24 cells."""
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_size(bench):
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024
