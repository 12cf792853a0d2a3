"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program. Module names are compared by
their top-level name whole: ``mediquery_rag_tpu_torch`` begins with
``mediquery_rag_tpu`` and is the program."""

from __future__ import annotations

import os
import subprocess
import sys

from perfbench.harness import imports, manifest


def test_top_level_names_compared_whole():
    assert imports.top("mediquery_rag_tpu_torch.serve.llm") == "mediquery_rag_tpu_torch"
    assert "mediquery_rag_tpu_torch" not in imports.FORBIDDEN
    assert {"jax", "jaxlib", "flax", "mediquery_rag_tpu"} <= imports.FORBIDDEN


def test_no_source_imports_jax():
    for path in imports.sources(manifest.BENCH_DIR):
        bad = imports.imported_by(path) & imports.FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_references_import_nothing_of_the_program():
    """The references, and the weight maker they share with the program's
    set-up, import nothing of the program."""
    ref = os.path.join(manifest.BENCH_DIR, "reference")
    for path in imports.sources(ref) + [os.path.join(manifest.BENCH_DIR, "harness", "weights.py")]:
        names = imports.imported_by(path)
        assert imports.PROGRAM not in names and not names & imports.FORBIDDEN, path


def test_loaded_reports_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.fake_for_test", object())
    assert "jaxlib" in imports.loaded()


def test_runner_and_references_load_without_jax():
    """Import every benchmark module in a fresh process with JAX and the JAX
    package made unimportable, and look at ``sys.modules`` after."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mediquery_rag_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from perfbench.harness import imports, manifest, runner, trace\n"
        "from perfbench.reference import bert, ivf, qwen2\n"
        "for s in ('llm_server', 'search_service'):\n"
        "    manifest.system(s)\n"
        "b = manifest.load()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    if m['name'] != 'setup_s':\n"
        "        manifest.reader(m['name'])\n"
        "assert not imports.loaded(), imports.loaded()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, manifest.ROOT], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
