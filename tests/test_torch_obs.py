"""The port's profiler trace and its native HNSW index, on the CPU.

``obs.capture_trace`` writes a Chrome trace that holds an ``annotate``
label and the operators run inside it; ``native.HNSWIndex`` (the port's
build of ``native/hnsw.cpp``) returns the JAX package's labels and scores
(within ``SCORE_TOL``) on the same rows and queries, serially and through
the OpenMP batch path.
"""

import glob
import json

import numpy as np
import pytest
import torch

from mediquery_rag_tpu.native import HNSWIndex as JHNSW
from mediquery_rag_tpu.native import hnsw_available as jhnsw_available
from mediquery_rag_tpu_torch.native import HNSWIndex, hnsw_available
from mediquery_rag_tpu_torch.obs import annotate, capture_trace

SCORE_TOL = 1e-6


def test_capture_trace_holds_the_annotation(tmp_path):
    a = torch.randn(64, 64)
    with capture_trace(str(tmp_path)) as prof:
        with annotate("mediquery.search"):
            (a @ a).sum()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "mediquery.search" in names and "aten::mm" in names
    assert any(e.key == "mediquery.search" for e in prof.key_averages())


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("threads", [1, 4])
def test_hnsw_matches_jax(threads):
    assert hnsw_available() and jhnsw_available()
    rng = np.random.default_rng(173)
    rows = _unit(rng.standard_normal((2000, 48)))
    q = _unit(rows[:40] + 0.2 * rng.standard_normal((40, 48)))
    mine, theirs = HNSWIndex(48, M=12, ef_construction=80), JHNSW(48, M=12, ef_construction=80)
    for idx in (mine, theirs):
        idx.add(rows[:1500])
        idx.add(rows[1500:], labels=np.arange(5000, 5500))
    assert mine.size == theirs.size == 2000 and mine.nbytes == theirs.nbytes
    s, i = mine.search(q, k=10, ef=48, threads=threads)
    js, ji = theirs.search(q, k=10, ef=48, threads=threads)
    np.testing.assert_array_equal(i, ji)
    # both libraries are -march=native -ffast-math builds, the JAX package's
    # possibly for another CPU: its dot products may fuse or order the
    # multiply-adds otherwise, a few f32 ulps on scores below 1
    np.testing.assert_allclose(s, js, rtol=0, atol=SCORE_TOL)
    exact = np.argsort(-(q @ rows.T), axis=1, kind="stable")[:, :10]
    exact = np.where(exact >= 1500, exact + 3500, exact)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, exact)]) >= 0.9
