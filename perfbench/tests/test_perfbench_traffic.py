"""The traffic generator: seeded determinism, one multiset of sizes for
every seed, exact prompt lengths, and the length distributions."""

from __future__ import annotations

import statistics

import pytest

from perfbench.harness import manifest, traffic


@pytest.fixture(scope="module")
def mixes():
    bench = manifest.load()
    return {w["name"]: manifest.traffic(w["traffic"]) for w in bench["workloads"]}


@pytest.fixture(scope="module")
def rag(mixes):
    mix = dict(mixes["chat7b-rag"], pool=512)
    return mix, traffic.build_requests(mix, 2**31 + 7, manifest.ROOT)


def test_same_seed_same_requests(rag):
    mix, pool = rag
    assert traffic.build_requests(mix, 2**31 + 7, manifest.ROOT) == pool


def test_every_seed_same_sizes_in_the_same_order(rag):
    mix, pool = rag
    other = traffic.build_requests(mix, 12345, manifest.ROOT)
    assert [r["prompt"] for r in other] != [r["prompt"] for r in pool]
    for key in ("prompt_tokens", "max_new"):
        assert [r[key] for r in other] == [r[key] for r in pool]
    shuffled = traffic.build_requests(dict(mix, order_seed=mix["order_seed"] + 1), 12345,
                                      manifest.ROOT)
    assert sorted(r["max_new"] for r in shuffled) == sorted(r["max_new"] for r in pool)
    assert [r["max_new"] for r in shuffled] != [r["max_new"] for r in pool]


def test_prompt_lengths_exact(rag):
    _, pool = rag
    for r in pool:
        assert 1 + len(r["prompt"].encode("utf-8")) == r["prompt_tokens"]
        assert "问题：" in r["prompt"] and r["prompt"].endswith("回答：")


def test_length_distributions(mixes):
    mix = mixes["chat7b-rag"]
    p = traffic.length_grid(mix["prompt_tokens"], 4096)
    assert min(p) == 1024 and max(p) == 3072
    assert abs(statistics.median(p) - 1800) <= 2
    o = traffic.length_grid(mix["output_tokens"], 4096)
    assert min(o) == 64 and max(o) == 256
    counts = [o.count(v) for v in range(64, 257)]
    assert max(counts) - min(counts) <= 1          # uniform over 64..256


def test_query_pool(mixes):
    mix = mixes["search1m-ivf8"]
    a = traffic.build_requests(mix, 1, manifest.ROOT)
    b = traffic.build_requests(mix, 2, manifest.ROOT)
    assert len(a) == mix["pool"] and a == b
    assert all(r["k"] == 5 and r["query"] for r in a)
    questions = traffic.parse_questions([f"{manifest.ROOT}/{p}" for p in mix["questions_files"]])
    assert set(questions) <= {r["query"] for r in a}


def test_corpus_parse():
    chunks = traffic.parse_corpus(f"{manifest.ROOT}/perfbench/data/medical_data.txt")
    assert len(chunks) == 160 and all(t and c for t, c in chunks)
