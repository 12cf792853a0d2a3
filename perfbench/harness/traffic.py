"""The one traffic generator: a traffic file's parameters and a seed in, a
request pool out.

Every seed gets the same sizes in the same order: prompt and output
lengths are quantile grids of the file's distributions, put in an order
drawn from the file's ``order_seed``; the run's seed chooses only the
texts. So runs with different seeds do the same work (a 51-s window of a
saturated server sees a few dozen requests, and which ones moved a chat
cell's tokens/s by 20% between two seeds when the seed chose the order),
and their spread is the system's, not the generator's.

Kinds of request (``"request"`` in the traffic file):

- ``rag_chat``: a system line, retrieved corpus chunks and a held-out
  question, cut to an exact prompt length in byte tokens (BOS + one token a
  UTF-8 byte), and an output budget; greedy.
- ``query``: a search query, from the held-out questions and fixed
  recombinations of them, and k: the pool and its order are the file's.
"""

from __future__ import annotations

import math
import os
import random
import re
import statistics


def parse_corpus(path: str) -> list[tuple[str, str]]:
    """(title, content) of each record of a ``chunk_id:``-separated corpus
    file (data/medical_data.txt's format)."""
    with open(path, encoding="utf-8") as f:
        raw = f.read()
    out = []
    for rec in re.split(r"(?m)^chunk_id\s*[:：]\s*", raw)[1:]:
        fields, cur = {}, None
        for line in rec.splitlines()[1:]:
            m = re.match(r"^(title|content|source|tags|reviewed_at)\s*[:：]\s*(.*)$", line.strip())
            if m:
                cur = m.group(1)
                fields[cur] = m.group(2).strip()
            elif cur and line.strip():
                fields[cur] += "\n" + line.strip()
        if fields.get("title") or fields.get("content"):
            out.append((fields.get("title", ""), fields.get("content", "")))
    return out


def parse_questions(paths: list[str]) -> list[str]:
    """The query column of ``chunk_id<TAB>query`` files; '#' lines are comments."""
    out = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#") or "\t" not in line:
                    continue
                out.append(line.split("\t", 1)[1].strip())
    return out


def length_grid(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``spec``'s
    distribution: ``lognormal`` (median, sigma) or ``uniform``, clipped to
    [min, max]."""
    lo, hi = spec["min"], spec["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = round(spec["median"] * math.exp(spec["sigma"] * statistics.NormalDist().inv_cdf(u)))
        elif spec["dist"] == "uniform":
            x = lo + int(u * (hi - lo + 1))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(max(x, lo), hi))
    return out


def _cut_utf8(text: str, nbytes: int) -> str:
    """The longest prefix of ``text`` of at most ``nbytes`` UTF-8 bytes."""
    b = text.encode("utf-8")[:nbytes]
    return b.decode("utf-8", errors="ignore")


def rag_prompt(rng: random.Random, chunks, question: str, system: str, tokens: int) -> str:
    """A prompt of exactly ``tokens`` byte tokens (BOS + its UTF-8 bytes):
    the system line, corpus chunks from a seeded start in corpus order, then
    the question; the material is cut at a character and padded with
    newlines to the exact length."""
    head = system + "\n资料：\n"
    tail = "\n问题：" + question + "\n回答："
    room = tokens - 1 - len((head + tail).encode("utf-8"))
    if room < 0:
        raise ValueError(f"a {tokens}-token prompt cannot hold the system line and question")
    parts, size, i = [], 0, rng.randrange(len(chunks))
    while size < room:
        title, content = chunks[i % len(chunks)]
        parts.append(f"【{title}】{content}\n")
        size += len(parts[-1].encode("utf-8"))
        i += 1
    material = _cut_utf8("".join(parts), room)
    material += "\n" * (room - len(material.encode("utf-8")))
    return head + material + tail


def query_pool(questions: list[str], n: int, seed: int) -> list[str]:
    """The held-out questions, then recombinations (the first half of one
    and the second half of another) drawn from ``seed``, ``n`` in all."""
    rng = random.Random(seed)
    pool = list(questions)[:n]
    while len(pool) < n:
        a, b = rng.choice(questions), rng.choice(questions)
        pool.append(a[: max(1, len(a) // 2)] + b[len(b) // 2:])
    return pool


def build_requests(traffic: dict, seed: int, root: str) -> list[dict]:
    """The run's request pool in send order (the loop cycles through it)."""
    rng = random.Random(seed)
    order = random.Random(traffic["order_seed"])
    n = traffic["pool"]
    questions = parse_questions([os.path.join(root, p) for p in traffic["questions_files"]])
    kind = traffic["request"]
    if kind == "rag_chat":
        chunks = parse_corpus(os.path.join(root, traffic["chunks_file"]))
        prompt_lens = length_grid(traffic["prompt_tokens"], n)
        out_lens = length_grid(traffic["output_tokens"], n)
        order.shuffle(prompt_lens)
        order.shuffle(out_lens)
        return [{"prompt": rag_prompt(rng, chunks, rng.choice(questions),
                                      traffic["system_line"], p),
                 "prompt_tokens": p, "max_new": o}
                for p, o in zip(prompt_lens, out_lens)]
    if kind == "query":
        pool = query_pool(questions, n, traffic["order_seed"])
        order.shuffle(pool)
        return [{"query": q, "k": traffic["k"]} for q in pool]
    raise ValueError(f"unknown request kind {kind!r}")
