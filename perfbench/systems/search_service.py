"""Retrieval through the port's batching search service over an IVF store.

Set-up, from the seed: a BERT encoder's f32 weights and a WordPiece
vocabulary of the corpus characters (bert-base-chinese's layout); the
data rows, scattered around centres that the reference encoder makes of
seeded question-like texts (titles and held-out questions, and halves of
them joined); one chunk record a row. The program then builds the index
(``IVFIndex.build``, its k-means included) and the ``DocumentStore``, and
``SearchServer(store).service`` is the entry the loop submits to: the
``BatchingSearchService`` that ``/search`` and ``/qa``'s retrieve node use.

The store's embedder is the benchmark's callable around the port's BERT
(``BertTextEmbedder``): it times each call and keeps the program's
embedding of each query text it sees. The service calls ``batch_search``
through the benchmark's wrapper, which counts the queries a call. Both
record spans while a traced sub-window runs.

``check``, after the window and with the program's state freed but its
lists kept: a sample of the window's answered queries drawn from the seed.
``emb_gap``: the widest distance between the program's unit query
embedding and the reference encoder's. ``recall_miss``: the share of the
sample's exact top-k (every row, coded int8 by the reference, against the
reference's query) that the program's answers lack; it uses no table the
program made, so it holds the k-means, the lists and the probing as a
whole. ``score_gap``: over the sample's answers, the widest amount by which
the reference's int8 score of the id the program gave at rank j lies below
the reference's j-th best over the lists the reference probes (the scan,
over the program's lists). ``placement``: rows not in exactly one list or
outside their 8 best lists (the build stage ``score_gap`` follows). With
``control`` the reference one precision step down (fp8 encoder
activations, int4 rows) stands in for the program and gives the same
numbers.
"""

from __future__ import annotations

import gc
import os
import random
import time

import numpy as np
import torch

from perfbench.harness import manifest, roofline, traffic as traffic_gen, weights, window
from perfbench.harness.trace import LaunchProbe
from perfbench.reference import bert as ref_bert
from perfbench.reference import ivf as ref_ivf

FIXED = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
         + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
ALNUM = "abcdefghijklmnopqrstuvwxyz0123456789"


def encoder_shape(cfg: dict) -> dict:
    e = cfg["encoder"]
    return {"hidden": e["hidden_size"], "layers": e["num_hidden_layers"],
            "heads": e["num_attention_heads"], "mlp_dim": e["intermediate_size"],
            "vocab": e["vocab_size"], "max_len": e["max_position_embeddings"],
            "ln_eps": e["layer_norm_eps"]}


def vocabulary(texts, size: int) -> dict:
    """bert-base-chinese's layout: [PAD], [unused1-99], [UNK], [CLS], [SEP],
    [MASK], every character of ``texts`` (lower case), a-z and 0-9 with
    their ``##`` pieces, [unused] entries to ``size``."""
    chars = sorted({ch for t in texts for ch in t.lower() if not ch.isspace()} | set(ALNUM))
    pieces = FIXED + [c for c in chars if c not in FIXED] + ["##" + c for c in ALNUM]
    if len(pieces) > size:
        raise ValueError(f"{len(pieces)} pieces do not fit a vocabulary of {size}")
    pieces += [f"[unused{i}]" for i in range(100, 100 + size - len(pieces))]
    return {p: i for i, p in enumerate(pieces)}


class _Store:
    """The store as the service sees it: ``batch_search`` counted and timed."""

    def __init__(self, store, owner):
        self._store, self._owner = store, owner

    def batch_search(self, queries, k=5, where=None):
        t0 = time.time_ns()
        out = self._store.batch_search(queries, k, where=where)
        o = self._owner
        o.stats["batch_calls"] += 1
        o.stats["batch_queries"] += len(queries)
        o.stats["batch_s"] += (time.time_ns() - t0) / 1e9
        if o.tracing:
            o.span_log.append(("batch_search", t0, time.time_ns()))
        return out


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from mediquery_rag_tpu_torch.config import BertEmbedderConfig, EngineConfig
        from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
        from mediquery_rag_tpu_torch.ingest.parser import Chunk
        from mediquery_rag_tpu_torch.ingest.pipeline import DocumentStore
        from mediquery_rag_tpu_torch.models.hf_import import BertTextEmbedder
        from mediquery_rag_tpu_torch.models.wordpiece_tokenizer import WordPieceTokenizer
        from mediquery_rag_tpu_torch.serve.server import SearchServer

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.shape = encoder_shape(cfg)
        self.stats = {"batch_calls": 0, "batch_queries": 0, "batch_s": 0.0,
                      "embed_calls": 0, "embed_s": 0.0, "embed_queries": 0}
        self.tracing, self.span_log = False, []
        self.prog_emb: dict = {}
        corpus = traffic_gen.parse_corpus(os.path.join(manifest.ROOT, cfg["data"]["chunks_file"]))
        questions = traffic_gen.parse_questions(
            [os.path.join(manifest.ROOT, p) for p in cfg["data"]["questions_files"]])
        self.vocab = vocabulary([t + c for t, c in corpus] + questions, self.shape["vocab"])
        e = cfg["encoder"]
        ecfg = BertEmbedderConfig(
            vocab_size=e["vocab_size"], hidden=e["hidden_size"], layers=e["num_hidden_layers"],
            heads=e["num_attention_heads"], mlp_dim=e["intermediate_size"],
            max_len=e["max_position_embeddings"], type_vocab=e["type_vocab_size"],
            ln_eps=e["layer_norm_eps"], pooling="mean", dtype=e["torch_dtype"])
        self.encoder = BertTextEmbedder(
            ecfg, weights.bert_params(self.shape, seed, device),
            WordPieceTokenizer(self.vocab, max_len=e["max_position_embeddings"]))
        rows = self.rows(corpus, questions)
        ix = cfg["index"]
        icfg = EngineConfig(dim=e["hidden_size"], top_k=ix["k"], index_kind="ivf",
                            dtype=ix["dtype"], metric="cosine", ivf_nlist=ix["nlist"],
                            ivf_nprobe=ix["nprobe"], ivf_kmeans_iters=ix["kmeans_iters"],
                            rerank_factor=ix["rerank_factor"],
                            ivf_cap_factor=ix["cap_factor"])
        index = IVFIndex.build(rows, icfg, seed=seed, device=device)
        del rows
        chunks = [Chunk(chunk_id=str(i), title=corpus[i % len(corpus)][0],
                        content=corpus[i % len(corpus)][1], source=cfg["data"]["source_label"])
                  for i in range(cfg["chunks"])]
        self.store = DocumentStore(chunks, index, self.embed)
        self.server = SearchServer(_Store(self.store, self), max_batch=ix["max_batch"],
                                   max_wait_ms=ix["max_wait_ms"])
        self.service = self.server.service
        gc.collect()
        gc.freeze()          # a million chunk records: keep them out of every collection

    def center_texts(self, corpus, questions) -> list[str]:
        """The seed's question-like texts: titles, held-out questions, and
        the first half of one joined to the second half of another."""
        rng = random.Random(self.seed)
        base = [t for t, _ in corpus] + list(questions)
        out = list(base)
        while len(out) < self.cfg["centers"]:
            a, b = rng.choice(base), rng.choice(base)
            out.append(a[: max(1, len(a) // 2)] + b[len(b) // 2:])
        return out[: self.cfg["centers"]]

    def rows(self, corpus, questions) -> torch.Tensor:
        """The corpus rows, on the device (made again for the check)."""
        params = weights.bert_params(self.shape, self.seed, self.device)
        ids = [ref_bert.tokenize(t, self.vocab, self.shape["max_len"])
               for t in self.center_texts(corpus, questions)]
        centers = ref_bert.embed(params, self.shape, ids, self.device)
        del params
        return weights.scattered_rows(centers, self.cfg["chunks"], self.cfg["spread"], self.seed)

    def embed(self, texts) -> np.ndarray:
        """The store's embedder: the port's BERT, timed; keeps each text's
        first embedding for the check."""
        t0 = time.time_ns()
        out = self.encoder(texts)
        t1 = time.time_ns()
        self.stats["embed_calls"] += 1
        self.stats["embed_queries"] += len(texts)
        self.stats["embed_s"] += (t1 - t0) / 1e9
        if self.tracing:
            self.span_log.append(("embedder", t0, t1))
        for t, v in zip(texts, out):
            if t not in self.prog_emb:
                self.prog_emb[t] = v.copy()
        return out

    # -- the loop's interface ---------------------------------------------------

    def submit(self, req: dict):
        return self.service.submit(req["query"], req["k"])

    def outcome(self, rec, fut, t: float) -> dict:
        if fut.exception() is not None:
            return {"ok": False, "t_done": t, "error": repr(fut.exception())}
        docs = fut.result()
        ids = [int(d.metadata["chunk_id"]) for d in docs]
        return {"t_first": t, "t_done": t, "payload": ids, "ok": len(ids) == rec.req["k"],
                "error": None if len(ids) == rec.req["k"] else f"{len(ids)} answers"}

    def counters(self) -> dict:
        return dict(self.stats)

    def spans(self) -> list:
        return list(self.span_log)

    def probes(self) -> dict:
        """The int8 IVF scans (B9b bucket-major, B8b query-major), with the
        live rows of each launch's distinct probed lists."""
        from mediquery_rag_tpu_torch.ops import ivf_kernel

        lists = self.store.index.bucket_ids
        live = (lists >= 0).sum(dim=1).double()
        nlist, cap = lists.shape

        def need(probe_ids, q8, k):
            hit = torch.zeros(nlist, dtype=torch.float64, device=live.device)
            hit.scatter_(0, probe_ids.reshape(-1).long(), 1.0)
            b, d = q8.shape
            return (roofline.ivf_int8_bytes(live_rows=(hit * live).sum(), distinct=hit.sum(),
                                            cap=cap, queries=b, d=d,
                                            nprobe=probe_ids.shape[1], k=k),
                    roofline.ivf_int8_ops(probed_rows=live[probe_ids.long()].sum(), d=d))

        def batch(probe_ids, uniq, q8, buckets, bucket_ids, bucket_scales, k, **_):
            return need(probe_ids, q8, k)

        def probe(probe_ids, q8, buckets, bucket_ids, bucket_scales, k, **_):
            return need(probe_ids, q8, k)

        self.tracing = True
        return {"ivf": LaunchProbe(ivf_kernel, "ivf_batch_topk_int8_cuda", "ivf_scan_kernel",
                                   "int8", batch),
                "ivf_probe": LaunchProbe(ivf_kernel, "ivf_probe_topk_int8_cuda",
                                         "ivf_scan_kernel", "int8", probe)}

    def close(self) -> None:
        self.service.shutdown()
        ix = self.store.index
        self.lists = ix.bucket_ids.clone()
        self.centroids = ix.centroids.clone()
        gc.unfreeze()
        del self.store, self.server, self.service, self.encoder
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the comparison with the reference ----------------------------------------

    def check(self, records: list, w0: float, w1: float, control: bool) -> dict:
        answered = [r for r in records if r.ok and window.in_window(r.t_done, w0, w1)]
        rng = random.Random(self.seed ^ 0x5EA7C4)
        sample = rng.sample(answered, min(self.traffic["check_queries"], len(answered)))
        if not sample:
            raise RuntimeError("no query answered inside the window: nothing to check")
        corpus = traffic_gen.parse_corpus(os.path.join(manifest.ROOT, self.cfg["data"]["chunks_file"]))
        questions = traffic_gen.parse_questions(
            [os.path.join(manifest.ROOT, p) for p in self.cfg["data"]["questions_files"]])
        rows = self.rows(corpus, questions)
        params = weights.bert_params(self.shape, self.seed, self.device)
        texts = [r.req["query"] for r in sample]
        ids = [ref_bert.tokenize(t, self.vocab, self.shape["max_len"]) for t in texts]
        e_ref = ref_bert.embed(params, self.shape, ids, self.device)
        ix = self.cfg["index"]
        c8, s8 = ref_ivf.codes(rows, 127)
        exact = ref_ivf.exact(e_ref, c8, s8, ix["k"])
        # the cap rule of the layout: 2 n / nlist, rounded up to 32
        cap_limit = -(-max(int(ix["cap_factor"] * self.cfg["chunks"] / ix["nlist"]), 32) // 32) * 32
        misplaced = float(sum(ref_ivf.placement(rows, self.centroids, self.lists, ix["assign_r"],
                                                ix["assign_tie"], cap_limit)))
        own = ref_ivf.kmeans(rows, ix["nlist"], ix["kmeans_iters"], self.seed ^ 0x6B3A)
        fit_gap = ref_ivf.fit(rows, own) - ref_ivf.fit(rows, self.centroids)
        del own
        limits = self.cfg["check"]

        def readings(emb, answers):
            """The numbers of one side: its unit query embeddings and its answers."""
            worst = 0.0
            for q_ref, ans in zip(e_ref, answers):
                best, _ = ref_ivf.search(q_ref, self.centroids, self.lists, c8, s8,
                                         ix["nprobe"], ix["k"])
                got = ref_ivf.scores(q_ref, c8, s8, torch.tensor(ans, device=self.device))
                worst = max(worst, float((best - got).max()))
            hits = sum(len(set(a) & set(e)) for a, e in zip(answers, exact.tolist()))
            return [{"name": "emb_gap", "value": float((emb - e_ref).norm(dim=1).max()),
                     "limit": limits["emb_gap"], "queries": len(answers)},
                    {"name": "recall_miss", "value": 1.0 - hits / exact.numel(),
                     "limit": limits["recall_miss"]},
                    {"name": "fit_gap", "value": fit_gap, "limit": limits["fit_gap"]},
                    {"name": "score_gap", "value": worst, "limit": limits["score_gap"]},
                    {"name": "placement", "value": misplaced, "limit": 0.0}]

        e_prog = torch.tensor(np.stack([self.prog_emb[t] for t in texts]), device=self.device)
        out = {"program": readings(e_prog / e_prog.norm(dim=1, keepdim=True),
                                   [r.payload for r in sample])}
        if control:
            e_ctl = ref_bert.embed(params, self.shape, ids, self.device, precision="control")
            c4, s4 = ref_ivf.codes(rows, 7)
            ctl_answers = [ref_ivf.search(q, self.centroids, self.lists, c4, s4, ix["nprobe"],
                                          ix["k"])[1].tolist() for q in e_ctl]
            out["control"] = readings(e_ctl, ctl_answers)
        return out


def build(cfg: dict, traffic: dict, seed: int, device) -> System:
    return System(cfg, traffic, seed, device)
