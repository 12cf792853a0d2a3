# Copy of mediquery_rag_tpu/serve/batcher.py (the port imports nothing of the JAX package).
"""Micro-batching search service.

The BASELINE north star has the Self-RAG loop "issue batched queries
straight into this engine" — this is the production mechanism: concurrent
callers (sessions, graph nodes, API handlers) enqueue single queries; a
collector thread coalesces them into one TPU batch (up to ``max_batch`` or
``max_wait_ms``, whichever first) and fans results back out through
futures. Amortizes the fixed per-dispatch cost that dominates B=1 serving.

The reference had no serving layer at all (strictly one synchronous user,
SURVEY §2c); this is a net-new component of the framework.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

from mediquery_rag_tpu_torch.obs import tracing


class MicroBatcher:
    """Generic request coalescer: concurrent callers submit single items;
    a collector thread batches them (up to ``max_batch`` or
    ``max_wait_ms``) into ONE ``fn(items) -> results`` call and fans the
    results back out through futures. The embeddings endpoint rides this
    (serve/server.py /v1/embeddings): N concurrent HTTP callers become
    one TPU embed program, the same amortization BatchingSearchService
    does for retrieval."""

    def __init__(self, fn: Callable[[list], Sequence], *,
                 max_batch: int = 64, max_wait_ms: float = 2.0):
        self._fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def submit_many(self, items: Sequence) -> list:
        """Results for ``items``, coalesced with everyone else's."""
        futs = [self.submit(x) for x in items]
        return [f.result(timeout=120.0) for f in futs]

    def shutdown(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                continue
            batch = [item]
            t_end = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(
                self.stats["max_batch_seen"], len(batch))
            try:
                results = self._fn([x for x, _ in batch])
                for (_, fut), res in zip(batch, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


class BatchingSearchService:
    def __init__(
        self,
        batch_search: Callable[[Sequence[str], int], list],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
    ):
        """``batch_search(queries, k) -> list[results-per-query]`` — e.g.
        ``DocumentStore.batch_search``."""
        self._fn = batch_search
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def submit(self, query: str, k: int = 5) -> Future:
        fut: Future = Future()
        self._q.put((query, k, fut))
        return fut

    def search(self, query: str, k: int = 5, timeout: float = 30.0):
        return self.submit(query, k).result(timeout=timeout)

    def similarity_search(self, query: str, k: int = 5):
        """DocumentStore-compatible alias: the service can be passed directly
        as the graph's ``store`` (graph/nodes.py), so N concurrent sessions'
        retrieve nodes coalesce into one TPU batch — the BASELINE north star
        ("the Self-RAG loop issues batched queries straight into this
        engine")."""
        return self.search(query, k)

    def shutdown(self) -> None:
        self._stop.set()
        self._q.put(None)                  # wake the collector
        self._worker.join(timeout=5)

    # -- collector -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                # bounded wait so a sentinel consumed mid-batch can't leave
                # the collector blocked past shutdown
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                continue
            batch = [item]
            # coalesce until max_batch or the wait window closes
            t_end = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            with tracing.span("search.batch", n=len(batch)):
                self._run_batch(batch)

    def _run_batch(self, batch: list) -> None:
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                           len(batch))
        # group by k — one engine call per distinct k in the batch
        by_k: dict[int, list] = {}
        for query, k, fut in batch:
            by_k.setdefault(k, []).append((query, fut))
        for k, items in by_k.items():
            queries = [q for q, _ in items]
            try:
                results = self._fn(queries, k)
                for (_, fut), res in zip(items, results):
                    fut.set_result(res)
            except Exception as e:
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
