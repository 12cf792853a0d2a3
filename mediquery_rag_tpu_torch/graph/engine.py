# Copy of mediquery_rag_tpu/graph/engine.py (the port imports nothing of the JAX package).
"""StateGraph: nodes + conditional edges + reducers + checkpointing.

Capability parity with the LangGraph surface the reference used
(graph.py:56-97): add_node / add_edge / add_conditional_edges / compile /
stream / invoke, a per-key reducer model (messages append), and a SQLite
checkpointer keyed by thread_id saving state after every super-step.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import time
from typing import Any, Callable, Iterator

from mediquery_rag_tpu_torch.llm.messages import Message

END = "__end__"
State = dict[str, Any]
Reducer = Callable[[Any, Any], Any]


def append_reducer(old, new):
    old = old or []
    if not isinstance(new, list):
        new = [new]
    return list(old) + new


def replace_reducer(old, new):
    return new


# -- state (de)serialization --------------------------------------------------

def _encode(obj):
    if isinstance(obj, Message):
        return {"__type__": "Message", **obj.to_dict()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__type__": type(obj).__name__,
                "fields": dataclasses.asdict(obj)}
    raise TypeError(f"not JSON serializable: {type(obj)}")


def _decode(d):
    if d.get("__type__") == "Message":
        return Message(role=d["role"], content=d["content"])
    if "__type__" in d and "fields" in d:
        return d["fields"]  # generic dataclass → plain dict on reload
    return d


def dumps_state(state: State) -> str:
    return json.dumps(state, default=_encode, ensure_ascii=False)


def loads_state(s: str) -> State:
    return json.loads(s, object_hook=_decode)


# -- checkpointing -------------------------------------------------------------

class SqliteCheckpointer:
    """Per-thread state snapshots after every super-step (graph.py:95-97
    equivalent). Single-writer: guarded by a lock rather than the reference's
    unlocked check_same_thread=False connection (SURVEY §5 race note)."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS checkpoints ("
                "thread_id TEXT, step INTEGER, node TEXT, state TEXT, ts REAL,"
                "PRIMARY KEY (thread_id, step))"
            )
            self._conn.commit()

    def put(self, thread_id: str, step: int, node: str, state: State) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO checkpoints VALUES (?,?,?,?,?)",
                (thread_id, step, node, dumps_state(state), time.time()),
            )
            self._conn.commit()

    def latest(self, thread_id: str) -> State | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT state FROM checkpoints WHERE thread_id=? "
                "ORDER BY step DESC LIMIT 1",
                (thread_id,),
            ).fetchone()
        return loads_state(row[0]) if row else None

    def next_step(self, thread_id: str) -> int:
        """First unused step for a thread. Steps must be monotonic ACROSS
        invocations: restarting at 0 would leave a longer earlier run's
        stale tail rows above a shorter later run, and latest() would
        resume from the wrong invocation's state."""
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(step) FROM checkpoints WHERE thread_id=?",
                (thread_id,),
            ).fetchone()
        return 0 if row[0] is None else row[0] + 1

    def history(self, thread_id: str) -> list[tuple[int, str]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT step, node FROM checkpoints WHERE thread_id=? ORDER BY step",
                (thread_id,),
            ).fetchall()
        return rows


# -- the graph -----------------------------------------------------------------

class StateGraph:
    def __init__(self, reducers: dict[str, Reducer] | None = None):
        self.nodes: dict[str, Callable[[State], State]] = {}
        self.edges: dict[str, str] = {}
        self.conditional: dict[str, tuple[Callable[[State], str], dict | None]] = {}
        self.entry: str | None = None
        self.reducers = reducers or {}

    def add_node(self, name: str, fn: Callable[[State], State]) -> "StateGraph":
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        self.nodes[name] = fn
        return self

    def add_edge(self, src: str, dst: str) -> "StateGraph":
        self.edges[src] = dst
        return self

    def add_conditional_edges(
        self, src: str, router: Callable[[State], str],
        mapping: dict[str, str] | None = None,
    ) -> "StateGraph":
        self.conditional[src] = (router, mapping)
        return self

    def set_entry(self, name: str) -> "StateGraph":
        self.entry = name
        return self

    def compile(self, checkpointer: SqliteCheckpointer | None = None,
                max_steps: int = 64) -> "CompiledGraph":
        if self.entry is None:
            raise ValueError("no entry node set")
        unknown = [d for d in self.edges.values() if d != END and d not in self.nodes]
        for _, mapping in self.conditional.values():
            if mapping:
                unknown += [d for d in mapping.values()
                            if d != END and d not in self.nodes]
        if unknown:
            raise ValueError(f"edges to unknown nodes: {unknown}")
        return CompiledGraph(self, checkpointer, max_steps)


class CompiledGraph:
    def __init__(self, graph: StateGraph, checkpointer, max_steps: int):
        self.graph = graph
        self.checkpointer = checkpointer
        self.max_steps = max_steps

    def _merge(self, state: State, updates: State) -> State:
        out = dict(state)
        for k, v in (updates or {}).items():
            red = self.graph.reducers.get(k, replace_reducer)
            out[k] = red(out.get(k), v)
        return out

    def stream(self, inputs: State, thread_id: str = "default",
               ) -> Iterator[tuple[str, State]]:
        """Run the graph, yielding (node_name, state_after_node) per step."""
        state: State = {}
        base_step = 0
        if self.checkpointer is not None:
            state = self.checkpointer.latest(thread_id) or {}
            base_step = self.checkpointer.next_step(thread_id)
        state = self._merge(state, inputs)

        node = self.graph.entry
        for step in range(self.max_steps):
            fn = self.graph.nodes[node]
            updates = fn(state)
            state = self._merge(state, updates)
            if self.checkpointer is not None:
                self.checkpointer.put(thread_id, base_step + step, node, state)
            yield node, state

            if node in self.graph.conditional:
                router, mapping = self.graph.conditional[node]
                label = router(state)
                nxt = mapping.get(label, label) if mapping else label
            elif node in self.graph.edges:
                nxt = self.graph.edges[node]
            else:
                nxt = END
            if nxt == END:
                return
            node = nxt
        raise RuntimeError(
            f"graph exceeded max_steps={self.max_steps} (cycle without exit?)"
        )

    def invoke(self, inputs: State, thread_id: str = "default") -> State:
        state: State = {}
        for _, state in self.stream(inputs, thread_id):
            pass
        return state
