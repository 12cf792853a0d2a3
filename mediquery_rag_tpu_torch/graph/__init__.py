# Copy of mediquery_rag_tpu/graph/__init__.py (the port imports nothing of the JAX package).
"""Minimal typed workflow engine — the LangGraph replacement.

The reference built its Self-RAG loop on LangGraph's StateGraph + SqliteSaver
(src/agents/graph.py:43-99). This engine keeps exactly the capabilities that
code used — named nodes returning partial state updates, conditional edges,
a messages-append reducer, per-thread checkpointing, stream/invoke — in a
few hundred lines of dependency-free Python, leaving all heavy compute in
the TPU engine where it belongs.
"""

from mediquery_rag_tpu_torch.graph.engine import (  # noqa: F401
    END,
    CompiledGraph,
    SqliteCheckpointer,
    StateGraph,
)
from mediquery_rag_tpu_torch.graph.state import medical_reducers, initial_state  # noqa: F401
from mediquery_rag_tpu_torch.graph.nodes import create_nodes  # noqa: F401
from mediquery_rag_tpu_torch.graph.build import build_medical_graph  # noqa: F401
