# Copy of mediquery_rag_tpu/graph/build.py (the port imports nothing of the JAX package).
"""Wire the Self-RAG medical graph (topology parity with graph.py:43-99)."""

from __future__ import annotations

from mediquery_rag_tpu_torch.graph.engine import END, SqliteCheckpointer, StateGraph
from mediquery_rag_tpu_torch.graph.state import medical_reducers


def build_medical_graph(nodes: dict, checkpointer: SqliteCheckpointer | None = None):
    """nodes: the dict returned by ``create_nodes``. Returns a CompiledGraph.

    START→router ─┬→ assessment_tool → retrieve
                  └→ retrieve → grade_loop ─┬ ready → summarizer → END
                                            ├ go_web → web_search → grade_loop
                                            └ else  → retrieve
    """
    g = StateGraph(reducers=medical_reducers())
    for name, fn in nodes.items():
        g.add_node(name, fn)

    g.set_entry("router")
    g.add_conditional_edges(
        "router",
        lambda s: "assessment" if s.get("mode") == "assessment" else "retrieve",
        {"assessment": "assessment_tool", "retrieve": "retrieve"},
    )
    g.add_edge("assessment_tool", "retrieve")
    g.add_edge("retrieve", "grade_loop")
    g.add_conditional_edges(
        "grade_loop",
        lambda s: s.get("final_answer") or "retry",
        {"ready": "summarizer", "go_web": "web_search", "retry": "retrieve"},
    )
    g.add_edge("web_search", "grade_loop")
    g.add_edge("summarizer", END)
    return g.compile(checkpointer=checkpointer)
