# Copy of mediquery_rag_tpu/graph/nodes.py (the port imports nothing of the JAX package).
"""Self-RAG graph nodes (behavioral parity with src/agents/nodes.py).

``create_nodes`` is a closure factory over injected dependencies — the same
injection shape as the reference (nodes.py:21) so every LLM/web/store
touchpoint is swappable in tests.

The retrieve→grade→{generate | rewrite | web}→... loop contract
(nodes.py:87-207):
- rewritten queries are APPENDED to messages, so messages[-1] becomes the
  live query for the next iteration (preserved quirk, nodes.py:206-207);
- only the first ``grade_docs`` retrieved docs are graded (core/utils.py:64);
- at the loop cap: go to web once, then best-effort answer (nodes.py:197-204);
- web failures degrade to empty docs (fail-open, nodes.py:141-143).
"""

from __future__ import annotations

from typing import Callable, Sequence

from mediquery_rag_tpu_torch.app.tools import run_assessment
from mediquery_rag_tpu_torch.config import GraphConfig
from mediquery_rag_tpu_torch.graph import prompts
from mediquery_rag_tpu_torch.graph.state import detect_mode, initial_state
from mediquery_rag_tpu_torch.llm.messages import Message, ai, user

WebSearchFn = Callable[[str], Sequence[dict]]  # -> [{"title","content","url"}]


def _last_user_text(messages: list[Message]) -> str:
    for m in reversed(messages):
        if m.role == "user":
            return m.content
    return ""


def _format_docs(documents) -> str:
    out = []
    for d in documents:
        text = d["text"] if isinstance(d, dict) else getattr(d, "text", str(d))
        out.append(text)
    return "\n\n".join(out) if out else "（无）"


def create_nodes(
    llm,
    store,
    *,
    web_search: WebSearchFn | None = None,
    extract_health: Callable[[str, str], None] | None = None,
    load_profile: Callable[[str], str] | None = None,
    cfg: GraphConfig = GraphConfig(),
    top_k: int = 5,
    grade_fn: Callable[[str, list], bool] | None = None,
):
    """Build the node functions. ``store`` must expose similarity_search.

    ``grade_fn(question, doc_texts) -> bool`` optionally replaces the LLM
    yes/no document grading (reference core/utils.py:64-72) — e.g. a
    trained TPU cross-encoder (models/cross_encoder.py:make_grader), which
    turns one LLM round trip per Self-RAG loop step into an MXU forward
    pass. Default stays the LLM grader for behavioral parity.
    """

    def router_node(state):
        q = _last_user_text(state.get("messages", []))
        user_id = state.get("user_id", "anonymous")
        updates = dict(initial_state(user_id))
        updates.pop("messages")          # never reset the transcript
        updates["mode"] = detect_mode(q)
        if user_id != "anonymous":
            if extract_health is not None:
                extract_health(q, user_id)           # long-term memory write
            if load_profile is not None:
                updates["health_profile"] = load_profile(user_id)
        return updates

    def assessment_tool_node(state):
        q = _last_user_text(state["messages"])
        result = run_assessment(q)
        if result is None:
            return {"tool_output": "", "rag_output": prompts.ASSESSMENT_FALLBACK}
        return {"tool_output": result}

    def retrieve_node(state):
        q = _last_user_text(state["messages"])
        if state.get("tool_output"):
            # follow the numbers with advice retrieval (nodes.py:92 behavior)
            q = q + " 健康建议"
        docs = store.similarity_search(q, k=top_k)
        return {
            "documents": [
                {"text": d.text, "metadata": d.metadata, "score": d.score}
                for d in docs
            ],
            "loop_step": state.get("loop_step", 0) + 1,
        }

    def web_search_node(state):
        q = _last_user_text(state["messages"])
        docs = []
        if web_search is not None:
            try:
                for r in list(web_search(q))[: cfg.web_results]:
                    docs.append({
                        "text": f"{r.get('title', '')}\n{r.get('content', '')}".strip(),
                        "metadata": {"source": r.get("url", "web")},
                        "score": 0.0,
                    })
            except Exception:
                docs = []                # fail-open: empty docs, loop continues
        return {"documents": docs, "used_web_search": True}

    def grade_and_generate_node(state):
        q = _last_user_text(state["messages"])
        docs = state.get("documents", [])
        graded = docs[: cfg.grade_docs]

        relevant = False
        if graded:
            if grade_fn is not None:
                relevant = bool(grade_fn(q, [d["text"] for d in graded]))
            else:
                verdict = llm.complete(prompts.GRADE_PROMPT.format(
                    question=q, documents=_format_docs(graded)))
                relevant = "yes" in verdict.strip().lower()

        if relevant:
            profile = state.get("health_profile", "")
            profile_section = (
                prompts.PROFILE_SECTION.format(profile=profile) if profile else ""
            )
            # compressed conversation context (science-QA REPL feeds it via
            # the state's summary key — previously summarization ran but its
            # output reached nothing)
            if state.get("summary"):
                profile_section += (
                    f"\n【此前对话摘要】\n{state['summary']}\n")
            source_tag = "网络检索" if state.get("used_web_search") else "本地知识库"
            question = q
            if state.get("tool_output"):
                question = f"{q}\n（已计算的健康指标：{state['tool_output']}）"
            answer = llm.complete(prompts.GENERATE_PROMPT.format(
                question=question,
                documents=_format_docs(docs),
                profile_section=profile_section,
                source_tag=source_tag,
            ))
            return {"rag_output": answer, "final_answer": "ready"}

        if state.get("loop_step", 0) >= cfg.max_retrieval_loops:
            if web_search is not None and not state.get("used_web_search"):
                return {"final_answer": "go_web"}
            answer = llm.complete(prompts.BEST_EFFORT_PROMPT.format(question=q))
            return {"rag_output": answer, "final_answer": "ready"}

        rewritten = llm.complete(prompts.REWRITE_PROMPT.format(question=q)).strip()
        # append → messages[-1] becomes the next query (preserved quirk)
        return {"messages": [user(rewritten)], "final_answer": ""}

    def summarizer_node(state):
        body = state.get("rag_output", "")
        if state.get("tool_output"):
            body = f"【健康指标】{state['tool_output']}\n\n{body}"
        elif state.get("mode") == "assessment":
            # assessment was requested but the numbers could not be parsed:
            # surface the provide-your-data hint instead of dropping it (the
            # reference's fallback never reached the user — conscious fix,
            # SURVEY appendix "vestigial assessment_tool")
            body = f"{prompts.ASSESSMENT_FALLBACK}\n\n{body}"
        mode_tag = "健康评估" if state.get("mode") == "assessment" else "健康科普"
        final = (
            f"┏━━ {mode_tag} ━━━━━━━━━━━━━━\n"
            f"{body}\n"
            f"┗━━━━━━━━━━━━━━━━━━━━━━\n"
            f"以上内容仅供参考，不构成诊疗建议。"
        )
        return {"final_answer": final, "messages": [ai(final)]}

    return {
        "router": router_node,
        "assessment_tool": assessment_tool_node,
        "retrieve": retrieve_node,
        "web_search": web_search_node,
        "grade_loop": grade_and_generate_node,
        "summarizer": summarizer_node,
    }
