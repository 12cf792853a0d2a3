# Copy of mediquery_rag_tpu/graph/state.py (the port imports nothing of the JAX package).
"""Medical graph state schema + mode detection.

State-key parity with the reference's ``MedicalState`` TypedDict
(graph.py:25-40); mode detection reproduces the behavioral contract of
``detect_mode`` (core/utils.py:13-46): structured-consultation queries
bypass to science mode via their template markers, numeric+keyword
questions go to assessment, everything else is science QA.
"""

from __future__ import annotations

import re

from mediquery_rag_tpu_torch.graph.engine import append_reducer

# markers the consultation layer embeds in its RAG prompt templates; their
# presence must force science mode (reference core/utils.py:26-27 quirk,
# preserved deliberately — the consultation has already run its own calc).
STRUCTURED_MARKERS = ("【咨询需求】", "不需要计算")

ASSESSMENT_KEYWORDS = (
    "计算", "算一下", "BMI", "bmi", "体脂", "基础代谢", "理想体重",
    "身高", "体重", "热量", "卡路里",
)


def detect_mode(text: str) -> str:
    """Returns "assessment" or "science"."""
    if any(m in text for m in STRUCTURED_MARKERS):
        return "science"
    has_digit = bool(re.search(r"\d", text))
    has_kw = any(k in text for k in ASSESSMENT_KEYWORDS)
    if has_digit and has_kw:
        return "assessment"
    return "science"


def medical_reducers() -> dict:
    return {"messages": append_reducer}


def initial_state(user_id: str = "anonymous") -> dict:
    return {
        "messages": [],
        "mode": "science",
        "user_id": user_id,
        "documents": [],
        "loop_step": 0,
        "used_web_search": False,
        "health_profile": "",
        "tool_output": "",
        "rag_output": "",
        "final_answer": "",
        "summary": "",
    }
