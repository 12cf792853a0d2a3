# Copy of mediquery_rag_tpu/app/memory/health_extractor.py (the port imports nothing of the JAX package); a failed extraction is logged.
"""LLM health-fact extraction → profile store (the long-term memory write
path; capability parity with src/memory/health_extractor.py).

Contract preserved: anonymous users are skipped; the LLM returns a JSON
array of {category, content, important}; markdown fences and prose are
tolerated; parse failures are swallowed (fail-open — extraction is an
enhancement, never a blocker); records are deduped by the store.
"""

from __future__ import annotations

import logging

from mediquery_rag_tpu_torch.app.categories import HEALTH_CATEGORIES, category_of
from mediquery_rag_tpu_torch.app.memory.profile_store import ProfileStore
from mediquery_rag_tpu_torch.llm.client import extract_json
from mediquery_rag_tpu_torch.models.constrain import EXTRACT_SCHEMA

EXTRACTION_PROMPT = """从下面这句用户的话中提取值得长期记住的健康信息。
只提取明确陈述的事实（过敏、正在用的药、确诊疾病、生活习惯、身高体重年龄等），
不要推测。没有可提取的信息时输出空数组 []。

输出 JSON 数组，每项格式：
{{"category": "allergy|medication|disease|lifestyle|basic", "content": "...", "important": true/false}}

其中 allergy/medication/disease 类信息 important 恒为 true。

用户的话：{question}

JSON："""


def extract_health_info(
    question: str, user_id: str, llm, store: ProfileStore, hitl=None
) -> int:
    """Extract and persist health facts. Returns #records stored/queued.

    With a ``hitl`` (HITLManager), records route through the review queue:
    LOW-risk extractions auto-approve into the store, allergy/medication/
    disease extractions wait for human sign-off — LLM hallucinations of
    safety-critical facts must not flow straight into every future prompt.
    Without one, records are stored directly (the reference's behavior).
    """
    if user_id == "anonymous" or not question.strip():
        return 0
    try:
        raw = llm.complete(EXTRACTION_PROMPT.format(question=question),
                           schema=EXTRACT_SCHEMA)
        items = extract_json(raw)
        if not isinstance(items, list):
            return 0
        records = []
        for item in items:
            if not isinstance(item, dict):
                continue
            content = str(item.get("content", "")).strip()
            if not content:
                continue
            cat = str(item.get("category", "basic"))
            if cat not in HEALTH_CATEGORIES:
                cat = "basic"
            important = bool(item.get("important", False)) or category_of(cat).important
            records.append({"category": cat, "content": content,
                            "important": important})
        if not records:
            return 0
        if hitl is not None:
            hitl.submit(user_id, question, records)
            return len(records)
        stored = 0
        for r in records:
            if store.add_health_record(user_id, r["category"], r["content"],
                                       r["important"]):
                stored += 1
        return stored
    except Exception:                             # fail-open by contract,
        logging.getLogger(__name__).warning(      # but never silently
            "health-profile extraction failed", exc_info=True)
        return 0


def load_health_profile(user_id: str, store: ProfileStore) -> str:
    """Render the profile as prompt text: important items under a ⚠️ header
    first, the rest grouped by category (parity: health_extractor.py:109-155)."""
    records = store.get_health_records(user_id)
    if not records:
        return ""
    important = [r for r in records if r.important]
    normal = [r for r in records if not r.important]
    lines: list[str] = []
    if important:
        lines.append("【⚠️ 重要提醒】")
        for r in important:
            lines.append(f"- {category_of(r.category).label}：{r.content}")
    if normal:
        by_cat: dict[str, list[str]] = {}
        for r in normal:
            by_cat.setdefault(r.category, []).append(r.content)
        for cat, items in by_cat.items():
            c = category_of(cat)
            lines.append(f"【{c.emoji} {c.label}】")
            lines.extend(f"- {x}" for x in items)
    return "\n".join(lines)
