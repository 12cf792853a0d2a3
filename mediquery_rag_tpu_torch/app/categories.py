# Copy of mediquery_rag_tpu/app/categories.py (the port imports nothing of the JAX package).
"""Health-record category schema (parity with settings.py:48-74's
HEALTH_CATEGORIES: five categories with importance flags)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Category:
    key: str
    label: str
    emoji: str
    important: bool   # records here surface under the ⚠️ header


HEALTH_CATEGORIES: dict[str, Category] = {
    "allergy": Category("allergy", "过敏史", "⚠️", True),
    "medication": Category("medication", "用药情况", "💊", True),
    "disease": Category("disease", "疾病史", "🏥", True),
    "lifestyle": Category("lifestyle", "生活习惯", "🏃", False),
    "basic": Category("basic", "基本信息", "📋", False),
}


def category_of(key: str) -> Category:
    return HEALTH_CATEGORIES.get(key, HEALTH_CATEGORIES["basic"])
