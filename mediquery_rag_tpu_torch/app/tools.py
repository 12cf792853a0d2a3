# Copy of mediquery_rag_tpu/app/tools.py (the port imports nothing of the JAX package).
"""Pure health calculators (capability parity with src/tools.py:23-68).

The reference registered an *empty* LLM tool list (tools.py:10-12) so its
tool-agent path was a no-op fallback (SURVEY appendix). Here the calculators
are wired live: the assessment node extracts parameters and calls them
directly — deterministic code needs no LLM tool-calling round trip.
"""

from __future__ import annotations

import re


def calculate_bmi(weight_kg: float, height_cm: float) -> dict:
    h = height_cm / 100.0
    bmi = weight_kg / (h * h)
    if bmi < 18.5:
        category = "偏瘦"
    elif bmi < 24.0:
        category = "正常"          # Chinese adult standard (WS/T 428)
    elif bmi < 28.0:
        category = "超重"
    else:
        category = "肥胖"
    return {"bmi": round(bmi, 1), "category": category}


def calculate_bmr(weight_kg: float, height_cm: float, age: int, gender: str) -> dict:
    """Mifflin-St Jeor."""
    base = 10.0 * weight_kg + 6.25 * height_cm - 5.0 * age
    bmr = base + (5.0 if gender in ("男", "male", "m", "M") else -161.0)
    return {"bmr_kcal": round(bmr)}


def calculate_ideal_weight(height_cm: float, gender: str) -> dict:
    """BMI-target method: 22 for men, 21 for women (same factors as the
    reference, tools.py:49-61)."""
    h = height_cm / 100.0
    factor = 22.0 if gender in ("男", "male", "m", "M") else 21.0
    return {"ideal_weight_kg": round(factor * h * h, 1)}


PURE_CALC_TOOLS = {
    "bmi": calculate_bmi,
    "bmr": calculate_bmr,
    "ideal_weight": calculate_ideal_weight,
}


_HEIGHT = re.compile(r"身高\s*[:：]?\s*(\d{2,3}(?:\.\d+)?)\s*(?:cm|厘米|公分)?|(\d{3})\s*(?:cm|厘米|公分)")
_WEIGHT = re.compile(r"体重\s*[:：]?\s*(\d{2,3}(?:\.\d+)?)\s*(?:kg|公斤|千克)?|(\d{2,3}(?:\.\d+)?)\s*(?:kg|公斤|千克)")
_AGE = re.compile(r"(\d{1,3})\s*岁|年龄\s*[:：]?\s*(\d{1,3})")
_MALE = ("男", "先生", "male")
_FEMALE = ("女", "女士", "female")


def parse_body_params(text: str) -> dict:
    """Extract height/weight/age/gender from free text; missing keys omitted."""
    out: dict = {}
    m = _HEIGHT.search(text)
    if m:
        out["height_cm"] = float(m.group(1) or m.group(2))
    m = _WEIGHT.search(text)
    if m:
        val = float(m.group(1) or m.group(2))
        if val != out.get("height_cm"):
            out["weight_kg"] = val
    m = _AGE.search(text)
    if m:
        out["age"] = int(m.group(1) or m.group(2))
    if any(g in text for g in _MALE):
        out["gender"] = "男"
    elif any(g in text for g in _FEMALE):
        out["gender"] = "女"
    return out


def run_assessment(text: str) -> str | None:
    """Run every calculator the text has parameters for; None if not even
    BMI is computable."""
    p = parse_body_params(text)
    if "height_cm" not in p or "weight_kg" not in p:
        return None
    parts = []
    bmi = calculate_bmi(p["weight_kg"], p["height_cm"])
    parts.append(f"BMI：{bmi['bmi']}（{bmi['category']}）")
    if "gender" in p:
        iw = calculate_ideal_weight(p["height_cm"], p["gender"])
        parts.append(f"理想体重：约 {iw['ideal_weight_kg']} kg")
        if "age" in p:
            bmr = calculate_bmr(p["weight_kg"], p["height_cm"], p["age"], p["gender"])
            parts.append(f"基础代谢率：约 {bmr['bmr_kcal']} kcal/天")
    return "；".join(parts)
