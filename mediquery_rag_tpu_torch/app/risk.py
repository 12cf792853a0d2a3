# Copy of mediquery_rag_tpu/app/risk.py (the port imports nothing of the JAX package).
"""Risk triage: deterministic hard rules + LLM triage with explicit
fail-open policy.

Contract parity with structured_consultation.py:
- emergency keyword hard rule → CRITICAL with hotline message (:813-828,
  :43-47) — deterministic, never depends on the LLM;
- LLM "triage nurse" JSON assessment for other answers (:835-919);
- final-assessment MEDIUM rule: symptom keyword hit or severity >= 7
  (:921-944).

Design decision surfaced by SURVEY §5: the reference fails *open to LOW*
when the LLM JSON parse fails — clinically fail-unsafe. The policy is now a
config knob (``ConsultationConfig.risk_fail_mode``): "low" reproduces the
reference, "medium" is the safer default-able choice. Default preserves
reference behavior.
"""

from __future__ import annotations

from dataclasses import dataclass

from mediquery_rag_tpu_torch.config import ConsultationConfig
from mediquery_rag_tpu_torch.llm.client import extract_json

CRITICAL = "CRITICAL"
HIGH = "HIGH"
MEDIUM = "MEDIUM"
LOW = "LOW"

# deterministic hard-rule triggers (self-harm / acute emergencies)
EMERGENCY_KEYWORDS = (
    "自杀", "自残", "轻生", "不想活", "活不下去", "结束生命",
    "胸口剧痛", "呼吸困难", "意识不清", "昏迷", "大出血", "抽搐不止",
)

# symptom keywords that floor the final assessment at MEDIUM
MEDIUM_KEYWORDS = (
    "胸闷", "胸痛", "心悸", "晕倒", "晕厥", "便血", "咯血", "剧烈头痛",
    "持续发烧", "高烧", "体重骤降",
)

HOTLINE_MESSAGE = (
    "⚠️ 检测到紧急情况。请立即拨打急救电话 120。\n"
    "如有轻生念头，请拨打心理援助热线 12356（24小时）。\n"
    "你并不孤单，现在就寻求帮助。"
)

TRIAGE_PROMPT = """你是一名分诊护士。根据用户在问诊中的回答评估风险等级。
输出 JSON：{{"risk": "CRITICAL|HIGH|MEDIUM|LOW", "severity": 0-10, "reason": "一句话"}}

评估标准：
- CRITICAL：需要立即急救（急性心梗/卒中征象、严重外伤、自伤风险）
- HIGH：应当尽快就医（持续胸痛、反复晕厥、急性感染恶化）
- MEDIUM：建议近期就诊（持续不缓解的明显症状）
- LOW：可以观察（轻微、偶发、已好转的症状）

问题：{question}
用户回答：{answer}

JSON："""


@dataclass(frozen=True)
class RiskAssessment:
    level: str
    severity: int = 0
    reason: str = ""
    message: str = ""
    source: str = "rule"     # rule | llm | fallback


def keyword_emergency(text: str) -> bool:
    return any(k in text for k in EMERGENCY_KEYWORDS)


def assess_answer_risk(
    question: str, answer: str, llm,
    cfg: ConsultationConfig = ConsultationConfig(),
) -> RiskAssessment:
    """Hard rule first; else LLM triage; parse failure → cfg.risk_fail_mode."""
    if keyword_emergency(answer):
        return RiskAssessment(CRITICAL, 10, "触发紧急关键词",
                              HOTLINE_MESSAGE, "rule")
    try:
        from mediquery_rag_tpu_torch.models.constrain import RISK_SCHEMA

        # on-device decoder clients grammar-constrain the reply to RISK_SCHEMA
        # (valid triage JSON by construction); HTTP/fake clients ignore it
        raw = llm.complete(TRIAGE_PROMPT.format(question=question,
                                                answer=answer),
                           schema=RISK_SCHEMA)
        data = extract_json(raw)
        level = str(data["risk"]).upper()
        if level not in (CRITICAL, HIGH, MEDIUM, LOW):
            raise ValueError(level)
        # severity/reason are optional garnish: a malformed severity (null,
        # "8分", ...) must NOT discard an already-valid CRITICAL/HIGH level
        try:
            severity = int(float(data.get("severity") or 0))
        except (TypeError, ValueError):
            severity = 10 if level == CRITICAL else 0
        reason = str(data.get("reason", ""))
        message = ""
        if level == CRITICAL:
            message = HOTLINE_MESSAGE
        elif level == HIGH:
            message = f"⚠️ 风险提示：{reason}。建议尽快就医。"
        return RiskAssessment(level, severity, reason, message, "llm")
    except Exception:
        fallback = MEDIUM if cfg.risk_fail_mode == "medium" else LOW
        return RiskAssessment(fallback, 0, "风险评估不可用", "", "fallback")


def final_assessment(
    answers_text: str, max_severity: int, current_level: str
) -> str:
    """Session-end floor rule: keyword hit or severity >= 7 → at least MEDIUM."""
    order = [LOW, MEDIUM, HIGH, CRITICAL]
    level = current_level if current_level in order else LOW
    if any(k in answers_text for k in MEDIUM_KEYWORDS) or max_severity >= 7:
        if order.index(level) < order.index(MEDIUM):
            level = MEDIUM
    return level
