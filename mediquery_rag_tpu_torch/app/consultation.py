# Copy of mediquery_rag_tpu/app/consultation.py (the port imports nothing of the JAX package).
"""Structured multi-stage intake consultation.

Capability parity with src/consultation/structured_consultation.py (the
reference's largest component, 1214 LoC — SURVEY §3.3): staged question
bank, phone→hash identity, JSON persistence after every answer, LLM-driven
follow-up questioning with transcript replay (max 3 rounds), duplicate-
question avoidance, real-time + final risk triage, background calculator
analysis, session history summaries, similar-history matching, and a
Markdown history export. The public method names match the reference's API
surface (identify_user / start_session / get_current_question /
process_answer / get_consultation_summary ...) so reference users can
switch without relearning the flow.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
import uuid
from dataclasses import asdict, dataclass, field

from mediquery_rag_tpu_torch.app import tools
from mediquery_rag_tpu_torch.app.risk import (
    CRITICAL, LOW, RiskAssessment, assess_answer_risk, final_assessment,
)
from mediquery_rag_tpu_torch.config import ConsultationConfig
from mediquery_rag_tpu_torch.llm.client import extract_json
from mediquery_rag_tpu_torch.llm.messages import ai, system, user


# -- stages & questions --------------------------------------------------------

class Stage:
    BASIC_INFO = "basic_info"
    MEDICAL_HISTORY = "medical_history"
    CONSULTATION_TYPE = "consultation_type"
    CURRENT_SYMPTOMS = "current_symptoms"
    ASSESSMENT = "assessment"
    FOLLOWUP = "followup"
    COMPLETE = "complete"


@dataclass(frozen=True)
class Question:
    key: str
    text: str
    qtype: str = "text"              # text | number | choice | multi
    options: tuple = ()
    store_in: str = "session"        # profile | session
    important: bool = False          # triggers real-time risk triage
    triggers_followup: bool = False  # may spawn LLM follow-up questions
    optional: bool = False


QUESTIONS: dict[str, list[Question]] = {
    Stage.BASIC_INFO: [
        Question("name", "请问怎么称呼您？", "text", store_in="profile"),
        Question("age", "您的年龄是？", "number", store_in="profile"),
        Question("gender", "您的性别是？", "choice", ("男", "女"), store_in="profile"),
        Question("height_cm", "您的身高是多少厘米？", "number", store_in="profile"),
        Question("weight_kg", "您的体重是多少公斤？", "number", store_in="profile"),
    ],
    Stage.MEDICAL_HISTORY: [
        Question("chronic", "您有确诊的慢性疾病吗？（如高血压、糖尿病，没有请答无）",
                 "text", store_in="profile", important=True),
        Question("family_history",
                 "您的直系亲属中有人患以下疾病吗？（可多选，逗号分隔）",
                 "multi", ("高血压", "糖尿病", "心脏病", "脑卒中", "癌症", "无"),
                 store_in="profile"),
        Question("allergy", "您有药物或食物过敏吗？（没有请答无）",
                 "text", store_in="profile", important=True),
        Question("medication", "您目前在长期服用哪些药物？（没有请答无）",
                 "text", store_in="profile", important=True),
    ],
    Stage.CONSULTATION_TYPE: [
        Question("consult_type", "本次咨询的类型是？", "choice",
                 ("健康管理", "症状咨询")),
    ],
    Stage.CURRENT_SYMPTOMS: [
        Question("chief_complaint", "请描述您目前最主要的不适（主诉）。",
                 "text", important=True, triggers_followup=True),
        Question("duration", "这个症状持续多久了？", "text"),
        Question("severity", "症状的严重程度如何？0-10 打个分。", "number",
                 important=True),
    ],
    Stage.ASSESSMENT: [
        Question("health_goal", "您最想改善的健康目标是什么？（如减重、睡眠、血压）",
                 "text", triggers_followup=True),
        Question("exercise", "您目前每周的运动情况如何？", "text"),
        Question("sleep", "您平均每晚睡几个小时？", "number"),
    ],
}

# numeric sanity ranges per question key (reference parity:
# structured_consultation.py:195-212 validates age 0-120, height 50-250,
# weight 20-300, severity bounds); out-of-range answers are re-asked
NUMERIC_BOUNDS: dict[str, tuple[float, float, str]] = {
    "age": (0, 120, "年龄应在 0-120 之间"),
    "height_cm": (50, 250, "身高应在 50-250 厘米之间"),
    "weight_kg": (20, 300, "体重应在 20-300 公斤之间"),
    "severity": (0, 10, "严重程度请打 0-10 分"),
    "sleep": (0, 24, "每晚睡眠小时数应在 0-24 之间"),
}

FOLLOWUP_PROMPT = """你是一名问诊医生助理。根据用户档案和已收集的回答，判断是否需要
再追问一个问题来澄清病情。只在确实有关键信息缺失时追问。

输出 JSON：
{{"need_followup": true/false, "question": "追问内容", "options": ["选项1", ...]（最多4个，可为空数组）, "reason": "追问原因"}}

用户主诉：{chief_complaint}
"""

ANALYSIS_PROMPT = """根据这些健康指标，用一句话（不超过50字）给出客观的身体状况评价，
不要诊断，不要夸大：{metrics}
评价："""


# -- data ----------------------------------------------------------------------

@dataclass
class UserProfile:
    user_id: str
    phone_hash: str = ""
    name: str = ""
    age: int | None = None
    gender: str = ""
    height_cm: float | None = None
    weight_kg: float | None = None
    # None = never asked; "无"/"" = asked and answered none. The distinction
    # is load-bearing: completeness must require that allergy/medication were
    # actually ASKED — an or-chain here once let a session that aborted after
    # the chronic question mark the profile complete and skip drug-allergy
    # collection for every future consultation.
    chronic: str | None = None
    allergy: str | None = None
    medication: str | None = None
    # multi-choice list (["无"] = asked, none); not part of is_complete so
    # profiles saved before this field existed stay complete
    family_history: list | None = None
    created_at: float = field(default_factory=time.time)

    def is_complete(self) -> bool:
        return all([
            self.name, self.age is not None, self.gender,
            self.height_cm is not None, self.weight_kg is not None,
            self.chronic is not None,
            self.allergy is not None,
            self.medication is not None,
        ])


@dataclass
class ConsultationSession:
    session_id: str
    user_id: str
    stage: str = Stage.BASIC_INFO
    consult_type: str = ""            # 健康管理 | 症状咨询
    answers: dict = field(default_factory=dict)
    followup_qa: list = field(default_factory=list)   # [{"q":..., "a":...}]
    followup_rounds: int = 0
    pending_followup: dict | None = None
    risk_level: str = LOW
    max_severity: int = 0
    risk_messages: list = field(default_factory=list)
    health_metrics: str = ""
    health_analysis: str = ""
    started_at: float = field(default_factory=time.time)
    completed_at: float | None = None


# -- the machine ---------------------------------------------------------------

class StructuredConsultation:
    def __init__(self, llm, data_dir: str = "user_data",
                 cfg: ConsultationConfig = ConsultationConfig()):
        self.llm = llm
        self.data_dir = data_dir
        self.cfg = cfg
        self.profile: UserProfile | None = None
        self.session: ConsultationSession | None = None

    # -- identity & persistence ---------------------------------------------

    @staticmethod
    def _user_id_from_phone(phone: str) -> str:
        digest = hashlib.md5(phone.strip().encode()).hexdigest()
        return str(uuid.UUID(digest))

    def _user_dir(self, user_id: str) -> str:
        return os.path.join(self.data_dir, user_id)

    def _profile_path(self, user_id: str) -> str:
        return os.path.join(self._user_dir(user_id), "profile.json")

    def identify_user(self, phone: str) -> UserProfile:
        """phone → md5 → UUID user id; load or create the profile JSON
        (identity parity: s_c.py:305-329)."""
        user_id = self._user_id_from_phone(phone)
        path = self._profile_path(user_id)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.profile = UserProfile(**json.load(f))
        else:
            self.profile = UserProfile(
                user_id=user_id,
                phone_hash=hashlib.md5(phone.strip().encode()).hexdigest(),
            )
            self._save_profile()
        return self.profile

    def peek_user(self, phone: str) -> UserProfile | None:
        """Read-only lookup: load the profile if it exists, create NOTHING.
        (identify_user persists a fresh profile — wrong for view/probe
        flows, which once minted an orphan profile dir per typo.)"""
        user_id = self._user_id_from_phone(phone)
        path = self._profile_path(user_id)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            self.profile = UserProfile(**json.load(f))
        return self.profile

    @staticmethod
    def _atomic_json(path: str, obj) -> None:
        # write-then-rename: a crash mid-write must never leave a truncated
        # JSON behind (these files are re-read on every future login)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False, indent=2)
        os.replace(tmp, path)

    def _save_profile(self) -> None:
        os.makedirs(self._user_dir(self.profile.user_id), exist_ok=True)
        self._atomic_json(self._profile_path(self.profile.user_id),
                          asdict(self.profile))

    def _save_session(self) -> None:
        d = os.path.join(self._user_dir(self.session.user_id), "sessions")
        os.makedirs(d, exist_ok=True)
        self._atomic_json(os.path.join(d, f"{self.session.session_id}.json"),
                          asdict(self.session))

    # -- session lifecycle ---------------------------------------------------

    def start_session(self) -> str:
        """Returns the starting stage. Complete profiles skip straight to
        consultation type + background health analysis (s_c.py:366-384)."""
        if self.profile is None:
            raise RuntimeError("identify_user first")
        self.session = ConsultationSession(
            session_id=time.strftime("%Y%m%d_%H%M%S") + "_" + uuid.uuid4().hex[:6],
            user_id=self.profile.user_id,
        )
        if self.profile.is_complete():
            self.session.stage = Stage.CONSULTATION_TYPE
            self._perform_health_analysis()
        else:
            self.session.stage = Stage.BASIC_INFO
        self._save_session()
        return self.session.stage

    def _perform_health_analysis(self) -> None:
        p = self.profile
        if p.height_cm is None or p.weight_kg is None:
            return
        text = f"身高{p.height_cm}cm 体重{p.weight_kg}kg"
        if p.age is not None:
            text += f" {p.age}岁"
        if p.gender:
            text += f" {p.gender}"
        metrics = tools.run_assessment(text)
        if metrics is None:
            return
        self.session.health_metrics = metrics
        try:
            self.session.health_analysis = self.llm.complete(
                ANALYSIS_PROMPT.format(metrics=metrics)).strip()
        except Exception:
            self.session.health_analysis = ""     # analysis is best-effort

    # -- question flow -------------------------------------------------------

    def _stage_questions(self) -> list[Question]:
        return QUESTIONS.get(self.session.stage, [])

    def _is_answered(self, q: Question) -> bool:
        if q.store_in == "profile":
            return getattr(self.profile, q.key, None) not in (None, "")
        return q.key in self.session.answers

    def _already_collected(self, q: Question) -> bool:
        """Skip static questions whose info the follow-up dialogue already
        covered (keyword heuristic parity: s_c.py:521-534)."""
        if not self.session.followup_qa:
            return False
        text = " ".join(f"{x['q']} {x['a']}" for x in self.session.followup_qa)
        keys = {
            "duration": ("多久", "几天", "几周", "持续"),
            "severity": ("严重", "程度", "打分", "几分"),
        }.get(q.key, ())
        return any(k in text for k in keys)

    def get_current_question(self) -> dict | None:
        """Pending AI follow-up first, then the next unanswered static
        question; auto-advances through exhausted stages. None only when the
        session is COMPLETE."""
        while True:
            if self.session.stage == Stage.COMPLETE:
                return None
            if self.session.pending_followup:
                f = self.session.pending_followup
                return {"key": "__followup__", "text": f["question"],
                        "qtype": "choice" if f.get("options") else "text",
                        "options": tuple(f.get("options") or ()),
                        "source": "ai", "reason": f.get("reason", "")}
            for q in self._stage_questions():
                if not self._is_answered(q) and not self._already_collected(q):
                    return {"key": q.key, "text": q.text, "qtype": q.qtype,
                            "options": q.options, "source": "bank"}
            self._advance_stage()

    def _validate(self, q_key: str, qtype: str, options: tuple, answer: str):
        a = answer.strip()
        if not a:
            return None, "回答不能为空，请重新输入。"
        if qtype == "number":
            try:
                v = float(a.replace("岁", "").replace("cm", "").replace("kg", ""))
            except ValueError:
                return None, "请输入数字。"
            if not math.isfinite(v):               # 'inf'/'nan' parse as float
                return None, "请输入数字。"
            bounds = NUMERIC_BOUNDS.get(q_key)
            if bounds and not (bounds[0] <= v <= bounds[1]):
                return None, f"{bounds[2]}，请重新输入。"
            return (int(v) if v == int(v) else v), None
        if qtype == "choice":
            if a in options:
                return a, None
            if a.isdigit() and 1 <= int(a) <= len(options):
                return options[int(a) - 1], None
            return None, f"请从选项中选择：{' / '.join(options)}"
        if qtype == "multi":
            parts = [p.strip() for p in a.replace("，", ",").split(",") if p.strip()]
            bad = [p for p in parts if options and p not in options]
            if bad:
                return None, f"无效选项：{'、'.join(bad)}"
            return parts, None
        return a, None

    def process_answer(self, answer: str) -> dict:
        """Validate, store, triage, maybe spawn a follow-up, advance stage.

        Returns {"ok", "error"?, "risk"?: RiskAssessment, "stage"}.
        """
        cur = self.get_current_question()
        if cur is None:
            return {"ok": True, "stage": self.session.stage}

        value, err = self._validate(
            cur["key"], cur["qtype"], cur.get("options", ()), answer)
        if err:
            return {"ok": False, "error": err, "stage": self.session.stage}

        result: dict = {"ok": True}

        if cur["key"] == "__followup__":
            self.session.followup_qa.append(
                {"q": cur["text"], "a": str(value)})
            self.session.pending_followup = None
        else:
            self._store_answer(cur["key"], value)
            if cur["key"] == "consult_type":
                self.session.consult_type = str(value)

        q_meta = next((q for q in self._stage_questions()
                       if q.key == cur["key"]), None)
        important = (q_meta.important if q_meta else True)
        if important and isinstance(value, (str, int, float)):
            risk = self._assess_realtime(cur["text"], str(value))
            if risk is not None:
                result["risk"] = risk

        triggers = bool(q_meta and q_meta.triggers_followup) or \
            cur["key"] == "__followup__"
        if triggers and self.session.risk_level != CRITICAL:
            self._maybe_followup()

        self.get_current_question()        # drives stage advancement
        result["stage"] = self.session.stage
        self._save_session()
        return result

    def _store_answer(self, key: str, value) -> None:
        self.session.answers[key] = value
        if any(q.key == key and q.store_in == "profile"
               for qs in QUESTIONS.values() for q in qs):
            setattr(self.profile, key, value)
            self._save_profile()
        self._save_session()

    def _assess_realtime(self, question: str, answer: str) -> RiskAssessment | None:
        if answer in ("无", "没有", "没", "否"):
            return None
        r = assess_answer_risk(question, answer, self.llm, self.cfg)
        order = [LOW, "MEDIUM", "HIGH", CRITICAL]
        if order.index(r.level) > order.index(self.session.risk_level):
            self.session.risk_level = r.level
        self.session.max_severity = max(self.session.max_severity, r.severity)
        if r.message:
            self.session.risk_messages.append(r.message)
        return r

    def _maybe_followup(self) -> None:
        """LLM decides whether to ask one more question, replaying the
        follow-up transcript as chat turns (s_c.py:589-642 contract);
        capped at cfg.max_followup_rounds; parse failure → skip."""
        if self.session.followup_rounds >= self.cfg.max_followup_rounds:
            self.session.pending_followup = None
            return
        chief = str(self.session.answers.get(
            "chief_complaint", self.session.answers.get("health_goal", "")))
        msgs = [system(FOLLOWUP_PROMPT.format(chief_complaint=chief))]
        for qa in self.session.followup_qa:
            msgs.append(ai(qa["q"]))
            msgs.append(user(qa["a"]))
        try:
            from mediquery_rag_tpu_torch.models.constrain import FOLLOWUP_SCHEMA

            data = extract_json(
                self.llm.complete(msgs, schema=FOLLOWUP_SCHEMA))
            if data and data.get("need_followup") and data.get("question"):
                options = [str(o) for o in (data.get("options") or [])][:4]
                self.session.pending_followup = {
                    "question": str(data["question"]),
                    "options": options,
                    "reason": str(data.get("reason", "")),
                }
                self.session.followup_rounds += 1
            else:
                self.session.pending_followup = None
        except Exception:
            self.session.pending_followup = None   # fail-open: just move on

    _STAGE_FLOW = {
        Stage.BASIC_INFO: Stage.MEDICAL_HISTORY,
        Stage.MEDICAL_HISTORY: Stage.CONSULTATION_TYPE,
        Stage.CURRENT_SYMPTOMS: Stage.FOLLOWUP,
        Stage.ASSESSMENT: Stage.FOLLOWUP,
        Stage.FOLLOWUP: Stage.COMPLETE,
    }

    def _advance_stage(self) -> None:
        s = self.session
        if s.stage == Stage.CONSULTATION_TYPE:
            nxt = (Stage.ASSESSMENT if s.consult_type == "健康管理"
                   else Stage.CURRENT_SYMPTOMS)
            if not s.health_metrics:
                self._perform_health_analysis()
        else:
            nxt = self._STAGE_FLOW.get(s.stage, Stage.COMPLETE)
        s.stage = nxt
        if nxt == Stage.COMPLETE and s.completed_at is None:
            self._do_final_assessment()
            s.completed_at = time.time()
        self._save_session()

    def _do_final_assessment(self) -> None:
        text = " ".join(str(v) for v in self.session.answers.values())
        text += " " + " ".join(x["a"] for x in self.session.followup_qa)
        self.session.risk_level = final_assessment(
            text, self.session.max_severity, self.session.risk_level)

    @property
    def is_complete(self) -> bool:
        return self.session is not None and self.session.stage == Stage.COMPLETE

    # -- outputs -------------------------------------------------------------

    def get_consultation_summary(self) -> dict:
        p, s = self.profile, self.session
        return {
            "user_id": p.user_id,
            "name": p.name,
            "age": p.age,
            "gender": p.gender,
            "height_cm": p.height_cm,
            "weight_kg": p.weight_kg,
            "chronic": p.chronic,
            "allergy": p.allergy,
            "medication": p.medication,
            "family_history": p.family_history,
            "consult_type": s.consult_type,
            "answers": dict(s.answers),
            "followup_qa": list(s.followup_qa),
            "risk_level": s.risk_level,
            "health_metrics": s.health_metrics,
            "health_analysis": s.health_analysis,
        }

    def get_history_summary(self, last_n: int = 3,
                            include_current: bool = False) -> list[dict]:
        """Most recent completed sessions (parity: s_c.py:986-1066).
        The in-flight session is excluded unless ``include_current`` (used by
        the history export, where it is already completed)."""
        d = os.path.join(self._user_dir(self.profile.user_id), "sessions")
        if not os.path.isdir(d):
            return []
        out = []
        for name in sorted(os.listdir(d), reverse=True):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    data = json.load(f)
            except (json.JSONDecodeError, OSError):
                # a session file truncated by a mid-write crash must not
                # brick every future login for this user — skip it
                continue
            if data.get("completed_at") is None:
                continue
            if (not include_current and self.session
                    and data.get("session_id") == self.session.session_id):
                continue
            out.append({
                "session_id": data["session_id"],
                "date": time.strftime("%Y-%m-%d",
                                      time.localtime(data["started_at"])),
                "consult_type": data.get("consult_type", ""),
                "chief_complaint": data.get("answers", {}).get(
                    "chief_complaint",
                    data.get("answers", {}).get("health_goal", "")),
                "risk_level": data.get("risk_level", LOW),
            })
            if len(out) >= last_n:
                break
        return out

    def find_similar_history(self, complaint: str) -> dict | None:
        """Keyword-overlap match against past chief complaints
        (parity: s_c.py:1068-1123)."""
        if not complaint:
            return None
        grams = {complaint[i : i + 2] for i in range(len(complaint) - 1)}
        best, best_score = None, 0.0
        for h in self.get_history_summary(last_n=20):
            past = str(h.get("chief_complaint", ""))
            if len(past) < 2:
                continue
            pg = {past[i : i + 2] for i in range(len(past) - 1)}
            denom = min(len(grams), len(pg)) or 1
            score = len(grams & pg) / denom
            if score > best_score:
                best, best_score = h, score
        return best if best_score >= 0.3 else None

    def generate_history_markdown(self) -> str:
        """Write user_data/{id}/history.md; returns the path."""
        p = self.profile
        lines = [f"# 问诊历史 — {p.name or p.user_id}", ""]
        if p.age is not None:
            lines.append(f"- 年龄：{p.age}　性别：{p.gender}")
        if p.height_cm is not None:
            lines.append(f"- 身高：{p.height_cm} cm　体重：{p.weight_kg} kg")
        for key, label in (("chronic", "慢性疾病"), ("allergy", "过敏史"),
                           ("medication", "长期用药")):
            v = getattr(p, key)
            if v:
                lines.append(f"- {label}：{v}")
        if p.family_history and p.family_history != ["无"]:
            lines.append(f"- 家族史：{'、'.join(p.family_history)}")
        lines.append("")
        for h in self.get_history_summary(last_n=50, include_current=True):
            lines.append(f"## {h['date']}（{h['consult_type'] or '未分类'}）")
            lines.append(f"- 主诉/目标：{h['chief_complaint'] or '—'}")
            lines.append(f"- 风险等级：{h['risk_level']}")
            lines.append("")
        path = os.path.join(self._user_dir(p.user_id), "history.md")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
        return path

    def build_rag_query(self) -> str:
        """Render the structured summary into the RAG prompt. Two templates
        (health-management vs symptom, parity: ui/interface.py:437-479) both
        carrying the structured markers so detect_mode routes to science."""
        sm = self.get_consultation_summary()
        profile_bits = []
        if sm["age"] is not None:
            profile_bits.append(f"{sm['age']}岁{sm['gender']}")
        if sm["height_cm"] is not None:
            profile_bits.append(f"身高{sm['height_cm']}cm 体重{sm['weight_kg']}kg")
        for key, label in (("chronic", "慢性病"), ("allergy", "过敏"),
                           ("medication", "用药")):
            if sm[key] and sm[key] not in ("无", "没有"):
                profile_bits.append(f"{label}：{sm[key]}")
        fh = sm.get("family_history")
        if fh and fh != ["无"]:
            profile_bits.append(f"家族史：{'、'.join(fh)}")
        profile_line = "；".join(profile_bits) or "未提供"

        if sm["consult_type"] == "健康管理":
            goal = sm["answers"].get("health_goal", "整体健康改善")
            lines = [
                "【咨询需求】健康管理建议（不需要计算，指标已在下方给出）",
                f"【用户情况】{profile_line}",
                f"【健康指标】{sm['health_metrics'] or '未计算'}",
                f"【健康目标】{goal}",
                f"【生活方式】运动：{sm['answers'].get('exercise', '未知')}；"
                f"睡眠：{sm['answers'].get('sleep', '未知')}小时",
                "请针对上述目标给出具体、可执行的健康管理建议。",
            ]
        else:
            qa_lines = [f"问：{x['q']}\n答：{x['a']}" for x in sm["followup_qa"]]
            lines = [
                "【咨询需求】症状相关的健康科普（不需要计算）",
                f"【用户情况】{profile_line}",
                f"【主诉】{sm['answers'].get('chief_complaint', '')}",
                f"【持续时间】{sm['answers'].get('duration', '未知')}",
                f"【严重程度】{sm['answers'].get('severity', '未知')}/10",
            ]
            if qa_lines:
                lines.append("【追问记录】\n" + "\n".join(qa_lines))
            lines.append("请解释可能的原因方向、日常注意事项，以及什么情况下应当就医。")
        return "\n".join(lines)
