"""Parity of the port's consultation CLI with the JAX package, on the CPU.

``app/risk.py``, ``app/consultation.py`` and ``cli/interface.py`` are
copies: every case of ``tests/test_app_consultation.py`` and
``tests/test_cli_interface.py`` runs here against both packages on the same
scripted ``FakeLLM``/``RuleLLM`` replies and ``input()`` scripts, each
package in its own directory, and the two give the same observable results
(risk verdicts, questions asked, summaries, RAG queries, files, terminal
transcripts with the data root masked). The JAX tests' own checks are kept
and run on both. Triage and follow-up decisions through a grammar-
constrained on-device client (``RISK_SCHEMA``, ``FOLLOWUP_SCHEMA``) equal
JAX's on the same weights; and ``python -m mediquery_rag_tpu_torch.cli``
answers a scripted session in a subprocess that cannot import jax, the
JAX package, ``regex``, ``ml_dtypes``, transformers or tokenizers.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import mediquery_rag_tpu.app.consultation as jcons
import mediquery_rag_tpu.app.risk as jrisk
import mediquery_rag_tpu.app.tools as jtools
import mediquery_rag_tpu.config as jconfig
import mediquery_rag_tpu.llm.client as jclient
import mediquery_rag_tpu_torch.app.consultation as tcons
import mediquery_rag_tpu_torch.app.risk as trisk
import mediquery_rag_tpu_torch.app.tools as ttools
import mediquery_rag_tpu_torch.config as tconfig
import mediquery_rag_tpu_torch.llm.client as tclient
from mediquery_rag_tpu.cli import interface as jinterface
from mediquery_rag_tpu.cli.context import AppContext as JAppContext
from mediquery_rag_tpu_torch.cli import interface as tinterface
from mediquery_rag_tpu_torch.cli.context import AppContext as TAppContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs six test processes on the machine's cores, and torch's
    default pool of one thread per core in each oversubscribes them: a
    decode loop of small ops then waits in thread barriers (10x slower
    here). Each test of this file runs torch on one thread; the count is
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ns(cons, risk, tools, config, client):
    return types.SimpleNamespace(
        Stage=cons.Stage, SC=cons.StructuredConsultation, UserProfile=cons.UserProfile,
        risk=risk, tools=tools, Cfg=config.ConsultationConfig, FakeLLM=client.FakeLLM,
        RuleLLM=client.RuleLLM)


PKGS = {"jax": _ns(jcons, jrisk, jtools, jconfig, jclient),
        "port": _ns(tcons, trisk, ttools, tconfig, tclient)}

NO_FOLLOWUP = '{"need_followup": false}'
BASIC = {"name": "张三", "age": "45", "gender": "男", "height_cm": "175", "weight_kg": "80",
         "chronic": "无", "allergy": "无", "medication": "无"}


def make_sc(m, d, llm=None):
    llm = llm or m.RuleLLM([
        (r"need_followup", NO_FOLLOWUP),
        (r"risk", '{"risk": "LOW", "severity": 1, "reason": "轻微"}'),
        (r"评价", "身体指标总体正常。"),
    ])
    return m.SC(llm, data_dir=d)


def drive(sc, answers):
    """Feed scripted answers keyed by question key (callable or str)."""
    seen = []
    for _ in range(50):
        q = sc.get_current_question()
        if q is None:
            break
        seen.append(q["key"])
        a = answers.get(q["key"])
        if a is None:
            a = answers.get("__default__", "无")
        r = sc.process_answer(a() if callable(a) else a)
        assert r["ok"], r
    return seen


def _summary(sc):
    """The session's observable state, without clock-dependent fields."""
    sm = sc.get_consultation_summary()
    s = dataclasses.asdict(sc.session)
    for k in ("session_id", "started_at", "completed_at"):
        s.pop(k)
    return {"summary": sm, "session": s}


def _risk(r):
    return dataclasses.asdict(r)


# -- the cases of tests/test_app_consultation.py ------------------------------------------

def case_bmi(m, d):
    r = m.tools.calculate_bmi(80, 175)
    assert r["bmi"] == 26.1 and r["category"] == "超重"
    return r


def case_parse_params(m, d):
    p = m.tools.parse_body_params("我身高175cm，体重80kg，45岁男")
    assert p == {"height_cm": 175.0, "weight_kg": 80.0, "age": 45, "gender": "男"}
    return p


def case_run_assessment_partial(m, d):
    assert m.tools.run_assessment("就是问问") is None
    out = m.tools.run_assessment("身高160 体重50kg 女 30岁")
    assert "BMI" in out and "基础代谢率" in out
    return out


def case_emergency_keyword_overrides_llm(m, d):
    llm = m.FakeLLM(['{"risk": "LOW"}'])
    r = m.risk.assess_answer_risk("最近感觉如何", "我不想活了", llm)
    assert r.level == m.risk.CRITICAL and r.source == "rule"
    assert "120" in r.message or "12356" in r.message
    assert llm.calls == []
    return _risk(r)


def case_llm_triage_high(m, d):
    llm = m.FakeLLM(['{"risk": "HIGH", "severity": 8, "reason": "持续胸痛"}'])
    r = m.risk.assess_answer_risk("有什么症状", "胸口一直疼", llm)
    assert r.level == m.risk.HIGH and r.severity == 8 and "就医" in r.message
    return _risk(r)


def case_parse_failure_fails_open_low(m, d):
    r = m.risk.assess_answer_risk("q", "头有点晕", m.FakeLLM(["乱七八糟"]))
    assert r.level == m.risk.LOW and r.source == "fallback"
    return _risk(r)


def case_parse_failure_fail_mode_medium(m, d):
    r = m.risk.assess_answer_risk("q", "头有点晕", m.FakeLLM(["乱"]),
                                  m.Cfg(risk_fail_mode="medium"))
    assert r.level == m.risk.MEDIUM
    return _risk(r)


def case_final_assessment_floor(m, d):
    fa, R = m.risk.final_assessment, m.risk
    out = [fa("偶尔胸闷", 0, R.LOW), fa("没什么", 7, R.LOW), fa("没什么", 2, R.LOW),
           fa("胸闷", 9, R.HIGH)]
    assert out == [R.MEDIUM, R.MEDIUM, R.LOW, R.HIGH]
    return out


def case_identity_stable_and_persisted(m, d):
    p1 = make_sc(m, d).identify_user("13800138000")
    p2 = m.SC(m.FakeLLM(), d).identify_user("13800138000")
    assert p1.user_id == p2.user_id
    assert os.path.exists(os.path.join(d, p1.user_id, "profile.json"))
    return [p1.user_id, p1.phone_hash]


def case_full_symptom_flow(m, d):
    sc = make_sc(m, d)
    sc.identify_user("100")
    assert sc.start_session() == m.Stage.BASIC_INFO
    seen = drive(sc, {**BASIC, "consult_type": "症状咨询", "chief_complaint": "最近经常头晕",
                      "duration": "两周", "severity": "4"})
    assert sc.is_complete and "chief_complaint" in seen
    sm = sc.get_consultation_summary()
    assert sm["age"] == 45 and sm["consult_type"] == "症状咨询" and sm["health_metrics"]
    q = sc.build_rag_query()
    assert "【咨询需求】" in q and "头晕" in q
    return [seen, _summary(sc), q, sc.llm.calls]


def case_complete_profile_skips_basics(m, d):
    sc = make_sc(m, d)
    sc.identify_user("101")
    sc.start_session()
    drive(sc, {**BASIC, "consult_type": "健康管理", "health_goal": "减重", "exercise": "很少",
               "sleep": "6"})
    sc2 = make_sc(m, d)
    sc2.identify_user("101")
    stage = sc2.start_session()
    assert stage == m.Stage.CONSULTATION_TYPE and sc2.session.health_metrics
    q = sc2.get_current_question()
    assert q["key"] == "consult_type"
    return [stage, q, _summary(sc2), sc.build_rag_query()]


def case_followup_rounds_capped(m, d):
    llm = m.RuleLLM([
        (r"need_followup",
         '{"need_followup": true, "question": "再追问一下？", "options": [], "reason": "r"}'),
        (r"risk", '{"risk": "LOW", "severity": 0, "reason": ""}'),
        (r"评价", "ok")])
    sc = make_sc(m, d, llm)
    sc.identify_user("102")
    sc.start_session()
    seen = drive(sc, {**BASIC, "consult_type": "症状咨询", "chief_complaint": "咳嗽",
                      "duration": "三天", "severity": "3", "__followup__": "好的"})
    assert sc.is_complete and seen.count("__followup__") == 3
    return [seen, _summary(sc), llm.calls]


def case_critical_stops_followups_and_flags(m, d):
    sc = make_sc(m, d, m.RuleLLM([(r"need_followup", NO_FOLLOWUP), (r"评价", "ok")]))
    sc.identify_user("103")
    sc.start_session()
    drive(sc, {**BASIC, "consult_type": "症状咨询", "chief_complaint": "胸口剧痛到不想活了",
               "duration": "一小时", "severity": "9"})
    assert sc.session.risk_level == m.risk.CRITICAL
    assert any("120" in msg for msg in sc.session.risk_messages)
    return _summary(sc)


def case_validation_rejects_bad_input(m, d):
    sc = make_sc(m, d)
    sc.identify_user("104")
    sc.start_session()
    rs = [sc.process_answer(a) for a in ("张三", "四十五", "45", "外星人", "1")]
    assert not rs[1]["ok"] and "数字" in rs[1]["error"] and rs[2]["ok"]
    assert not rs[3]["ok"] and rs[4]["ok"] and sc.profile.gender == "男"
    return rs


def case_history_and_similarity(m, d):
    sc = make_sc(m, d)
    sc.identify_user("105")
    sc.start_session()
    drive(sc, {**BASIC, "consult_type": "症状咨询", "chief_complaint": "反复头晕目眩",
               "duration": "一周", "severity": "5"})
    sc2 = make_sc(m, d)
    sc2.identify_user("105")
    sc2.start_session()
    hist = sc2.get_history_summary()
    assert len(hist) == 1 and "头晕" in hist[0]["chief_complaint"]
    sim = sc2.find_similar_history("又开始头晕目眩了")
    assert sim is not None and sc2.find_similar_history("脚踝扭伤") is None
    with open(sc2.generate_history_markdown(), encoding="utf-8") as f:
        md = f.read()
    assert "头晕" in md
    for h in hist + [sim]:
        h.pop("session_id")
    return [hist, sim, md]


def case_resume_interrupted_intake(m, d):
    sc = make_sc(m, d)
    sc.identify_user("106")
    sc.start_session()
    sc.process_answer("李四")
    sc.process_answer("30")
    sc2 = make_sc(m, d)
    p = sc2.identify_user("106")
    assert p.name == "李四" and p.age == 30
    sc2.start_session()
    q = sc2.get_current_question()
    assert q["key"] == "gender"
    return [dataclasses.asdict(p) | {"created_at": 0}, q]


def case_severity_parse_failure_keeps_critical(m, d):
    llm = m.FakeLLM(['{"risk": "CRITICAL", "severity": null, "reason": "急性症状"}'])
    r = m.risk.assess_answer_risk("症状", "持续剧烈胸痛并放射到左臂", llm)
    assert r.level == m.risk.CRITICAL and r.message
    return _risk(r)


def case_partial_history_not_complete(m, d):
    p = m.UserProfile(user_id="u", name="张三", age=40, gender="男", height_cm=175.0,
                      weight_kg=70.0, chronic="高血压")
    before = p.is_complete()
    p.allergy = p.medication = "无"
    assert not before and p.is_complete()
    return [before, p.is_complete()]


def case_number_validation_rejects_inf_nan(m, d):
    sc = m.SC(m.FakeLLM(), data_dir=d)
    sc.identify_user("13800000000")
    sc.start_session()
    while sc.get_current_question()["key"] != "age":
        sc.process_answer("测试")
    rs = [sc.process_answer(bad) for bad in ("inf", "nan", "-inf")]
    assert not any(r["ok"] for r in rs)
    return rs


def case_numeric_range_validation(m, d):
    sc = make_sc(m, d)
    sc.identify_user("106")
    sc.start_session()
    rs = [sc.process_answer(a) for a in ("张三", "999", "45", "男", "500", "175", "5", "80")]
    assert not rs[1]["ok"] and "0-120" in rs[1]["error"] and rs[2]["ok"]
    assert not rs[4]["ok"] and "50-250" in rs[4]["error"] and rs[5]["ok"]
    assert not rs[6]["ok"] and "20-300" in rs[6]["error"] and rs[7]["ok"]
    answers = {"chronic": "无", "family_history": "无", "allergy": "无", "medication": "无",
               "consult_type": "症状咨询", "chief_complaint": "头晕", "duration": "一周"}
    while True:
        q = sc.get_current_question()
        if q is None or q["key"] == "severity":
            break
        assert sc.process_answer(answers.get(q["key"], "无"))["ok"]
    rs += [sc.process_answer("15"), sc.process_answer("4")]
    assert not rs[-2]["ok"] and "0-10" in rs[-2]["error"] and rs[-1]["ok"]
    return rs


def case_family_history_multi_choice(m, d):
    sc = make_sc(m, d)
    sc.identify_user("107")
    sc.start_session()
    seen = drive(sc, {**BASIC, "family_history": "高血压，糖尿病", "consult_type": "症状咨询",
                      "chief_complaint": "最近头晕", "duration": "两周", "severity": "4"})
    assert "family_history" in seen and sc.profile.family_history == ["高血压", "糖尿病"]
    q = sc.build_rag_query()
    assert "家族史：高血压、糖尿病" in q
    sc2 = make_sc(m, d)
    sc2.identify_user("108")
    sc2.start_session()
    while sc2.get_current_question()["key"] != "family_history":
        sc2.process_answer(BASIC.get(sc2.get_current_question()["key"], "无"))
    r = sc2.process_answer("外星病")
    assert not r["ok"] and "无效选项" in r["error"]
    assert sc2.process_answer("无")["ok"] and sc2.profile.family_history == ["无"]
    return [seen, q, r]


def case_corrupt_session_file_skipped(m, d):
    sc = m.SC(m.FakeLLM(), data_dir=d)
    p = sc.identify_user("13811112222")
    sc.start_session()
    sd = os.path.join(d, p.user_id, "sessions")
    os.makedirs(sd, exist_ok=True)
    with open(os.path.join(sd, "zzz_corrupt.json"), "w") as f:
        f.write('{"session_id": "trunc')
    assert sc.get_history_summary() == []
    return []


CASES = [f for name, f in sorted(globals().items()) if name.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__[5:] for f in CASES])
def test_consultation_case_matches_jax(case, tmp_path):
    """One case of ``tests/test_app_consultation.py``, run on both
    packages: its checks hold on each and the observable results are
    equal."""
    got = {}
    for name, m in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = json.loads(json.dumps(case(m, str(d)), ensure_ascii=False, default=str))
    assert got["port"] == got["jax"]


# -- the cases of tests/test_cli_interface.py ---------------------------------------------

@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    out = {}
    for name, build, kw in (("jax", JAppContext.build, {}),
                            ("port", TAppContext.build, {"device": "cpu"})):
        root = tmp_path_factory.mktemp(f"cli_{name}")
        os.makedirs(root / "data")
        shutil.copy(CORPUS, root / "data" / "medical_data.txt")
        out[name] = (str(root), build(str(root), fake_llm=True, **kw))
    return out


ADVISOR_BASIC = ["李四", "35", "男", "175", "70", "无", "无", "无", "无"]
SCRIPTS = [   # (name, input() script, what the JAX test checks in the transcript)
    ("quit", ["q"], ["MediQuery-TPU", "再见"]),
    ("eof_quits", [], ["再见"]),
    ("science_qa", ["2", "高血压患者平时吃饭要注意什么", "q", "q"], ["检索到", "健康科普问答"]),
    ("science_qa_blank_line", ["2", "   ", "q", "q"], ["!检索到"]),
    ("advisor_critical_abort", ["1", "13800001111", *ADVISOR_BASIC, "症状咨询",
                                "最近总觉得不想活了", "q"],
     ["问诊终止", "立即就医", "!正在为您生成个性化建议"]),
    ("advisor_anonymous_interrupt", ["1", "", "王五", "40"], ["问诊中止"]),
    ("advisor_full_flow", ["1", "13800002222", *ADVISOR_BASIC, "健康管理", "减重",
                           "每周快走三次", "7", "q"], ["正在为您生成个性化建议", "问诊记录已保存"]),
    ("hitl_review", ["3", "q"], ["审核队列", "本次处理"]),
    ("profile_unknown_phone", ["4", "19999990000", "q"], ["没有问诊档案"]),
    ("profile_after_consultation", ["4", "13800002222", "q"], ["基本档案", "李四"]),
]


def _transcript(interface, ctx, root, script, monkeypatch) -> str:
    it = iter(script)

    def fake_input(prompt=""):
        print(prompt, end="")
        try:
            return next(it)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr("builtins.input", fake_input)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        interface.main_menu(ctx)
    return buf.getvalue().replace(root, "<root>")


@pytest.mark.parametrize("name,script,expect", SCRIPTS, ids=[s[0] for s in SCRIPTS])
def test_cli_session_matches_jax(ctxs, monkeypatch, name, script, expect):
    """One scripted session of ``tests/test_cli_interface.py`` (in its
    order: the profile views read the consultation run before them) through
    ``main_menu`` of both packages: the same terminal transcript, prompts
    included, and the JAX test's checks hold on it."""
    out = {pkg: _transcript(interface, ctxs[pkg][1], ctxs[pkg][0], script, monkeypatch)
           for pkg, interface in (("jax", jinterface), ("port", tinterface))}
    assert out["port"] == out["jax"]
    for e in expect:
        assert (e[1:] not in out["port"]) if e.startswith("!") else (e in out["port"]), e


# -- grammar-constrained triage and follow-up ----------------------------------------------

@pytest.fixture(scope="module")
def constrained_clients():
    """JAX's and the port's on-device clients on the same random weights
    (test_constrain.py's TINY model, greedy)."""
    from mediquery_rag_tpu.llm.tpu_client import TPULLMClient
    from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
    from mediquery_rag_tpu.models.generate import Generator as JGenerator
    from mediquery_rag_tpu_torch.llm import TorchLLMClient
    from mediquery_rag_tpu_torch.models import Generator
    from mediquery_rag_tpu_torch.models.convert import params_from_jax

    cfg = jconfig.DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, mlp_dim=128,
                                max_len=2048, dtype="float32")
    params = JDecoder(cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return {"jax": TPULLMClient(JGenerator(cfg, params=params)),
            "port": TorchLLMClient(Generator(tconfig.DecoderConfig(**cfg.__dict__), tparams,
                                             device="cpu"))}


@pytest.mark.parametrize("answer", ["大概5分吧", "胸口一直疼，晚上更厉害"])
def test_constrained_triage_matches_jax(constrained_clients, answer):
    """``assess_answer_risk`` through a client that decodes under
    ``RISK_SCHEMA``: never the fail-open fallback, and the same verdict as
    JAX's on the same weights."""
    got = {name: _risk(PKGS[name].risk.assess_answer_risk("疼痛程度如何？", answer, llm))
           for name, llm in constrained_clients.items()}
    assert got["port"] == got["jax"] and got["port"]["source"] == "llm"
    assert got["port"]["level"] in {"CRITICAL", "HIGH", "MEDIUM", "LOW"}
    assert 0 <= got["port"]["severity"] <= 10


def test_constrained_followup_matches_jax(constrained_clients, tmp_path):
    """The follow-up decision under ``FOLLOWUP_SCHEMA`` (with a follow-up
    transcript replayed as chat turns) parses and equals JAX's."""
    got = {}
    for name, llm in constrained_clients.items():
        sc = PKGS[name].SC(llm, data_dir=str(tmp_path / name))
        sc.identify_user("109")
        sc.start_session()
        sc.session.answers["chief_complaint"] = "最近两周经常头晕"
        sc.session.followup_qa.append({"q": "头晕时会恶心吗？", "a": "偶尔"})
        sc._maybe_followup()
        got[name] = [sc.session.pending_followup, sc.session.followup_rounds]
    assert got["port"] == got["jax"]


def test_schema_kwarg_ignored_by_fakes():
    from mediquery_rag_tpu_torch.models.constrain import RISK_SCHEMA
    fake = tclient.FakeLLM(['{"risk":"LOW","severity":1,"reason":"x"}'])
    assert json.loads(fake.complete("q", schema=RISK_SCHEMA))["risk"] == "LOW"


# -- the entry point ------------------------------------------------------------------------

_BLOCKED_CLI = r"""
import runpy, sys
for name in ("jax", "mediquery_rag_tpu", "regex", "ml_dtypes", "transformers", "tokenizers"):
    sys.modules[name] = None
sys.argv = ["python -m mediquery_rag_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("mediquery_rag_tpu_torch.cli", run_name="__main__")
"""


def test_cli_module_runs_without_jax(tmp_path):
    """``python -m mediquery_rag_tpu_torch.cli --device cpu --fake-llm``
    answers a science question and exits, in a subprocess where jax, the
    JAX package, ``regex``, ``ml_dtypes``, transformers and tokenizers
    cannot be imported."""
    os.makedirs(tmp_path / "data")
    shutil.copy(CORPUS, tmp_path / "data" / "medical_data.txt")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CLI, "--device", "cpu", "--fake-llm",
         "--root", str(tmp_path)],
        input="2\n高血压患者平时吃饭要注意什么\nq\nq\n", cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "就绪：160 条知识库条目" in out.stdout and "检索到" in out.stdout
    assert "演示模式" in out.stdout and "再见" in out.stdout


def test_cli_device_defaults_to_cuda(monkeypatch):
    """``--device`` defaults to the card and takes only cuda or cpu."""
    from mediquery_rag_tpu_torch.cli import __main__ as cli_main
    seen = {}

    def build(root, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(TAppContext, "build", staticmethod(build))
    with pytest.raises(RuntimeError, match="stop"):
        cli_main.main([])
    assert seen["device"] == "cuda" and seen["fake_llm"] is False
    with pytest.raises(SystemExit):
        cli_main.main(["--device", "gpu"])
