# Copy of mediquery_rag_tpu/cli/interface.py (the port imports nothing of the JAX package).
"""Terminal flows: menu, health advisor, science QA.

Capability parity with src/ui/interface.py: welcome menu, phone login with
profile recap + similar-history hint, the staged Q&A loop with a CRITICAL
risk gate, the RAG hand-off streaming the summarizer event, the science-QA
REPL — plus live conversation summarization (dead code in the reference,
revived per SURVEY appendix) and a HITL review-processing command.
"""

from __future__ import annotations

import os
import uuid

from mediquery_rag_tpu_torch.app.consultation import StructuredConsultation
from mediquery_rag_tpu_torch.app.memory import should_summarize, summarize_messages
from mediquery_rag_tpu_torch.app.risk import CRITICAL
from mediquery_rag_tpu_torch.cli.context import AppContext
from mediquery_rag_tpu_torch.llm.messages import user

BANNER = """
╔══════════════════════════════════════════╗
║     MediQuery-TPU 健康咨询助手           ║
║     TPU-native medical RAG framework     ║
╚══════════════════════════════════════════╝
 1. 健康顾问（结构化问诊 + 个性化建议）
 2. 健康科普问答（自由提问）
 3. 处理人工审核队列（HITL）
 4. 查看健康档案
 q. 退出
"""


def _input(prompt: str) -> str | None:
    try:
        return input(prompt)
    except EOFError:
        return None


def _stream_rag(ctx: AppContext, query: str, user_id: str, thread_id: str,
                summary: str = "") -> str:
    final = ""
    for name, state in ctx.graph_app.stream(
        {"messages": [user(query)], "user_id": user_id, "summary": summary},
        thread_id=thread_id
    ):
        if name == "retrieve":
            print(f"  🔍 检索到 {len(state.get('documents', []))} 条资料")
        elif name == "web_search":
            print("  🌐 本地资料不足，尝试网络检索…")
        elif name == "summarizer":
            final = state.get("final_answer", "")
    return final


def run_health_advisor(ctx: AppContext) -> None:
    phone = _input("请输入手机号登录（直接回车匿名）：")
    if phone is None:
        return
    sc = StructuredConsultation(
        ctx.llm, data_dir=ctx.cfg.paths.user_data_dir,
        cfg=ctx.cfg.consultation)
    is_anon = not phone
    profile = sc.identify_user(phone or f"anon_{uuid.uuid4().hex[:8]}")
    if profile.name:
        print(f"欢迎回来，{profile.name}！")
    hist = None
    sc.start_session()
    if profile.name:
        for h in sc.get_history_summary():
            print(f"  📜 {h['date']} {h['consult_type']}：{h['chief_complaint']}")

    while not sc.is_complete:
        q = sc.get_current_question()
        if q is None:
            break
        opts = f"（{' / '.join(q['options'])}）" if q.get("options") else ""
        tag = "🤖追问 " if q.get("source") == "ai" else ""
        ans = _input(f"{tag}{q['text']}{opts}\n> ")
        if ans is None:
            print("（输入结束，问诊中止；已回答的内容已保存。）")
            return
        r = sc.process_answer(ans)
        if not r["ok"]:
            print(f"  ✋ {r['error']}")
            continue
        risk = r.get("risk")
        if risk is not None and risk.message:
            print(risk.message)
        if sc.session.risk_level == CRITICAL:
            print("\n⚠️ 已检测到紧急情况，问诊终止。请立即就医。")
            sc.generate_history_markdown()
            return
        if q["key"] == "chief_complaint":
            hist = sc.find_similar_history(str(sc.session.answers.get(
                "chief_complaint", "")))
            if hist:
                print(f"  📜 您{hist['date']}也咨询过类似问题"
                      f"（{hist['chief_complaint']}）。")

    summary = sc.get_consultation_summary()
    if summary["health_metrics"]:
        print(f"\n📊 健康指标：{summary['health_metrics']}")
        if summary["health_analysis"]:
            print(f"   {summary['health_analysis']}")
    print("\n正在为您生成个性化建议…")
    query = sc.build_rag_query()
    thread_id = f"{profile.user_id}_{uuid.uuid4().hex[:8]}"
    # anonymous sessions must stream as "anonymous": a one-shot user_id
    # would trigger LLM health extraction + SQLite writes keyed to an id
    # no one can ever log into again
    answer = _stream_rag(ctx, query,
                         "anonymous" if is_anon else profile.user_id,
                         thread_id)
    print("\n" + (answer or "（未生成回答）"))
    if is_anon:
        # drop the throwaway profile dir instead of leaking one per session
        import shutil
        shutil.rmtree(os.path.join(ctx.cfg.paths.user_data_dir,
                                   profile.user_id), ignore_errors=True)
    else:
        path = sc.generate_history_markdown()
        print(f"\n（问诊记录已保存：{path}）")


def run_science_qa(ctx: AppContext) -> None:
    print("进入健康科普问答，输入 q 返回菜单。")
    transcript = []
    thread_id = f"science_{uuid.uuid4().hex[:8]}"
    while True:
        q = _input("\n❓ 请提问：")
        if q is None or q.strip().lower() == "q":
            return
        if not q.strip():
            continue
        transcript.append(user(q))
        summary = (transcript[0].content
                   if transcript and transcript[0].role == "system" else "")
        answer = _stream_rag(ctx, q, "anonymous", thread_id, summary=summary)
        print("\n" + (answer or "（未生成回答）"))
        from mediquery_rag_tpu_torch.llm.messages import ai
        transcript.append(ai(answer))
        if should_summarize(transcript, ctx.cfg.memory):
            transcript = summarize_messages(transcript, ctx.llm, ctx.cfg.memory)
            print("  （对话历史已自动压缩）")


def run_profile_view(ctx: AppContext) -> None:
    """Show the two-tier profile for a phone number: consultation profile
    (JSON) + extracted long-term records (SQLite), parity with the
    reference's show_health_profile (ui/interface.py:487-555)."""
    from mediquery_rag_tpu_torch.app.memory import load_health_profile

    phone = _input("请输入手机号：")
    if not phone:
        return
    sc = StructuredConsultation(ctx.llm, data_dir=ctx.cfg.paths.user_data_dir)
    profile = sc.peek_user(phone)          # read-only: never mint a profile
    if profile is None:
        print("（该手机号没有问诊档案）")
        return
    print(f"\n—— 基本档案（{profile.user_id[:8]}…）——")
    if profile.name:
        print(f"姓名：{profile.name}　年龄：{profile.age}　性别：{profile.gender}")
        if profile.height_cm:
            print(f"身高：{profile.height_cm} cm　体重：{profile.weight_kg} kg")
        for label, v in (("慢性疾病", profile.chronic), ("过敏史", profile.allergy),
                         ("长期用药", profile.medication)):
            if v:
                print(f"{label}：{v}")
    else:
        print("（尚无问诊档案）")
    text = load_health_profile(profile.user_id, ctx.profile_store)
    if text:
        print("\n—— 对话中提取的健康记录 ——")
        print(text)
    hist = sc.get_history_summary(last_n=5, include_current=True)
    if hist:
        print("\n—— 最近问诊 ——")
        for h in hist:
            print(f"{h['date']}（{h['consult_type'] or '未分类'}）"
                  f"：{h['chief_complaint'] or '—'}（风险 {h['risk_level']}）")


def run_hitl_review(ctx: AppContext) -> None:
    stats = ctx.hitl.stats()
    print(f"审核队列：待审 {stats['pending']} / 已批准 {stats['approved']} "
          f"/ 已拒绝 {stats['rejected']}")
    result = ctx.hitl.process_reviews()
    print(f"本次处理：应用 {result['applied']} 条记录，"
          f"拒绝 {result['rejected']} 份，仍待审 {result['pending']} 份。")


def main_menu(ctx: AppContext) -> None:
    while True:
        print(BANNER)
        choice = _input("请选择：")
        if choice is None or choice.strip().lower() == "q":
            print("再见！")
            return
        choice = choice.strip()
        if choice == "1":
            run_health_advisor(ctx)
        elif choice == "2":
            run_science_qa(ctx)
        elif choice == "3":
            run_hitl_review(ctx)
        elif choice == "4":
            run_profile_view(ctx)
