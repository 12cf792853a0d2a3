# Copy of mediquery_rag_tpu/app/memory/summary.py (the port imports nothing of the JAX package).
"""Conversation summarization — live, unlike the reference.

The reference exported should_summarize/summarize_messages but never called
them (SURVEY §2 row 11: "exported but never called"). Here the science-QA
REPL actually invokes them (cli/interface.py), preserving the thresholds:
compress when the transcript exceeds ``summarize_after_messages`` (16),
keep the most recent ``keep_recent_messages`` (6), truncate each older
message to 500 chars before compression, and instruct the LLM to preserve
numbers/allergies/medication facts.
"""

from __future__ import annotations

from mediquery_rag_tpu_torch.config import MemoryConfig
from mediquery_rag_tpu_torch.llm.messages import Message, system

SUMMARY_PROMPT = """把下面的对话历史压缩成一段简短的摘要，供后续对话参考。
必须保留：具体数值（血压、血糖、体重等）、过敏信息、用药信息、医生建议。
省略寒暄和重复内容。直接输出摘要正文。

对话历史：
{history}

摘要："""


def should_summarize(messages: list[Message],
                     cfg: MemoryConfig = MemoryConfig()) -> bool:
    return len(messages) > cfg.summarize_after_messages


def summarize_messages(
    messages: list[Message], llm, cfg: MemoryConfig = MemoryConfig()
) -> list[Message]:
    """Returns a new transcript: [summary system message] + recent tail."""
    if not should_summarize(messages, cfg):
        return list(messages)
    keep = cfg.keep_recent_messages
    old, recent = messages[:-keep], messages[-keep:]
    rendered = "\n".join(
        f"{m.role}: {m.content[: cfg.summary_truncate_chars]}" for m in old
    )
    summary = llm.complete(SUMMARY_PROMPT.format(history=rendered))
    return [system(f"【此前对话摘要】{summary.strip()}")] + list(recent)
