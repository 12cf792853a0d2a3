# Copy of mediquery_rag_tpu/llm/messages.py (the port imports nothing of the JAX package).
"""Minimal chat message type (replaces langchain_core messages)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Message:
    role: str      # "system" | "user" | "assistant"
    content: str

    def to_dict(self) -> dict:
        return {"role": self.role, "content": self.content}

    @classmethod
    def from_dict(cls, d: dict) -> "Message":
        return cls(role=d["role"], content=d["content"])


def system(content: str) -> Message:
    return Message("system", content)


def user(content: str) -> Message:
    return Message("user", content)


def ai(content: str) -> Message:
    return Message("assistant", content)
