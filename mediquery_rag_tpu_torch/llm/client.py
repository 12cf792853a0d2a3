# Copy of mediquery_rag_tpu/llm/client.py (the port imports nothing of the JAX package).
"""LLM client protocol + implementations.

``complete()`` takes messages (or a bare prompt string) and returns text.
Everything LLM-flavored in the framework goes through this seam so tests can
script it (SURVEY §4 class 5: graph-level tests with a fake LLM).
"""

from __future__ import annotations

import json
import re
import urllib.request
from typing import Callable, Protocol, Sequence

from mediquery_rag_tpu_torch.llm.messages import Message, user


class LLMClient(Protocol):
    def complete(self, messages: Sequence[Message] | str, **kw) -> str: ...


def _as_messages(messages: Sequence[Message] | str) -> list[Message]:
    if isinstance(messages, str):
        return [user(messages)]
    return list(messages)


class HTTPChatClient:
    """OpenAI-compatible /v1/chat/completions client (Ollama serves this API).

    Works against any local inference server; a thin stdlib-only client so
    no SDK dependency. Gated: construction succeeds offline, calls raise.
    """

    def __init__(self, base_url: str = "http://localhost:11434",
                 model: str = "qwen2.5:7b", temperature: float = 0.0,
                 timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.temperature = temperature
        self.timeout = timeout

    def complete(self, messages: Sequence[Message] | str, **kw) -> str:
        payload = {
            "model": self.model,
            "temperature": self.temperature,
            "messages": [m.to_dict() for m in _as_messages(messages)],
            "stream": False,
        }
        req = urllib.request.Request(
            self.base_url + "/v1/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read())
        return data["choices"][0]["message"]["content"]


class FakeLLM:
    """Scripted responses, FIFO. ``responses`` may be strings or callables
    taking the rendered prompt. Records every prompt for assertions."""

    def __init__(self, responses: Sequence[str | Callable[[str], str]] = (),
                 default: str = "好的。"):
        self.queue = list(responses)
        self.default = default
        self.calls: list[str] = []

    def complete(self, messages: Sequence[Message] | str, **kw) -> str:
        prompt = "\n".join(m.content for m in _as_messages(messages))
        self.calls.append(prompt)
        if self.queue:
            r = self.queue.pop(0)
            return r(prompt) if callable(r) else r
        return self.default


class RuleLLM:
    """Pattern→response rules; first regex match wins. For integration tests
    where call order isn't fixed (grade/rewrite/generate interleave)."""

    def __init__(self, rules: Sequence[tuple[str, str | Callable[[str], str]]],
                 default: str = "好的。"):
        self.rules = [(re.compile(p, re.S), r) for p, r in rules]
        self.default = default
        self.calls: list[str] = []

    def complete(self, messages: Sequence[Message] | str, **kw) -> str:
        prompt = "\n".join(m.content for m in _as_messages(messages))
        self.calls.append(prompt)
        for pat, r in self.rules:
            if pat.search(prompt):
                return r(prompt) if callable(r) else r
        return self.default


def extract_json(text: str):
    """Parse the first JSON object/array out of LLM text, tolerating markdown
    fences and prose — the fail-open JSON hygiene the reference applied at
    every LLM-JSON seam (health_extractor.py:75-84, s_c.py:643-652).
    Returns None on failure (caller decides the fail-open policy)."""
    t = text.strip()
    t = re.sub(r"^```(?:json)?\s*|\s*```$", "", t, flags=re.M)
    try:
        return json.loads(t)
    except (json.JSONDecodeError, ValueError):
        pass
    for open_ch, close_ch in (("{", "}"), ("[", "]")):
        start = t.find(open_ch)
        if start < 0:
            continue
        depth = 0
        for i in range(start, len(t)):
            if t[i] == open_ch:
                depth += 1
            elif t[i] == close_ch:
                depth -= 1
                if depth == 0:
                    try:
                        return json.loads(t[start : i + 1])
                    except (json.JSONDecodeError, ValueError):
                        break
    return None
