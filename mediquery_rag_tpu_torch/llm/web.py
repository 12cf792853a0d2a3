# Copy of mediquery_rag_tpu/llm/web.py (the port imports nothing of the JAX package).
"""Web-search tool clients (capability parity with the Tavily integration,
reference medical_engine.py:55-60, nodes.py:102-143).

The graph takes any ``Callable[[str], list[dict]]`` returning
``{"title", "content", "url"}`` rows. ``TavilyClient`` speaks the public
Tavily REST API via stdlib urllib (no SDK); construction is offline-safe
and calls fail-open to [] exactly like the reference's node did."""

from __future__ import annotations

import json
import os
import urllib.request


class TavilyClient:
    def __init__(self, api_key: str | None = None, max_results: int = 3,
                 timeout: float = 15.0):
        self.api_key = api_key or os.environ.get("TAVILY_API_KEY", "")
        self.max_results = max_results
        self.timeout = timeout

    @property
    def available(self) -> bool:
        return bool(self.api_key)

    def __call__(self, query: str) -> list[dict]:
        if not self.api_key:
            return []
        req = urllib.request.Request(
            "https://api.tavily.com/search",
            data=json.dumps({
                "api_key": self.api_key,
                "query": query,
                "max_results": self.max_results,
            }).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read())
        out = []
        for r in data.get("results", [])[: self.max_results]:
            out.append({"title": r.get("title", ""),
                        "content": r.get("content", ""),
                        "url": r.get("url", "")})
        return out


class FakeWebSearch:
    """Scripted web results for tests/demos."""

    def __init__(self, results: list[dict] | None = None):
        self.results = results or []
        self.queries: list[str] = []

    def __call__(self, query: str) -> list[dict]:
        self.queries.append(query)
        return self.results
