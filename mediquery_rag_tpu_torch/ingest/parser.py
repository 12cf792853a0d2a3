# Copy of mediquery_rag_tpu/ingest/parser.py (the port imports nothing of the JAX package).
"""Parser for the ``chunk_id:`` QA corpus format.

Behavioral parity with the reference's ``parse_custom_format``
(src/ingest_medical.py:24-80): records split on ``chunk_id:``, fields
title/content/source/tags extracted per record, document text rendered as
``问题：{title}\\n答案：{content}`` with {title, tags, source} metadata.
Re-implemented from the format itself (see data sample), not ported.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Chunk:
    chunk_id: str
    title: str
    content: str
    source: str = ""
    tags: list[str] = field(default_factory=list)

    @property
    def text(self) -> str:
        """The embedded document text (reference renders QA pairs this way)."""
        return f"问题：{self.title}\n答案：{self.content}"

    @property
    def metadata(self) -> dict:
        return {"title": self.title, "tags": "，".join(self.tags),
                "source": self.source, "chunk_id": self.chunk_id}


_FIELD = re.compile(r"^(title|content|source|tags|reviewed_at)\s*[:：]\s*(.*)$")


def parse_corpus(raw: str) -> list[Chunk]:
    """Parse the whole corpus text into chunks. Tolerant of tab/space mess
    and multi-line content continuation."""
    chunks: list[Chunk] = []
    records = re.split(r"(?m)^chunk_id\s*[:：]\s*", raw)
    for rec in records[1:]:
        lines = rec.splitlines()
        if not lines:
            continue
        cid = lines[0].strip()
        fields: dict[str, str] = {}
        current: str | None = None
        for line in lines[1:]:
            m = _FIELD.match(line.strip())
            if m:
                current = m.group(1)
                fields[current] = m.group(2).strip()
            elif current and line.strip():
                fields[current] += "\n" + line.strip()
        title = fields.get("title", "").strip()
        content = fields.get("content", "").strip()
        if not title and not content:
            continue
        tags = [t.strip() for t in re.split(r"[，,、]", fields.get("tags", ""))
                if t.strip()]
        chunks.append(Chunk(
            chunk_id=cid, title=title, content=content,
            source=fields.get("source", "").strip(), tags=tags,
        ))
    return chunks


def parse_corpus_file(path: str) -> list[Chunk]:
    with open(path, encoding="utf-8") as f:
        return parse_corpus(f.read())
