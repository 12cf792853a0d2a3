# Copy of mediquery_rag_tpu/app/memory/markdown_export.py (the port imports nothing of the JAX package).
"""Per-user Markdown profile export.

Capability parity with src/memory/user_profile_markdown.py (YAML
frontmatter, category ordering with emoji, an index file) — but wired live:
``ProfileStore(markdown_sync=UserProfileMarkdown(dir))`` keeps the files in
sync on every insert, instead of the reference's disabled lazy hook
(profile_store.py:344).
"""

from __future__ import annotations

import os
import time

from mediquery_rag_tpu_torch.app.categories import HEALTH_CATEGORIES, category_of

_CATEGORY_ORDER = ["allergy", "medication", "disease", "lifestyle", "basic"]


class UserProfileMarkdown:
    def __init__(self, root_dir: str):
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)

    def _path(self, user_id: str) -> str:
        return os.path.join(self.root, f"{user_id}.md")

    def sync_user(self, user_id: str, records) -> str:
        """Write {user_id}.md from HealthRecord list; returns the path."""
        by_cat: dict[str, list] = {}
        for r in records:
            by_cat.setdefault(r.category, []).append(r)
        lines = [
            "---",
            f"user_id: {user_id}",
            f"updated_at: {time.strftime('%Y-%m-%d %H:%M:%S')}",
            f"record_count: {len(list(records))}",
            "---",
            "",
            f"# 健康档案 {user_id}",
            "",
        ]
        for cat in _CATEGORY_ORDER:
            rs = by_cat.get(cat)
            if not rs:
                continue
            c = category_of(cat)
            lines.append(f"## {c.emoji} {c.label}")
            for r in rs:
                flag = "**[重要]** " if r.important else ""
                lines.append(f"- {flag}{r.content}")
            lines.append("")
        path = self._path(user_id)
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
        self._write_index()
        return path

    def _write_index(self) -> None:
        users = sorted(
            f[:-3] for f in os.listdir(self.root)
            if f.endswith(".md") and f != "INDEX.md"
        )
        lines = ["# 用户档案索引", ""]
        lines += [f"- [{u}]({u}.md)" for u in users]
        with open(os.path.join(self.root, "INDEX.md"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
