# Copy of mediquery_rag_tpu/app/memory/profile_store.py (the port imports nothing of the JAX package).
"""Long-term health-profile store (SQLite).

Capability parity with src/memory/profile_store.py: users + health_records
tables, dedup-checked insert, important-first retrieval, per-category query,
delete/clear, optional Markdown sync. Differences by design: thread-safe
single-writer lock (the reference used an unlocked check_same_thread=False
connection), and Markdown sync is injected rather than lazily imported.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class HealthRecord:
    record_id: int
    user_id: str
    category: str
    content: str
    important: bool
    created_at: float


class ProfileStore:
    def __init__(self, path: str = ":memory:", markdown_sync=None):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._markdown = markdown_sync          # UserProfileMarkdown | None
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS users ("
                "user_id TEXT PRIMARY KEY, name TEXT, created_at REAL)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS health_records ("
                "record_id INTEGER PRIMARY KEY AUTOINCREMENT,"
                "user_id TEXT, category TEXT, content TEXT,"
                "important INTEGER, created_at REAL)"
            )
            self._conn.commit()

    # -- users ---------------------------------------------------------------

    def ensure_user(self, user_id: str, name: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO users VALUES (?,?,?)",
                (user_id, name, time.time()),
            )
            self._conn.commit()

    def get_user(self, user_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT user_id, name, created_at FROM users WHERE user_id=?",
                (user_id,),
            ).fetchone()
        return {"user_id": row[0], "name": row[1], "created_at": row[2]} if row else None

    # -- records -------------------------------------------------------------

    def add_health_record(
        self, user_id: str, category: str, content: str, important: bool = False
    ) -> bool:
        """Insert unless an identical (user, category, content) exists.
        Returns True if inserted (dedup parity: profile_store.py:198-216)."""
        content = content.strip()
        if not content:
            return False
        self.ensure_user(user_id)
        with self._lock:
            dup = self._conn.execute(
                "SELECT 1 FROM health_records WHERE user_id=? AND category=? "
                "AND content=?",
                (user_id, category, content),
            ).fetchone()
            if dup:
                return False
            self._conn.execute(
                "INSERT INTO health_records (user_id, category, content, "
                "important, created_at) VALUES (?,?,?,?,?)",
                (user_id, category, content, int(important), time.time()),
            )
            self._conn.commit()
        if self._markdown is not None:
            try:
                self._markdown.sync_user(user_id, self.get_health_records(user_id))
            except Exception:
                pass                             # sync failure must not lose data
        return True

    def get_health_records(self, user_id: str) -> list[HealthRecord]:
        """Important records first, then newest first (parity :228-232)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT record_id, user_id, category, content, important, "
                "created_at FROM health_records WHERE user_id=? "
                "ORDER BY important DESC, created_at DESC",
                (user_id,),
            ).fetchall()
        return [HealthRecord(r[0], r[1], r[2], r[3], bool(r[4]), r[5]) for r in rows]

    def get_records_by_category(self, user_id: str, category: str) -> list[HealthRecord]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT record_id, user_id, category, content, important, "
                "created_at FROM health_records WHERE user_id=? AND category=? "
                "ORDER BY created_at DESC",
                (user_id, category),
            ).fetchall()
        return [HealthRecord(r[0], r[1], r[2], r[3], bool(r[4]), r[5]) for r in rows]

    def delete_record(self, record_id: int) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM health_records WHERE record_id=?", (record_id,)
            )
            self._conn.commit()
            return cur.rowcount > 0

    def clear_user_records(self, user_id: str) -> int:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM health_records WHERE user_id=?", (user_id,)
            )
            self._conn.commit()
            return cur.rowcount
