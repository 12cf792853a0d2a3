# Copy of mediquery_rag_tpu/app/memory/hitl.py (the port imports nothing of the JAX package).
"""Human-in-the-loop review queue for extracted health records.

Capability parity with src/memory/hitl_manager.py (a 557-LoC component the
reference never imported — SURVEY §2 row 12 "orphaned"); here it is wired:
``extract_health_info`` can route through ``HITLManager.submit`` instead of
writing directly, and the CLI exposes a review-processing command.

Mechanism: markdown files in pending/approved/rejected dirs. Risk rules
(parity with hitl_manager.py:314-349): allergy/medication → HIGH,
disease → MEDIUM, else LOW; LOW auto-approves straight into the store.
A human edits ``status:`` in a pending file; ``process_reviews`` applies
approved extractions to the profile store and archives the file.
"""

from __future__ import annotations

import os
import re
import time
import uuid
from dataclasses import dataclass, field

from mediquery_rag_tpu_torch.app.memory.profile_store import ProfileStore


@dataclass
class ReviewRequest:
    request_id: str
    user_id: str
    source_text: str
    records: list[dict]            # [{category, content, important}]
    risk: str                      # HIGH | MEDIUM | LOW
    status: str = "pending"        # pending | approved | rejected
    created_at: float = field(default_factory=time.time)


def assess_extraction_risk(records: list[dict]) -> str:
    cats = {r.get("category") for r in records}
    if cats & {"allergy", "medication"}:
        return "HIGH"
    if "disease" in cats:
        return "MEDIUM"
    return "LOW"


class HITLManager:
    def __init__(self, root_dir: str, store: ProfileStore,
                 auto_approve_low: bool = True):
        self.root = root_dir
        self.store = store
        self.auto_approve_low = auto_approve_low
        for sub in ("pending", "approved", "rejected"):
            os.makedirs(os.path.join(root_dir, sub), exist_ok=True)

    # -- submit --------------------------------------------------------------

    def submit(self, user_id: str, source_text: str,
               records: list[dict]) -> ReviewRequest:
        risk = assess_extraction_risk(records)
        req = ReviewRequest(
            request_id=uuid.uuid4().hex[:12],
            user_id=user_id, source_text=source_text,
            records=records, risk=risk,
        )
        if risk == "LOW" and self.auto_approve_low:
            self._apply(req)
            req.status = "approved"
            self._write(req, "approved")
        else:
            self._write(req, "pending")
        return req

    # -- markdown (de)serialization -----------------------------------------

    def _write(self, req: ReviewRequest, sub: str) -> str:
        lines = [
            "---",
            f"request_id: {req.request_id}",
            f"user_id: {req.user_id}",
            f"risk: {req.risk}",
            f"status: {req.status}",
            f"created_at: {req.created_at}",
            "---",
            "",
            "## 原文",
            req.source_text,
            "",
            "## 提取的记录",
        ]
        for r in req.records:
            imp = "yes" if r.get("important") else "no"
            lines.append(f"- category: {r['category']} | important: {imp} | {r['content']}")
        path = os.path.join(self.root, sub, f"{req.request_id}.md")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        return path

    _FRONT = re.compile(r"^(\w+):\s*(.*)$")
    _REC = re.compile(r"^- category:\s*(\S+)\s*\|\s*important:\s*(\S+)\s*\|\s*(.*)$")

    def _read(self, path: str) -> ReviewRequest:
        meta: dict[str, str] = {}
        records: list[dict] = []
        source_lines: list[str] = []
        in_front = in_source = False
        with open(path, encoding="utf-8") as f:
            for line in f.read().splitlines():
                if line.strip() == "---":
                    in_front = not in_front
                    continue
                if in_front:
                    m = self._FRONT.match(line.strip())
                    if m:
                        meta[m.group(1)] = m.group(2)
                elif line.startswith("## 原文"):
                    in_source = True
                elif line.startswith("## 提取的记录"):
                    in_source = False
                elif (m := self._REC.match(line.strip())):
                    records.append({
                        "category": m.group(1),
                        "important": m.group(2) == "yes",
                        "content": m.group(3).strip(),
                    })
                elif in_source and line.strip():
                    source_lines.append(line)
        return ReviewRequest(
            request_id=meta.get("request_id", ""),
            user_id=meta.get("user_id", ""),
            source_text="\n".join(source_lines),
            records=records,
            risk=meta.get("risk", "LOW"),
            status=meta.get("status", "pending"),
            created_at=float(meta.get("created_at", 0) or 0),
        )

    # -- processing ----------------------------------------------------------

    def _apply(self, req: ReviewRequest) -> int:
        n = 0
        for r in req.records:
            if self.store.add_health_record(
                req.user_id, r["category"], r["content"], bool(r.get("important"))
            ):
                n += 1
        return n

    def process_reviews(self) -> dict:
        """Scan pending/ for human-edited status; apply approved, archive both.
        Returns counts (parity: hitl_manager.py:422-489)."""
        applied = rejected = still_pending = 0
        pending_dir = os.path.join(self.root, "pending")
        for name in sorted(os.listdir(pending_dir)):
            if not name.endswith(".md"):
                continue
            path = os.path.join(pending_dir, name)
            req = self._read(path)
            if req.status == "approved":
                applied += self._apply(req)
                self._write(req, "approved")
                os.remove(path)
            elif req.status == "rejected":
                rejected += 1
                self._write(req, "rejected")
                os.remove(path)
            else:
                still_pending += 1
        return {"applied": applied, "rejected": rejected,
                "pending": still_pending}

    def stats(self) -> dict:
        out = {}
        for sub in ("pending", "approved", "rejected"):
            d = os.path.join(self.root, sub)
            out[sub] = len([f for f in os.listdir(d) if f.endswith(".md")])
        return out
