# Copy of mediquery_rag_tpu/app/memory/__init__.py (the port imports nothing of the JAX package).
"""Two-tier memory (long-term health profile + short-term session state),
capability parity with src/memory/ — including the features the reference
shipped dead (summarization, HITL review, Markdown export), here live and
tested (SURVEY appendix directive)."""

from mediquery_rag_tpu_torch.app.memory.profile_store import HealthRecord, ProfileStore  # noqa: F401
from mediquery_rag_tpu_torch.app.memory.health_extractor import (  # noqa: F401
    extract_health_info,
    load_health_profile,
)
from mediquery_rag_tpu_torch.app.memory.summary import should_summarize, summarize_messages  # noqa: F401
from mediquery_rag_tpu_torch.app.memory.hitl import HITLManager, ReviewRequest  # noqa: F401
from mediquery_rag_tpu_torch.app.memory.markdown_export import UserProfileMarkdown  # noqa: F401
