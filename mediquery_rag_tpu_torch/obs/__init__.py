"""Measurement: recall, CUDA-event device timing, profiled busy time and
profiler traces."""

from mediquery_rag_tpu_torch.obs.metrics import cuda_busy, cuda_time, recall_at_k  # noqa: F401
from mediquery_rag_tpu_torch.obs.tracing import capture_trace, span  # noqa: F401
