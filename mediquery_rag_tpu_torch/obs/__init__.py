"""Measurement: recall, CUDA-event device timing and profiled busy time."""

from mediquery_rag_tpu_torch.obs.metrics import cuda_busy, cuda_time, recall_at_k  # noqa: F401
