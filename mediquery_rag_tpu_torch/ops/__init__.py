"""Compute primitives: hand-written CUDA kernels for Hopper (``csrc/``),
each beside its plain PyTorch version (used for CPU tensors and as the
on-card reference)."""

from mediquery_rag_tpu_torch.ops.topk import exact_topk, merge_topk  # noqa: F401
from mediquery_rag_tpu_torch.ops.scoring import flat_search, flat_search_xla  # noqa: F401
