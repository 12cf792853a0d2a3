"""LLM clients: the GPU-hosted decoder client. The HTTP and scripted
clients (``mediquery_rag_tpu.llm.client``) are jax-free and shared."""

from mediquery_rag_tpu_torch.llm.torch_client import TorchLLMClient, render_chat  # noqa: F401
