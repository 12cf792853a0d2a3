"""LLM clients: the GPU-hosted decoder client, and copies of the JAX
package's HTTP and scripted clients (``client.py``, ``messages.py``,
``web.py``)."""

from mediquery_rag_tpu_torch.llm.messages import Message, ai, system, user  # noqa: F401
from mediquery_rag_tpu_torch.llm.client import (  # noqa: F401
    FakeLLM, HTTPChatClient, LLMClient, RuleLLM)
from mediquery_rag_tpu_torch.llm.torch_client import TorchLLMClient, render_chat  # noqa: F401
