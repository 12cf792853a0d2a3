"""TorchLLMClient — the chat LLM served from the GPU (port of ``mediquery_rag_tpu/llm/tpu_client.py``).

Satisfies the ``LLMClient`` seam (``complete`` / ``complete_batch``) with
the port's decoder behind ``Generator`` (a ``Generator.save`` checkpoint,
or an HF qwen2-class checkpoint through ``from_hf``), so the Self-RAG
graph runs on it unchanged. ``render_chat``, ``_turn_stops``
and ``_cut_turn`` are copies of the JAX module's helpers (that module
imports jax); the parity tests hold them to identical strings.
"""

from __future__ import annotations

import json
from typing import Sequence

from mediquery_rag_tpu_torch.llm.client import _as_messages
from mediquery_rag_tpu_torch.llm.messages import Message
from mediquery_rag_tpu_torch.models.generate import Generator

# Plain-text role markers (the byte-level vocab has no reserved role tokens).
_ROLE = {"system": "<|system|>", "user": "<|user|>", "assistant": "<|assistant|>"}
_END = "<|end|>"


def render_chat(messages: Sequence[Message] | str, *,
                for_training: bool = False, template: str = "plain") -> str:
    """Messages -> the decoder's prompt string (copy of
    ``mediquery_rag_tpu.llm.tpu_client.render_chat``): serving prompts end
    with an open assistant turn; ``template="chatml"`` renders qwen2.5's
    ChatML."""
    if template == "chatml":
        parts = [f"<|im_start|>{m.role}\n{m.content}<|im_end|>\n"
                 for m in _as_messages(messages)]
        if for_training:
            if not parts or _as_messages(messages)[-1].role != "assistant":
                raise ValueError(
                    "training samples must end with an assistant turn")
            return "".join(parts).removesuffix("<|im_end|>\n")
        return "".join(parts) + "<|im_start|>assistant\n"

    parts = []
    for m in _as_messages(messages):
        parts.append(f"{_ROLE.get(m.role, _ROLE['user'])}\n{m.content}{_END}")
    text = "".join(parts)
    if for_training:
        if not parts or _as_messages(messages)[-1].role != "assistant":
            raise ValueError("training samples must end with an assistant turn")
        return text.removesuffix(_END)
    return text + _ROLE["assistant"] + "\n"


def _turn_stops(template: str) -> tuple[str, ...]:
    """The role/stop markers a model reply is cut at (copy)."""
    return (("<|im_start|>", "<|im_end|>") if template == "chatml"
            else (_END, *_ROLE.values()))


def _cut_turn(out: str, template: str) -> str:
    """Cut a reply at the first role/stop marker, then strip (copy)."""
    for stop in _turn_stops(template):
        idx = out.find(stop)
        if idx >= 0:
            out = out[:idx]
    return out.strip()


class TorchLLMClient:
    """``LLMClient`` implementation backed by the port's decoder."""

    def __init__(self, generator: Generator, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, template: str = "plain"):
        self.generator = generator
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.template = template
        self._constraints: dict = {}   # schema json -> compiled JsonConstraint

    def complete(self, messages: Sequence[Message] | str, **kw) -> str:
        return self.complete_batch([messages], **kw)[0]

    def _constraint_for(self, schema: dict):
        key = json.dumps(schema, sort_keys=True)
        c = self._constraints.get(key)
        if c is None:
            from mediquery_rag_tpu_torch.models.constrain import JsonConstraint
            c = JsonConstraint.compile(schema, self.generator.tokenizer,
                                       vocab_size=self.generator.cfg.vocab_size)
            self._constraints[key] = c
        return c

    def complete_batch(self, message_lists, **kw) -> list[str]:
        """Batched completion: one prefill + decode loop for N
        conversations. ``schema=`` (a models/constrain.py restricted JSON
        schema, compiled once and cached) constrains decoding, so the
        output is valid JSON of that schema by construction."""
        prompts = [render_chat(m, template=self.template) for m in message_lists]
        constraint = (self._constraint_for(kw["schema"])
                      if kw.get("schema") is not None else None)
        outs = self.generator.generate(
            prompts,
            max_new_tokens=kw.get("max_new_tokens", self.max_new_tokens),
            temperature=kw.get("temperature", self.temperature),
            constraint=constraint,
        )
        if constraint is not None:
            # the grammar and EOS end the output; cutting at role markers
            # would corrupt a JSON string that contains one
            return [o.strip() for o in outs]
        return [_cut_turn(o, self.template) for o in outs]

    @classmethod
    def from_checkpoint(cls, path: str, *, device="cuda", **kw) -> "TorchLLMClient":
        return cls(Generator.from_checkpoint(path, device=device), **kw)

    @classmethod
    def from_hf(cls, model_dir: str, *, quantize: bool | int = 0, kv_dtype: str = "",
                device="cuda", **kw) -> "TorchLLMClient":
        """Serve an HF qwen2-class checkpoint from ``device`` (JAX
        ``TPULLMClient.from_hf``): the imported weights in bf16, then
        ``quantize=8`` (or True) int8 weight-only serving (B4), ``quantize=4``
        int4 (B7; the 4-bit tier the reference's Ollama GGUF runs at), 0 as
        loaded; ``kv_dtype="int8"`` quantizes the KV cache as it is written
        (half the cache memory). Prompts use ChatML, what qwen2.5-instruct
        was trained on. The bf16 load precedes quantization, as in JAX, so
        device memory peaks at the bf16 weights plus the quantized copy."""
        from mediquery_rag_tpu_torch.models.hf_import import load_qwen2_generator

        gen = load_qwen2_generator(model_dir, kv_dtype=kv_dtype, device=device)
        if quantize:
            gen.quantize_weights(bits=8 if quantize is True else quantize)
        kw.setdefault("template", "chatml")
        return cls(gen, **kw)
