"""ROADMAP Queue C 7 on the CPU: the dequantized int4 product of a prefill,
and the speculative server's acceptance, against the JAX package.

- At every dequantized site of a 160-row prefill (a 3-layer bf16 decoder
  with int4 weights and an int8 KV cache), the port's projection output is
  held to JAX's ``_mm`` on the same input. JAX keeps the f32 sum of the bf16
  operands; the port (Queue C 7, open) rounds that sum to bf16 once: every
  output element is a bf16 neighbour of JAX's f32 sum (within one bf16 ulp
  plus the f32 sum-order bound ``K 2^-24 sum|x w|``), and the nearest one
  but where the two sums, taken in another order, round to the other
  neighbour: at most ``OTHER_NEIGHBOUR`` of the elements.
- ``LLMServer(draft=the same generator, gamma=4)`` at f32 activations
  (int4 weights, int8 KV cache), two requests of 16 tokens: the replies,
  the lane rounds and the emitted tokens equal JAX's ``LLMServer``'s,
  counted by the port's rule (``tools/self_draft_acceptance.py``, whose
  helpers this test runs).
"""

import importlib.util
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.models.decoder import _mm as jax_mm
from mediquery_rag_tpu_torch.config import DecoderConfig
from mediquery_rag_tpu_torch.models import decoder
from mediquery_rag_tpu_torch.models.generate import Generator
from mediquery_rag_tpu_torch.serve.llm import LLMServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OTHER_NEIGHBOUR = 0.005     # as tests/test_torch_encoders.py's bf16 layer walk allows


def _tool():
    spec = importlib.util.spec_from_file_location(
        "self_draft_acceptance", os.path.join(ROOT, "tools", "self_draft_acceptance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Six test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dequantized_prefill_product_rounds_jax_f32_sum_to_bf16(monkeypatch):
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=3, heads=4, kv_heads=2, mlp_dim=512,
                        max_len=512, qkv_bias=True, dtype="bfloat16", kv_dtype="int8",
                        attn_impl="flash")
    gen = Generator(cfg, decoder.init_params(cfg, seed=0, device="cpu", bits=4), device="cpu")
    seen = []
    forward = decoder.QLinear.forward

    def recording(self, x, adt, layer=None, weight=None):
        out = forward(self, x, adt, layer, weight)
        if self.form == "int4" and x.numel() // x.shape[-1] > decoder.MATVEC_MAX_ROWS:
            seen.append((x.detach().clone(), self._int4(None), layer, out.detach().clone()))
        return out

    monkeypatch.setattr(decoder.QLinear, "forward", recording)
    ids = torch.randint(3, 259, (1, 160), generator=torch.Generator().manual_seed(0))
    gen.model.prefill(ids, torch.ones((1, 160)), 256)
    assert len(seen) == 5 * cfg.layers          # qkv, out, gate, up, down per layer
    other = total = 0
    for x, w, layer, got in seen:
        want = np.asarray(jax_mm(_jax(x.to(torch.bfloat16)), {k: _jax(v) for k, v in w.items()},
                                 jnp.bfloat16, layer=layer), np.float32)
        rounded = want.astype(ml_dtypes.bfloat16).astype(np.float64)
        wd = decoder.dequantize_weight_int4({k: v[layer] for k, v in w.items()},
                                            torch.bfloat16).double()
        xb = x.to(torch.bfloat16).double().reshape(-1, x.shape[-1])
        bound = x.shape[-1] * 2.0 ** -24 * (xb.abs() @ wd.abs().T).numpy().reshape(want.shape)
        g = got.double().numpy()
        # a bf16 value, and one of the two bf16 neighbours of JAX's f32 sum
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert got.dtype == torch.float32
        assert (g.astype(ml_dtypes.bfloat16).astype(np.float64) == g).all(), layer
        assert (np.abs(g - want) <= ulp + bound).all(), layer
        other += int((g != rounded).sum())
        total += g.size
    assert other <= OTHER_NEIGHBOUR * total, other / total


def test_f32_spec_server_acceptance_matches_jax():
    tool = _tool()
    raw = open(os.path.join(ROOT, "data", "medical_data.txt"), encoding="utf-8").read().encode()
    prompts = [raw[:n].decode("utf-8", errors="ignore") for n in (300, 700)]
    cfg, params, gen = tool.port_model(0, decoder, Generator, DecoderConfig, "float32")
    port = tool.serve_port(gen, prompts, LLMServer, max_new=16, slots=2)
    want = tool.serve_jax(cfg, params, prompts, max_new=16, slots=2)
    assert port["texts"] == want["texts"]
    assert (port["lane_rounds"], port["tokens"]) == (want["lane_rounds"], want["tokens"])
    assert port["tokens"] >= 32 and port["lane_rounds"] < 32
