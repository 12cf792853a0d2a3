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
- The int8-KV cached attention of ``decode_step_slots``, ``extend_slots``
  and ``prefill_extend`` in a bf16 layer: with ``attn_impl="einsum"`` the
  port takes JAX's einsum route (``_*_xs``: fresh columns written first,
  the normalized softmax weights times the V scales rounded to bf16), with
  ``"flash"`` JAX's stacked route (the kernels' arithmetic); the logits
  equal JAX's. Until the einsum route was ported the port ran the kernels'
  arithmetic for both, 2.7-2.9e-2 relative L2 from JAX's einsum logits.
- ``LLMServer(draft=the same generator, gamma=4)`` at f32 activations
  (int4 weights, int8 KV cache), two requests of 16 tokens: the replies,
  the lane rounds and the emitted tokens equal JAX's ``LLMServer``'s,
  counted by the port's rule (``tools/self_draft_acceptance.py``, whose
  helpers this test runs); and a request landing in prefill pieces while
  speculative rounds run (int4 weights over a float cache), the same.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import DecoderConfig as JDecoderConfig
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.decoder import KVCache as JKVCache
from mediquery_rag_tpu.models.decoder import _mm as jax_mm
from mediquery_rag_tpu_torch.config import DecoderConfig
from mediquery_rag_tpu_torch.models import decoder
from mediquery_rag_tpu_torch.models.generate import Generator
from mediquery_rag_tpu_torch.serve.llm import LLMServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OTHER_NEIGHBOUR = 0.005     # as tests/test_torch_encoders.py's bf16 layer walk allows
# bf16 logits of one layer over an int8 cache, the same route in both packages:
# only f32 sums taken in another order separate them (measured: equal)
ROUTE_REL = 1e-4


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


def test_pending_lane_under_speculative_rounds_matches_jax():
    """Seed 0's requests 0 and 3 (300 and 500 bytes, f32, einsum attention)
    through ``LLMServer(draft=the same generator, gamma=4)``: request 3 lands
    in 256-token pieces while speculative rounds run for request 0 (the
    inactive lane's ``extend_slots`` writes, the draft's resync after). With
    int4 weights over a float KV cache the replies, lane rounds and tokens
    equal JAX's server's: the scheduler takes JAX's schedule call for call
    (``tools/server_call_walk.py``). With the int8 cache as well, f32 sums
    taken in another order (the 512-deep ``w_down`` product, the softmax
    over the cache) cross rounding midpoints of the int8 codes, and the
    replies may part (ROADMAP Queue C 7)."""
    tool = _tool()
    raw = open(os.path.join(ROOT, "data", "medical_data.txt"), encoding="utf-8").read().encode()
    prompts = [raw[:n].decode("utf-8", errors="ignore") for n in (300, 500)]
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=3, heads=4, kv_heads=2, mlp_dim=512,
                        max_len=2048, qkv_bias=True, dtype="float32", attn_impl="einsum")
    params = decoder.init_params(cfg, seed=0, device="cpu", bits=4)
    port = tool.serve_port(Generator(cfg, params, device="cpu"), prompts, LLMServer)
    want = tool.serve_jax(cfg, params, prompts)
    assert port["texts"] == want["texts"] and all(port["texts"])
    assert (port["lane_rounds"], port["tokens"]) == (want["lane_rounds"], want["tokens"])


def _strict(fn, *args):
    """``fn(*args)`` compiled with ``xla_allow_excess_precision`` off: by
    default XLA keeps some bf16 intermediates in f32 (a 1-layer bf16
    prefill's logits 5.2e-3 from the port's; ROADMAP Queue C 7)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jtree(d):
    return {k: _jtree(v) if isinstance(v, dict) else _jax(v) for k, v in d.items()}


@pytest.mark.parametrize("impl,route", [("einsum", "xs"), ("flash", "stacked")])
def test_int8_cache_attention_takes_jax_route(impl, route):
    """One bf16 layer (int4 weights, int8 KV, GQA, q/k/v bias) over 4 lanes
    filled by ``prefill_extend`` to 100-211 columns: a ``decode_step_slots``
    step and a 5-token ``extend_slots`` (lane 2 inactive), and a 7-token
    ``prefill_extend`` on lane 0, against JAX's route for ``impl``. The
    logits of live lanes are within ROUTE_REL relative L2 of JAX's."""
    cfg = DecoderConfig(vocab_size=384, hidden=256, layers=1, heads=4, kv_heads=2, mlp_dim=512,
                        max_len=512, qkv_bias=True, dtype="bfloat16", kv_dtype="int8",
                        attn_impl=impl)
    params = decoder.init_params(cfg, seed=0, device="cpu", bits=4)
    dec = decoder.Decoder(cfg, params)
    jd, jp = JDecoder(JDecoderConfig(**cfg.__dict__)), _jtree(params)
    B, C = 4, 256
    g = torch.Generator().manual_seed(0)
    cache = dec.empty_cache(B, C)
    for b in range(B):
        n = 100 + 37 * b
        dec.prefill_extend(cache.k[:, b], cache.v[:, b], cache.key_mask[b],
                           torch.randint(3, 259, (n,), generator=g), torch.ones(n), 0, 0,
                           k_scale_row=cache.k_scale[:, b], v_scale_row=cache.v_scale[:, b])
        cache.cursor[b] = cache.next_pos[b] = n

    def both():
        port = decoder.KVCache(**{k: v.clone() for k, v in cache.__dict__.items()})
        jc = JKVCache(k=_jax(cache.k), v=_jax(cache.v), key_mask=_jax(cache.key_mask),
                      cursor=_jax(cache.cursor.int()), next_pos=_jax(cache.next_pos),
                      k_scale=_jax(cache.k_scale), v_scale=_jax(cache.v_scale))
        return port, jc

    def close(got, want):
        got, want = got.double().numpy(), np.asarray(want, np.float64)
        assert np.linalg.norm(got - want) <= ROUTE_REL * np.linalg.norm(want)

    active = torch.tensor([True, True, False, True])
    live = active.numpy()
    tok = torch.randint(3, 259, (B,), generator=g)
    port, jc = both()
    want, _ = _strict(getattr(jd, f"_decode_step_slots_{route}"), jp, jc, _jax(tok.int()),
                      _jax(active))
    close(dec.decode_step_slots(port, tok, active)[live], np.asarray(want)[live])
    toks = torch.randint(3, 259, (B, 5), generator=g)
    port, jc = both()
    want, _ = _strict(getattr(jd, f"_extend_slots_{route}"), jp, jc, _jax(toks.int()),
                      _jax(active))
    close(dec.extend_slots(port, toks, active)[live], np.asarray(want)[live])
    ids, mask = toks[0].repeat(2)[:7], torch.tensor([1.0] * 6 + [0.0])
    port, jc = both()
    got = dec.prefill_extend(port.k[:, 0], port.v[:, 0], port.key_mask[0], ids, mask, 100, 100,
                             all_logits=True, k_scale_row=port.k_scale[:, 0],
                             v_scale_row=port.v_scale[:, 0])[0]
    want = _strict(lambda p, c, i, m: jd.prefill_extend(
        p, c.k[:, 0], c.v[:, 0], c.key_mask[0], i, m, 100, 100, all_logits=True,
        k_scale_row=c.k_scale[:, 0], v_scale_row=c.v_scale[:, 0])[0],
        jp, jc, _jax(ids.int()), _jax(mask))
    close(got[:6], np.asarray(want)[:6])
