"""Tensor-parallel generation of the port against the JAX package's, on the CPU.

The port runs one process per rank (``parallel.dist.launch``: 2 gloo
workers, tp=2, one torch thread each, one group for every case of the file,
``tests/torch_tp_workers.py``); JAX runs ``Generator.generate`` over
parameters placed with ``NamedSharding(mesh, Decoder.partition_specs())``
on two virtual CPU devices of ``tests/conftest.py`` (its
``tests/test_decoder.py`` TP test), where GSPMD inserts the collectives.
Both start from the same JAX-drawn f32 parameters; a quantized case gives
the port JAX's quantized whole tree, which each rank cuts.

- greedy strings of tp=2 equal JAX's TP ``generate`` in f32 for float, int8
  and int4 weights, each with and without an int8 KV cache and each with
  einsum and flash attention (not the full product: each pair of the three
  axes appears), at TINY widths (JAX's ``tests/test_decoder.py``), with a
  GQA (q/k/v bias) and a one-KV-head variant (its KV head held by both
  ranks); a prompt of 192 tokens runs the dequantized product; in bf16 the
  greedy tokens obey the near-tie rule against JAX's logits on the same
  tokens; ``quantize_weights`` on a tp=2 generator equals the one-process
  port's;
- every quantized leaf's cut equals the matching channels or rows of the
  whole quantized tree (codes unpacked here with numpy, scales bit-equal;
  int8 ``w_gateup`` as ``[gate_r | up_r]``), and ``gather`` returns the
  whole tree bit for bit;
- a row-parallel int8 and int4 product over two ranks equals the
  one-process product within the f32 sum-order bound; with each rank's own
  absmax (no MAX over "model") it does not;
- ``decode_step_slots``, ``prefill_extend`` and ``extend_slots`` over the
  shards give the one-process logits within SLOT_REL;
- ``SpeculativeGenerator`` with a tp=2 target gives the target's greedy
  strings;
- ``LLMServer`` on model rank 0 with a follower: 4 greedy requests, one
  landing in prefill pieces, equal JAX's TP lockstep ``generate`` prompt by
  prompt, with and without a replicated draft; the follower finishes the
  same requests with the same tokens; a follower that dies makes the run
  raise;
- ``save`` over the mesh writes JAX's layout, and ``from_checkpoint(mesh=)``
  gives each rank its shard back; a model axis that does not divide the
  heads, the MLP or the vocabulary, or leaves an int4 shard an odd width,
  raises.
"""

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_tp_workers as workers
from mediquery_rag_tpu.config import DecoderConfig
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.generate import Generator as JGenerator
from mediquery_rag_tpu.parallel import make_mesh as jmake_mesh
from mediquery_rag_tpu_torch import config as tconfig
from mediquery_rag_tpu_torch.models import decoder as tdecoder
from mediquery_rag_tpu_torch.models.convert import load_jax_checkpoint
from mediquery_rag_tpu_torch.models.generate import Generator
from mediquery_rag_tpu_torch.parallel.dist import launch, tree_get, tree_paths

TINY = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=512,
                     dtype="float32")
CFGS = {"tiny": TINY,
        "gqa": dataclasses.replace(TINY, kv_heads=2, qkv_bias=True),
        "mqa": dataclasses.replace(TINY, kv_heads=1)}
PROMPTS = ["高血压患者", "糖尿病的早期症状有哪些？请详细说明" * 4]   # 15 and 192 tokens
# (config, weight bits, KV cache, attention)
GEN = [("tiny", 0, "", "einsum"), ("tiny", 8, "int8", "einsum"), ("tiny", 4, "", "einsum"),
       ("tiny", 0, "int8", "flash"), ("tiny", 8, "", "flash"), ("tiny", 4, "int8", "flash"),
       ("gqa", 4, "int8", "einsum"), ("gqa", 8, "", "flash"), ("mqa", 4, "int8", "flash")]
SERVE_PROMPTS = ["头痛怎么办", "高血压患者平时饮食需要注意什么？", "BMI 23.5",
                 "糖尿病的早期症状有哪些？请详细说明，并给出饮食建议。" * 5]   # 400 tokens
SLOT_REL = 1e-5      # one-process logits against the shards': f32 sums in another order


def _cfg(name, kv="", attn="einsum", **kw):
    return dataclasses.replace(CFGS[name], kv_dtype=kv, attn_impl=attn, **kw)


def _t(cfg):
    return tconfig.DecoderConfig(**cfg.__dict__)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def floats():
    """JAX-drawn f32 params of each config, and a 1-layer draft."""
    out = {name: _np(JGenerator(cfg).params) for name, cfg in CFGS.items()}
    out["draft"] = _np(JGenerator(dataclasses.replace(TINY, layers=1)).params)
    return out


_QUANTIZED: dict = {}


def _quantized(cfg, params, bits):
    """JAX's quantized whole tree (numpy) of ``params``, once per tree and
    width."""
    if not bits:
        return params
    key = (id(params), bits)
    if key not in _QUANTIZED:
        gen = JGenerator(cfg, params=jax.tree_util.tree_map(jnp.asarray, params))
        _QUANTIZED[key] = (params, _np(gen.quantize_weights(bits).params))
    return _QUANTIZED[key][1]


def _jax_tp(cfg, params, bits, prompts, max_new, one_by_one=False):
    """JAX's ``generate`` over params placed on a (1, 2) mesh, quantized there."""
    gen = JGenerator(cfg, params=jax.tree_util.tree_map(jnp.asarray, params))
    mesh = jmake_mesh({"data": 1, "model": 2})
    gen.params = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), gen.params,
        gen.model.partition_specs())
    if bits:
        gen.quantize_weights(bits)
    if one_by_one:
        return [gen.generate([p], max_new_tokens=max_new)[0] for p in prompts]
    return gen.generate(prompts, max_new_tokens=max_new)


def _gen_id(c):
    return f"{c[0]}-w{c[1] or 'f'}-kv{c[2] or 'f'}-{c[3]}"


@pytest.fixture(scope="module")
def cases(floats, tmp_path_factory):
    gqa_bf16 = _cfg("gqa", dtype="bfloat16")
    out = {}
    for c in GEN:
        cfg = _cfg(c[0], c[2], c[3])
        out[_gen_id(c)] = dict(kind="generate", cfg=_t(cfg), prompts=PROMPTS, max_new=8,
                               params=_quantized(cfg, floats[c[0]], c[1]))
    out["requantized"] = dict(kind="generate", cfg=_t(_cfg("gqa", "int8")), bits=4,
                              params=floats["gqa"], prompts=PROMPTS, max_new=8)
    out["sampled"] = dict(kind="generate", cfg=_t(_cfg("tiny")), params=floats["tiny"],
                          prompts=PROMPTS, max_new=8, temperature=1.0)
    out["constrained"] = dict(kind="generate", cfg=_t(_cfg("mqa", "int8", "flash")), max_new=8,
                              params=_quantized(_cfg("mqa"), floats["mqa"], 4), prompts=PROMPTS,
                              schema="RISK_SCHEMA")
    out["bf16"] = dict(kind="steps", cfg=_t(gqa_bf16), steps=8, prompt=PROMPTS[1],
                       params=_quantized(gqa_bf16, floats["gqa"], 8))
    for name in ("gqa", "mqa"):
        for bits in (8, 4):
            out[f"layout-{name}-{bits}"] = dict(kind="layout", cfg=_t(_cfg(name)),
                                                params=_quantized(_cfg(name), floats[name],
                                                                  bits))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    x[:, 70] *= 8.0           # the rows' absmax lies in rank 1's slice
    w = (rng.standard_normal((128, 48)) / 11.3).astype(np.float32)
    for bits in (8, 4):
        out[f"rowpar-{bits}"] = dict(kind="rowpar", bits=bits, x=x, w=w)
    for name, bits, kv, attn in (("gqa", 4, "int8", "einsum"), ("gqa", 8, "", "flash"),
                                 ("mqa", 0, "int8", "flash"), ("tiny", 4, "", "flash")):
        cfg = _cfg(name, kv, attn)
        out[f"methods-{name}-{bits}-{kv or 'f'}-{attn}"] = dict(
            kind="methods", cfg=_t(cfg), params=_quantized(cfg, floats[name], bits))
    draft = dict(draft_cfg=_t(dataclasses.replace(TINY, layers=1, kv_dtype="int8")),
                 draft_params=floats["draft"])
    out["spec"] = dict(kind="spec", cfg=_t(_cfg("gqa", "int8")), prompts=PROMPTS, max_new=16,
                       params=_quantized(_cfg("gqa"), floats["gqa"], 4), **draft)
    serve_cfg = _t(_cfg("gqa", max_len=1024))
    server = dict(kind="server", cfg=serve_cfg, params=floats["gqa"], prompts=SERVE_PROMPTS,
                  max_new=12, slots=4, prefill_chunk=128)
    out["server"] = server
    out["server-draft"] = dict(server, **draft)
    out["save"] = dict(kind="save", cfg=_t(_cfg("gqa")), params=floats["gqa"],
                       path=str(tmp_path_factory.mktemp("tp") / "lm"))
    return out


@pytest.fixture(scope="module")
def runs(cases, floats):
    """(every rank's results, the one-process port's, JAX's): JAX's TP
    programs compile in threads while the two ranks run."""
    one_names = [n for n, c in cases.items() if c["kind"] in ("methods", "rowpar")]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(launch, workers.run_cases, 1, 2, cases, device="cpu", timeout=400)
        want = {_gen_id(c): pool.submit(_jax_tp, _cfg(c[0], c[2], c[3]), floats[c[0]], c[1],
                                        PROMPTS, 8) for c in GEN}
        want["server"] = pool.submit(_jax_tp, _cfg("gqa", max_len=1024), floats["gqa"], 0,
                                     SERVE_PROMPTS, 12, True)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = workers.run_cases(None, {k: cases[k] for k in one_names + [
                "requantized", "constrained"]})
        finally:
            torch.set_num_threads(n)
        return ranks.result(), one, {k: f.result() for k, f in want.items()}


@pytest.mark.parametrize("case", GEN, ids=_gen_id)
def test_tp_greedy_strings_equal_jax_tp(runs, case):
    ranks, _, want = runs
    name = _gen_id(case)
    assert ranks[0][name]["texts"] == ranks[1][name]["texts"] == want[name]
    assert all(r[name]["pick_mismatches"] == 0 for r in ranks)
    assert any(want[name])                      # the comparison is not of empty replies


def test_tp_quantize_weights_constraint_and_sampling_follow_rank_zero(runs):
    """``quantize_weights(4)`` on a tp=2 generator (the whole float tree
    gathered, quantized, cut) gives the one-process port's greedy strings,
    and so does decoding under ``RISK_SCHEMA``'s DFA over the gathered
    logits (int4, one KV head held by both ranks); sampled tokens
    (temperature 1) are rank 0's on both ranks."""
    ranks, one, _ = runs
    for name in ("requantized", "constrained"):
        assert ranks[0][name]["texts"] == ranks[1][name]["texts"] == one[name]["texts"]
    assert all(t.startswith("{") for t in one["constrained"]["texts"])
    assert ranks[0]["sampled"]["texts"] == ranks[1]["sampled"]["texts"]
    assert ranks[0]["requantized"]["pick_mismatches"] == 0


def test_tp_bf16_greedy_tokens_obey_the_near_tie_rule(runs, cases):
    """bf16 activations, int8 weights (GQA): each of the 8 tp=2 greedy tokens
    is JAX's argmax on the same tokens, or scores in JAX's logits within
    twice the step's largest |port - JAX| logit of the maximum, and the
    logits are within 3% relative L2 (the bound of ``tests/test_torch_hf.py``
    for quantized weights)."""
    ranks = runs[0]
    got = ranks[0]["bf16"]
    assert got["tokens"] == ranks[1]["bf16"]["tokens"]
    case = cases["bf16"]
    jdec = JDecoder(DecoderConfig(**case["cfg"].__dict__))
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    jl, jc = jax.jit(jdec.prefill, static_argnums=3)(params, got["ids"].astype(np.int32),
                                                     got["mask"], got["ids"].shape[1] + 128)
    step = jax.jit(jdec.decode_step)
    for t, tok in zip(got["logits"], got["tokens"]):
        j = np.asarray(jl, np.float32)[0]
        noise = np.abs(t - j).max()
        assert np.linalg.norm(t - j) <= 0.03 * np.linalg.norm(j)
        assert j[tok] >= j.max() - 2 * noise
        jl, jc = step(params, jc, np.array([tok], np.int32))


def _unpack(q4):
    p = q4.astype(np.int32)
    lo = (p & 15) - 8
    return np.concatenate([lo, (p - lo - 8) >> 4], axis=-2)


def _channels(cfg, weight: str, r: int) -> np.ndarray:
    """Rank r's output channels (column cuts) or input rows (row cuts) of a
    weight, from Megatron's layout: its query heads and the KV heads they
    read; contiguous halves elsewhere; int8 ``w_gateup`` = [gate_r | up_r]."""
    H, dh, F = cfg.heads, cfg.hidden // cfg.heads, cfg.mlp_dim
    KH = cfg.kv_heads or H
    half = lambda n: np.arange(r * n // 2, (r + 1) * n // 2)   # noqa: E731
    if weight == "qkv":
        heads = half(H)
        kv = sorted({h // (H // KH) for h in heads})
        cols = [np.arange(h * dh, (h + 1) * dh) for h in heads]
        cols += [base + np.arange(k * dh, (k + 1) * dh) for base in (H * dh, (H + KH) * dh)
                 for k in kv]
        return np.concatenate(cols)
    if weight == "w_gateup":
        return np.concatenate([half(F), F + half(F)])
    return half({"attn_out": cfg.hidden, "w_down": F, "w_gate": F, "w_up": F,
                 "lm_head": cfg.vocab_size}[weight])


@pytest.mark.parametrize("weight,bits", [(w, 8) for w in ("qkv", "attn_out", "w_gateup",
                                                            "w_down", "lm_head")]
                         + [(w, 4) for w in ("qkv", "attn_out", "w_gate", "w_up", "w_down",
                                             "lm_head")])
def test_quantized_leaf_cut_equals_the_whole_trees_channels(runs, cases, weight, bits):
    """Column cuts (qkv by heads, gate, up, fused gate|up, the vocab) take
    the channels' codes (int4: unpacked, repacked as split halves of the
    rank's width) and scales; row cuts (attn_out, w_down) take the input
    rows of q/q4 (and of int4's equalizer t) and leave s whole. ``gather``
    rebuilds every leaf bit for bit. int8 fuses gate and up, int4 keeps
    them apart."""
    ranks = runs[0]
    for name in ("gqa", "mqa"):
        case = cases[f"layout-{name}-{bits}"]
        cfg = case["cfg"]
        full = case["params"]["lm_head"] if weight == "lm_head" else \
            case["params"]["blocks"][weight]
        row = weight in ("attn_out", "w_down")
        for r in range(2):
            res = ranks[r][f"layout-{name}-{bits}"]
            assert all(res["gathered_equal"].values())
            path = ("lm_head",) if weight == "lm_head" else ("blocks", weight)
            local = {k: res["local"][(*path, k)] for k in full}
            c = _channels(cfg, weight, r)
            if bits == 8 and row:
                np.testing.assert_array_equal(local["q"], full["q"][..., c])
                np.testing.assert_array_equal(local["s"], full["s"])
            elif bits == 8:
                np.testing.assert_array_equal(local["q"], full["q"][..., c, :])
                np.testing.assert_array_equal(local["s"], full["s"][..., c])
            elif row:
                np.testing.assert_array_equal(local["q4"], full["q4"][..., c])
                np.testing.assert_array_equal(local["t"], full["t"][..., c])
                np.testing.assert_array_equal(local["s"], full["s"])
            else:
                np.testing.assert_array_equal(_unpack(local["q4"]), _unpack(full["q4"])[..., c, :])
                planes = full["s"].reshape(*full["s"].shape[:-2], -1)
                np.testing.assert_array_equal(local["s"].reshape(planes[..., c].shape),
                                              planes[..., c])
                np.testing.assert_array_equal(local["t"], full["t"])


@pytest.mark.parametrize("bits", [8, 4])
def test_row_parallel_product_takes_the_whole_rows_absmax(runs, cases, bits):
    """Two ranks' row-parallel product, summed over "model", against the
    one-process product: within ``K 2^-24 sum|x||w|`` with the absmax maxed
    over the ranks; each rank's own absmax (``x``'s largest column lies in
    rank 1's slice) misses that bound."""
    ranks, one, _ = runs
    case = cases[f"rowpar-{bits}"]
    x, w = case["x"].astype(np.float64), case["w"].astype(np.float64)
    bound = x.shape[1] * 2.0 ** -24 * (np.abs(x) @ np.abs(w))
    want = one[f"rowpar-{bits}"]["group"]
    for r in ranks:
        got = r[f"rowpar-{bits}"]
        assert (np.abs(got["group"] - want) <= bound).all()
        assert not (np.abs(got["local"] - want) <= bound).all()


@pytest.mark.parametrize("name", ["methods-gqa-4-int8-einsum", "methods-gqa-8-f-flash",
                                  "methods-mqa-0-int8-flash", "methods-tiny-4-f-flash"])
def test_slot_methods_over_shards_match_one_process(runs, name):
    """``prefill_extend`` (40-151 rows), ``decode_step_slots``,
    ``extend_slots`` (lane 2 inactive: live lanes held) and a 7-token
    ``prefill_extend(all_logits=True)`` over the shards: each rank's
    gathered logits within SLOT_REL (relative L2) of the one process's."""
    ranks, one, _ = runs
    want = one[name]
    live = np.array([True, True, False, True])
    for r in ranks:
        for key in ("fill", "decode", "extend", "prefill_extend"):
            got, exp = r[name][key], want[key]
            if key in ("decode", "extend"):
                got, exp = got[live], exp[live]
            assert np.linalg.norm(got - exp) <= SLOT_REL * np.linalg.norm(exp), (key, r)


def test_speculative_generator_with_a_tp_target(runs):
    """A tp=2 int4 target with a whole 1-layer draft on every rank: the
    speculative strings are the target's greedy strings, on both ranks."""
    ranks = runs[0]
    for r in ranks:
        assert r["spec"]["texts"] == r["spec"]["target"] == ranks[0]["spec"]["texts"]
        assert r["spec"]["stats"]["rounds"] > 0


@pytest.mark.parametrize("name", ["server", "server-draft"])
def test_llm_server_on_rank_zero_with_a_follower(runs, name):
    """4 greedy requests served by rank 0 (the 400-token one lands in
    128-token pieces while the others decode) equal JAX's TP lockstep
    ``generate`` prompt by prompt; the follower finished the same requests
    with the same tokens, in the same order."""
    ranks, _, want = runs
    lead, follower = ranks[0][name], ranks[1][name]
    assert lead["texts"] == want["server"]
    assert lead["finished"] == follower["finished"] and len(lead["finished"]) == 4
    assert lead["stats"]["prefill_pieces"] >= 3 and lead["pick_mismatches"] == 0
    if name == "server-draft":
        assert lead["stats"]["spec_rounds"] > 0
        assert lead["stats"]["spec_rounds"] == follower["stats"]["spec_rounds"]


def test_a_dead_follower_makes_the_run_raise(floats):
    """The follower exits while rank 0 serves: ``launch`` kills rank 0 and
    raises, instead of rank 0 waiting on the follower for ever."""
    case = dict(kind="server", cfg=_t(_cfg("tiny")), params=floats["tiny"], prompts=PROMPTS,
                max_new=8, slots=2, prefill_chunk=128, die_after=1.0)
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        launch(workers.run_cases, 1, 2, {"dead": case}, device="cpu", timeout=120)


def test_tp_save_writes_jax_layout_and_loads_sharded(runs, cases, floats):
    for r in runs[0]:
        assert r["save"]["same_shard"]
    cfg, params = load_jax_checkpoint(cases["save"]["path"], device="cpu")
    assert cfg.kv_heads == 2
    for p in tree_paths(params):
        np.testing.assert_array_equal(tree_get(params, p).numpy(),
                                      tree_get(floats["gqa"], p))


@pytest.mark.parametrize("tp,change,match", [
    (3, {}, "does not divide heads"),
    (4, {"mlp_dim": 130}, "blocks/w_"),
    (4, {"vocab_size": 386}, "lm_head"),
    (4, {"vocab_size": 388, "bits": 4}, "odd"),
])
def test_a_model_axis_that_does_not_divide_raises(tp, change, match):
    """Heads over tp=3, an MLP of 130 or a vocabulary of 386 over tp=4, and
    an int4 vocabulary of 388 over 4 ranks (97 channels a rank: int4 packs
    channel pairs) raise with the leaf's name; nothing is cut silently."""
    change = dict(change)
    bits = change.pop("bits", None)
    cfg = tconfig.DecoderConfig(**{**TINY.__dict__, **change})
    full = tdecoder.init_params(cfg, seed=0, device="cpu", bits=bits)
    mesh = types.SimpleNamespace(tp=tp, model_rank=0, model_group=None)
    with pytest.raises(ValueError, match=match):
        tdecoder.decoder_layout(cfg, full, mesh)


def test_tp_generator_defaults_to_the_mesh_device():
    """A generator over a mesh runs on the mesh's device, and its mesh has
    no data axis (one generator's ranks hold one model)."""
    cfg = _t(_cfg("tiny"))
    mesh = types.SimpleNamespace(dp=1, tp=1, model_rank=0, model_group=None,
                                 device=torch.device("cpu"))
    gen = Generator(cfg, tdecoder.init_params(cfg, seed=0, device="cpu"), mesh=mesh,
                    device="cuda")
    assert gen.device == torch.device("cpu") and gen.model.tp is None
    with pytest.raises(ValueError, match="data axis 2"):
        Generator(cfg, gen.params, mesh=types.SimpleNamespace(**{**mesh.__dict__, "dp": 2}))
