"""The port's LM training path against the JAX package, on the CPU.

The plain flash backward against JAX's interpreted Pallas backward
(``jax.grad(flash_attention)``) and the per-element bound the card holds
B10a/B10b to; ``Decoder.apply`` logits and ``lm_loss`` gradients in every
remat mode against JAX's on the same converted weights (a tiny f32 decoder:
hidden 64, 2 layers, 4q/2kv, q/k/v bias); the optax schedule; three
``LMTrainer`` steps (AdamW and Adafactor) and three ``LoraTrainer`` steps
against JAX's trainers on the same batches; checkpoints and adapters that
load in both packages; and ``train_lm.main`` on a corpus excerpt, its
checkpoint served by the port's ``Generator``. Inputs come from
``np.random.default_rng`` or the repo's corpus; every tolerance is stated
where it is asserted. Every port call passes ``device="cpu"``.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mediquery_rag_tpu.config import DecoderConfig, LoraConfig, TrainConfig
from mediquery_rag_tpu.ingest.parser import parse_corpus_file as jparse
from mediquery_rag_tpu.models import lora as jlora
from mediquery_rag_tpu.models import train_lm as jtrain
from mediquery_rag_tpu.models.byte_tokenizer import ByteTokenizer as JByteTok
from mediquery_rag_tpu.models.decoder import Decoder as JDecoder
from mediquery_rag_tpu.models.generate import Generator as JGenerator
from mediquery_rag_tpu.ops.attention import flash_attention as jflash
from mediquery_rag_tpu_torch.config import DecoderConfig as TDecoderConfig
from mediquery_rag_tpu_torch.config import LoraConfig as TLoraConfig
from mediquery_rag_tpu_torch.config import TrainConfig as TTrainConfig
from mediquery_rag_tpu_torch.ingest import parse_corpus_file
from mediquery_rag_tpu_torch.models import ByteTokenizer, Decoder, Generator
from mediquery_rag_tpu_torch.models import lora as tlora
from mediquery_rag_tpu_torch.models import optim
from mediquery_rag_tpu_torch.models import train_lm as ttrain
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.ops import attention as tattn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
TINY = DecoderConfig(vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
                     mlp_dim=128, max_len=256, qkv_bias=True, dtype="float32",
                     attn_impl="flash")
EINSUM = replace(TINY, attn_impl="einsum")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfg(cfg):
    return TDecoderConfig(**cfg.__dict__)


def _port_params(jparams):
    return params_from_jax(_np_tree(jparams), device="cpu")


def _leaves(tree):
    """JAX tree-flatten order, numpy."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def jparams():
    params = JDecoder(TINY).init(jax.random.PRNGKey(0))
    qkv_b = np.random.default_rng(3).standard_normal(
        params["blocks"]["qkv_b"].shape).astype(np.float32) * 0.1
    params["blocks"]["qkv_b"] = jnp.asarray(qkv_b)    # non-zero biases
    return params


@pytest.fixture(scope="module")
def batch_np():
    """Two rows of 40 tokens: one right-padded by 5, one left-padded by 9."""
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 259, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.float32)
    mask[0, -5:] = 0.0
    mask[1, :9] = 0.0
    return ids, mask


# -- the flash backward -----------------------------------------------------------------

def _left_pad_masks(rng, b, s):
    mask = np.ones((b, s), np.float32)
    for i in range(b):
        mask[i, : int(rng.integers(1, s // 3))] = 0.0
    return mask


@pytest.mark.parametrize("b,h,kh,s,dh", [(2, 4, 2, 70, 64),    # GQA, ragged S
                                         (1, 6, 6, 33, 32)])   # MHA, tiny prime S
def test_flash_backward_plain_matches_jax(b, h, kh, s, dh):
    """``flash_attention``'s plain backward (autograd through the registered
    op) equals JAX's interpreted Pallas backward (dq+lse, dkv passes) with
    left-padded masks and a non-uniform cotangent that is 0 on pad rows,
    within rtol/atol 2e-4 (JAX's own test of its backward)."""
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, kh, s, dh)).astype(np.float32) for _ in "kv")
    mask = _left_pad_masks(rng, b, s)
    w = rng.standard_normal((b, h, s, dh)).astype(np.float32) * mask[:, None, :, None]
    jg = jax.grad(lambda q_, k_, v_: (jflash(q_, k_, v_, jnp.asarray(mask)) * w).sum(),
                  argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, torch.tensor(mask)) * torch.tensor(w)).sum().backward()
    for a, t in zip(jg, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=2e-4, atol=2e-4)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(tq, tk, tv, torch.tensor(mask), causal=False)


def _bwd_kernel_numerics(q, k, v, mask, out, dout, scale, *, tile=64, skip_tile=None,
                         ignore_mask=False, lse_shift=False, q_tile=64, head_parts=1):
    """B10a/B10b's arithmetic on the CPU: B10a's online softmax over KV
    tiles with the un-normalized dS rounded to bf16, dQ divided by l at the
    end, lse = m + log l; B10b's P = exp(s - lse) rounded to bf16 before dV
    and dS rounded before dK, summed in f32 over ``q_tile``-row query tiles
    at or below the diagonal (each KV head's query heads in
    ``head_parts`` parts, each part's f32 sum added in order before the
    bf16 rounding). Faults: ``skip_tile`` drops one KV tile,
    ``ignore_mask`` drops the key mask, ``lse_shift`` hands B10b a
    logsumexp off by the row max."""
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    bf = lambda t: t.to(torch.bfloat16).float()       # noqa: E731
    kf, vf = tattn._rep(k, g), tattn._rep(v, g)
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    vis = tattn._visible(torch.ones_like(mask) if ignore_mask else mask, S, Sk, True, None)
    s = s + (vis.float() - 1.0) * 1e9
    if skip_tile is not None:
        s[..., skip_tile * tile:(skip_tile + 1) * tile] = -float("inf")
    do = dout.float()
    D = (do * out.float()).sum(-1, keepdim=True)
    dp = do @ vf.transpose(-1, -2)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, dh))
    for t0 in range(0, Sk, tile):
        st = s[..., t0:t0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        ds = bf(p * (dp[..., t0:t0 + tile] - D) * scale)
        acc = acc * corr + ds @ kf[..., t0:t0 + tile, :]
        m = m_new
    lse = m + torch.log(l)
    if lse_shift:
        lse = lse - s.amax(-1, keepdim=True)
    P = torch.exp(s - lse)
    pb, dsb = bf(P), bf(P * (dp - D) * scale)
    dk = torch.zeros((B, KH, head_parts, Sk, dh))
    dv = torch.zeros((B, KH, head_parts, Sk, dh))
    for h in range(H):                 # B10b: query tiles in order, per head part
        kh, part = h // g, (h % g) // (g // head_parts)
        for r0 in range(0, S, q_tile):
            rows = slice(r0, r0 + q_tile)
            dv[:, kh, part] += pb[:, h, rows].transpose(-1, -2) @ do[:, h, rows]
            dk[:, kh, part] += dsb[:, h, rows].transpose(-1, -2) @ q.float()[:, h, rows]
    return ((acc / l).to(q.dtype), sum(dk.unbind(2)).to(k.dtype),
            sum(dv.unbind(2)).to(v.dtype))


@pytest.mark.parametrize("head_parts", [1, 4], ids=["in-block", "head-parts"])
def test_attention_grad_error_bound_separates_rounding_from_faults(head_parts):
    """The bound the card holds B10a/B10b to: the kernels' own bf16
    roundings stay under half of it on every element of dQ, dK and dV, with
    B10b summing the group in the block or (GQA under two waves) in f32
    parts per share of the query heads; a dropped KV tile, an ignored mask
    or a logsumexp off by the row max break it more than 4 times over."""
    g = torch.Generator().manual_seed(13)
    b, h, kh, s, dh = 1, 8, 2, 256, 64
    q = torch.randn((b, h, s, dh), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, s, dh), generator=g).to(torch.bfloat16) for _ in "kv")
    mask = torch.ones((b, s))
    mask[:, :20] = 0.0
    dout = (torch.randn((b, h, s, dh), generator=g) * mask[:, None, :, None]).to(torch.bfloat16)
    out = tattn.attention_plain(q, k, v, mask, 0.125, causal=True)
    refs = tattn.flash_attention_bwd_plain(q, k, v, mask, out, dout, 0.125)
    bounds = tattn.attention_grad_error_bound(q, k, v, mask, out, dout, 0.125, refs)

    def worst(got):
        return max((((x.float() - r.float()).abs() / bd).nan_to_num(0.0)).max().item()
                   for x, r, bd in zip(got, refs, bounds))

    args = (q, k, v, mask, out, dout, 0.125)
    assert worst(_bwd_kernel_numerics(*args, head_parts=head_parts)) < 0.5
    assert worst(_bwd_kernel_numerics(*args, skip_tile=1, head_parts=head_parts)) > 4.0
    assert worst(_bwd_kernel_numerics(*args, ignore_mask=True, head_parts=head_parts)) > 4.0
    assert worst(_bwd_kernel_numerics(*args, lse_shift=True, head_parts=head_parts)) > 4.0


# -- Decoder.apply ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [TINY, EINSUM], ids=["flash", "einsum"])
def test_decoder_apply_logits_match_jax(jparams, batch_np, cfg):
    """f32 logits within 1e-4 of JAX's ``Decoder.apply`` on every real
    token (a left-pad row has no visible key; both sides give finite
    values there that no loss reads)."""
    ids, mask = batch_np
    jl = np.asarray(JDecoder(cfg).apply(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    dec = Decoder(_tcfg(cfg), _port_params(jparams))
    tl = dec.apply(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl[mask > 0], jl[mask > 0], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def jax_grads(jparams, batch_np):
    ids, mask = batch_np

    def loss(p):
        return jtrain.lm_loss(JDecoder(TINY).apply(p, jnp.asarray(ids), jnp.asarray(mask)),
                              jnp.asarray(ids), jnp.asarray(mask))

    return _leaves(jax.grad(loss)(jparams))


@pytest.mark.parametrize("remat,fwd_calls", [(False, 2), (True, 4), ("dots", 4),
                                             ("names", 2)])
def test_lm_loss_grads_match_jax_every_remat(jparams, batch_np, jax_grads, remat,
                                             fwd_calls, monkeypatch):
    """``lm_loss`` gradients of every parameter within 2e-4 of JAX's, in
    each remat mode, and the flash forward runs once per layer per step for
    False and "names" (its output is kept) and twice for True and "dots"
    (the recompute runs it again): the rule B6's launch count follows on the
    card."""
    ids, mask = batch_np
    params = ttrain._leaves_on(_port_params(jparams), "cpu")
    calls = []
    plain = tattn.attention_plain
    monkeypatch.setattr(tattn, "attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    logits = Decoder(_tcfg(TINY), params).apply(torch.from_numpy(ids),
                                                torch.from_numpy(mask), remat=remat)
    loss = ttrain.lm_loss(logits, torch.from_numpy(ids), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    assert len(calls) == fwd_calls
    for a, t in zip(jax_grads, grads):
        np.testing.assert_allclose(t.numpy(), a, rtol=0, atol=2e-4)
    with pytest.raises(ValueError):
        Decoder(_tcfg(TINY), params).apply(torch.from_numpy(ids), torch.from_numpy(mask),
                                           remat="everything")


def test_apply_refuses_quantized_params(jparams):
    from mediquery_rag_tpu_torch.ops.matvec import quantize_decoder_params
    dec = Decoder(_tcfg(TINY), quantize_decoder_params(_port_params(jparams), bits=8))
    with pytest.raises(ValueError, match="float"):
        dec.apply(torch.ones((1, 8), dtype=torch.long), torch.ones((1, 8)))


# -- optimizers and trainers --------------------------------------------------------------

def test_schedule_bit_equal_to_optax():
    """``warmup_cosine_decay_schedule`` gives optax's float32 bits at ten
    counts across the warmup, the join and past the horizon."""
    for args in [(0.0, 3e-4, 20, 10_000), (0.0, 1e-2, 1, 10)]:
        j = optax.warmup_cosine_decay_schedule(*args)
        t = optim.warmup_cosine_decay_schedule(*args)
        for c in (0, 1, 2, 5, 19, 20, 21, 500, 9_999, 20_000):
            assert np.float32(j(jnp.int32(c))).tobytes() == t(c).numpy().tobytes(), (args, c)


@pytest.fixture(scope="module")
def batches():
    """Three batches of two corpus samples from both loaders (same seed):
    the port's loader gives JAX's batches."""
    texts = ttrain.corpus_lm_texts(parse_corpus_file(CORPUS))[:6]
    jtexts = jtrain.corpus_lm_texts(jparse(CORPUS))[:6]
    assert texts == jtexts
    jb = list(jtrain.LMLoader(jtexts, JByteTok(TINY.max_len), 2, seed=5).batches(1))
    tb = list(ttrain.LMLoader(texts, ByteTokenizer(TINY.max_len), 2, seed=5).batches(1))
    assert len(jb) == len(tb) == 3
    for a, t in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a.ids), t.ids.numpy())
        np.testing.assert_array_equal(np.asarray(a.mask), t.mask.numpy())
    return jb, tb


def _rel(a, b):
    """Relative error of a parameter tensor: ||a - b|| / ||a|| (Frobenius)."""
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


TRAIN = TrainConfig(lr=1e-2, warmup_steps=1, decay_steps=10, weight_decay=0.01,
                    remat="names")


@pytest.mark.parametrize("opt,cfg", [("adamw", TINY), ("adafactor", EINSUM)])
def test_lm_trainer_three_steps_match_jax(jparams, batches, opt, cfg):
    """Three ``LMTrainer`` steps from the same converted params over the
    same batches: loss and grad norm within 1e-4 of JAX's at every step,
    every parameter tensor within 1e-5 relative (Frobenius norm) after."""
    tcfg = replace(TRAIN, optimizer=opt)
    jt = jtrain.LMTrainer(cfg, tcfg)
    own = jax.tree_util.tree_map(jnp.array, jparams)     # the JAX step donates its state
    jstate = jtrain.LMTrainState(own, jt.tx.init(own), jnp.int32(0))
    tt = ttrain.LMTrainer(_tcfg(cfg), TTrainConfig(**tcfg.__dict__), device="cpu")
    tstate = tt.init_state(params=_port_params(jparams))
    for jb, tb in zip(*batches):
        jstate, jm = jt.train_step(jstate, jb)
        tstate, tm = tt.train_step(tstate, tb)
        assert abs(float(jm["loss"]) - float(tm["loss"])) < 1e-4
        assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) < 1e-4
    assert tstate.step == 3
    for a, t in zip(_leaves(jstate.params), optim.tree_leaves(tstate.params)):
        assert _rel(a, t.detach().numpy()) < 1e-5, _rel(a, t.detach().numpy())


def test_lm_trainer_model_follows_its_params(jparams, batches):
    """One trainer, two states used in turn: the decoder it steps is built
    on the given state's own leaves each time, and a step of one state
    leaves the other bit-unchanged."""
    tt = ttrain.LMTrainer(_tcfg(TINY), TTrainConfig(**TRAIN.__dict__), device="cpu")
    one = tt.init_state(params=_port_params(jparams))
    two = tt.init_state(seed=1)
    for state in (one, two, one, two):
        built = {t.data_ptr() for t in tt.model(state.params).buffers()}
        assert built == {t.data_ptr() for t in optim.tree_leaves(state.params)}
    kept = [t.detach().clone() for t in optim.tree_leaves(one.params)]
    for tb in batches[1][:2]:
        two, _ = tt.train_step(two, tb)
    assert all(torch.equal(a, b) for a, b in zip(kept, optim.tree_leaves(one.params)))


def test_lm_trainer_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 13"):
        ttrain.LMTrainer(_tcfg(TINY), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        ttrain.main(["--dp", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 13"):
        tlora.lora_partition_specs(None, TLoraConfig())


def test_lora_trainer_three_steps_match_jax(jparams, batches):
    """Three ``LoraTrainer`` steps from JAX's fresh adapters: loss, grad and
    delta norms within 1e-4, adapters within 1e-5 relative, the base params
    bit-unchanged, and the merged params equal JAX's merge."""
    lcfg = LoraConfig(rank=4, alpha=8.0)
    tcfg = replace(TRAIN, remat=True)
    jt = jlora.LoraTrainer(TINY, lcfg, tcfg)
    jstate = jt.init_state(jax.random.PRNGKey(1), jparams)
    tt = tlora.LoraTrainer(_tcfg(TINY), TLoraConfig(**lcfg.__dict__),
                           TTrainConfig(**tcfg.__dict__), device="cpu")
    base = _port_params(jparams)
    before = [t.clone() for t in optim.tree_leaves(base)]
    tstate = tt.init_state(0, base, adapters=params_from_jax(_np_tree(jstate.adapters),
                                                            device="cpu"))
    for jb, tb in zip(*batches):
        jstate, jm = jt.train_step(jstate, jparams, jb)
        tstate, tm = tt.train_step(tstate, base, tb)
        for key in ("loss", "grad_norm", "delta_norm"):
            assert abs(float(jm[key]) - float(tm[key])) < 1e-4, key
    assert float(tm["delta_norm"]) > 0
    for a, t in zip(_leaves(jstate.adapters), optim.tree_leaves(tstate.adapters)):
        assert _rel(a, t.detach().numpy()) < 1e-5, _rel(a, t.detach().numpy())
    assert all(torch.equal(a, b) for a, b in zip(before, optim.tree_leaves(base)))
    jm = _leaves(jlora.lora_merge(jparams, jstate.adapters, lcfg))
    with torch.no_grad():
        tm = optim.tree_leaves(tlora.lora_merge(base, tstate.adapters,
                                                TLoraConfig(**lcfg.__dict__)))
    for a, t in zip(jm, tm):
        assert _rel(a, t.numpy()) < 1e-5
    fresh = tlora.lora_init(0, base, TLoraConfig(**lcfg.__dict__))
    assert set(fresh) == set(lcfg.targets) and all(
        not ab["b"].any() for ab in fresh.values())


# -- files both packages read ------------------------------------------------------------

def test_generator_save_and_adapters_load_in_both_packages(jparams, tmp_path):
    """A port ``Generator.save`` checkpoint loads in JAX and greedy-decodes
    the same text; adapters saved by either package load in the other
    unchanged."""
    prompts = ["<|user|>\n高血压<|end|><|assistant|>\n", "hello"]
    tgen = Generator(_tcfg(TINY), _port_params(jparams), device="cpu")
    tgen.save(str(tmp_path / "lm"))
    jgen = JGenerator.from_checkpoint(str(tmp_path / "lm"))
    assert jgen.generate(prompts, max_new_tokens=12) == tgen.generate(prompts, max_new_tokens=12)
    for a, b in zip(_leaves(jgen.params), _leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="float"):
        Generator(_tcfg(TINY), _port_params(jparams), device="cpu").quantize_weights(8).save(
            str(tmp_path / "q"))

    lcfg = LoraConfig(rank=4, alpha=8.0, targets=("qkv", "w_down"))
    jad = jlora.lora_init(jax.random.PRNGKey(2), jparams, lcfg)
    jad = jax.tree_util.tree_map(lambda x: x + 0.5, jad)          # b non-zero too
    jlora.save_adapters(str(tmp_path / "jad"), jad, lcfg)
    tad, tcfg = tlora.load_adapters(str(tmp_path / "jad"), device="cpu")
    assert tcfg == TLoraConfig(**lcfg.__dict__)
    for a, t in zip(_leaves(jad), optim.tree_leaves(tad)):
        np.testing.assert_array_equal(a, t.numpy())
    tlora.save_adapters(str(tmp_path / "tad"), tad, tcfg)
    back, bcfg = jlora.load_adapters(str(tmp_path / "tad"))
    assert bcfg == lcfg
    for a, b in zip(_leaves(back), _leaves(jad)):
        np.testing.assert_array_equal(a, b)


def test_train_lm_main_checkpoint_serves(tmp_path):
    """``train_lm.main --layers 2 --epochs 1 --device cpu`` on three corpus
    chunks trains, saves a checkpoint, and the port's ``Generator`` serves
    it."""
    with open(CORPUS, encoding="utf-8") as f:
        blocks = f.read().split("\n\n")
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n\n".join(blocks[:3]) + "\n", encoding="utf-8")
    out = tmp_path / "lm"
    ttrain.main(["--corpus", str(corpus), "--out", str(out), "--layers", "2",
                 "--epochs", "1", "--batch-size", "2", "--device", "cpu"])
    gen = Generator.from_checkpoint(str(out), device="cpu")
    assert gen.cfg.layers == 2
    (text,) = gen.generate(["<|user|>\n高血压<|end|><|assistant|>\n"], max_new_tokens=4)
    assert isinstance(text, str)
