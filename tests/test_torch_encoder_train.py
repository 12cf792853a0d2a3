"""Parity of the port's encoder and grader training with the JAX package, on
the CPU.

The data pipeline (pairs, self-supervised examples, mined hard negatives,
the pair and triplet loaders), ``ContrastiveTrainer`` and
``CrossEncoderTrainer`` steps against JAX's from the same params over the
same batches, ``train_cross_encoder``'s loop, and the two training entry
points, whose checkpoints JAX loads. Tiny widths (2 layers, hidden 64, 4
heads, MLP 128, vocab 512, 128 tokens), f32 activations and dropout 0
where steps are compared (dropout masks come from a ``torch.Generator``
and cannot equal JAX's). Every port call passes ``device="cpu"``;
tolerances are stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.config import EmbedderConfig as JEmbedderConfig
from mediquery_rag_tpu.config import TrainConfig as JTrainConfig
from mediquery_rag_tpu.ingest.parser import parse_corpus_file as jparse
from mediquery_rag_tpu.models import cross_encoder as jce
from mediquery_rag_tpu.models import data as jdata
from mediquery_rag_tpu.models import trainer as jtrainer
from mediquery_rag_tpu.models.cross_encoder import TrainedGrader as JTrainedGrader
from mediquery_rag_tpu.models.text_embedder import TextEmbedder as JTextEmbedder
from mediquery_rag_tpu.models.tokenizer import HashCharTokenizer as JTok
from mediquery_rag_tpu_torch.config import EmbedderConfig, TrainConfig
from mediquery_rag_tpu_torch.ingest import parse_corpus_file
from mediquery_rag_tpu_torch.models import HashingEmbedder, optim
from mediquery_rag_tpu_torch.models import cross_encoder as tce
from mediquery_rag_tpu_torch.models import data as tdata
from mediquery_rag_tpu_torch.models import train as ttrain
from mediquery_rag_tpu_torch.models import train_grader as ttrain_grader
from mediquery_rag_tpu_torch.models import trainer as ttrainer
from mediquery_rag_tpu_torch.models.text_embedder import TextEmbedder
from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=128,
            dtype="float32")
TRAIN = dict(batch_size=4, lr=1e-3, warmup_steps=1, decay_steps=10, remat=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test processes share the cores: torch runs on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chunks():
    """The corpus parsed by both packages (equal, field for field)."""
    ours, theirs = parse_corpus_file(CORPUS), jparse(CORPUS)
    assert [c.__dict__ for c in ours] == [c.__dict__ for c in theirs]
    return ours, theirs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


def _params_close(jparams, tparams, init):
    """Every leaf within 1e-5 relative (Frobenius norm) of JAX's; a leaf
    that starts at zero (the biases, ``score_b``) holds only its Adam
    updates, whose normalization m / sqrt(v) magnifies the gradients'
    f32 sum-order differences where they are small: within 1e-4 there."""
    for a, t, z in zip(jax.tree_util.tree_leaves(jparams), optim.tree_leaves(tparams),
                       jax.tree_util.tree_leaves(init)):
        tol = 1e-4 if not np.asarray(z).any() else 1e-5
        assert _rel(a, t.detach().numpy()) < tol, (np.shape(a), _rel(a, t.detach().numpy()))


def _batches_equal(ours, theirs):
    for t, j in zip(ours, theirs):
        for a, b in zip(t, j):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_data_pipeline_matches_jax(chunks):
    """Pairs, self-supervised examples (colloquialized titles, tags,
    inverse-cloze crops), hard negatives mined from one lexical embedder,
    and the first batches of ``PairLoader`` and ``TripletLoader`` for the
    same seed: equal to JAX's (batches as int32 ids and f32 masks)."""
    ours, theirs = chunks
    assert tdata.pairs_from_chunks(ours) == jdata.pairs_from_chunks(theirs)
    ex = tdata.ssl_examples_from_chunks(ours[:40], seed=3)
    assert ex == jdata.ssl_examples_from_chunks(theirs[:40], seed=3) and len(ex) > 80
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    title = ours[0].title
    assert tdata.colloquialize(title, rng, p=1.0) == jdata.colloquialize(title, jrng, p=1.0)
    lex = HashingEmbedder(64)
    negs = tdata.mine_hard_negatives(ex, ours[:40], lex, k=4, seed=2)
    assert negs == jdata.mine_hard_negatives(ex, theirs[:40], lex, k=4, seed=2)
    tok, jtok = HashCharTokenizer(512, 128), JTok(512, 128)
    trip = tdata.TripletLoader(ex, negs, tok, 4, seed=5, max_len=64).batches()
    jtrip = jdata.TripletLoader(ex, negs, jtok, 4, seed=5, max_len=64).batches()
    _batches_equal([next(trip) for _ in range(3)], [next(jtrip) for _ in range(3)])
    pairs = tdata.pairs_from_chunks(ours)
    pl = tdata.PairLoader(pairs, tok, 4, seed=5).batches(epochs=1)
    jpl = jdata.PairLoader(pairs, jtok, 4, seed=5).batches(epochs=1)
    first = next(pl)
    assert first.q_ids.dtype == torch.int32 and first.n_ids is None
    _batches_equal([first, next(pl)], [next(jpl), next(jpl)])
    with pytest.raises(ValueError):
        tdata.PairLoader([], tok, 4)


@pytest.fixture(scope="module")
def contrastive(chunks):
    """JAX's initial params (key 0) and three batches of triplets (the
    port's loader, equal to JAX's above) at 64 tokens."""
    ours, _ = chunks
    ex = tdata.ssl_examples_from_chunks(ours[:30], seed=0)
    negs = tdata.mine_hard_negatives(ex, ours[:30], HashingEmbedder(64), k=4)
    loader = tdata.TripletLoader(ex, negs, HashCharTokenizer(512, 128), 4, seed=0,
                                 max_len=64)
    batches = [b for b, _ in zip(loader.batches(), range(3))]
    params = jtrainer.ContrastiveTrainer(JEmbedderConfig(**TINY)).init_state(
        jax.random.PRNGKey(0)).params
    return jax.tree_util.tree_map(np.asarray, params), batches


@pytest.mark.parametrize("negatives", [False, True], ids=["in-batch", "hard-negatives"])
def test_contrastive_trainer_three_steps_match_jax(contrastive, negatives):
    """Three ``ContrastiveTrainer`` steps (AdamW under warmup-cosine after
    clipping at 1.0, ``remat=True``) from JAX's params over the same
    batches, with and without mined hard negatives: loss and grad norm
    within 1e-4 of JAX's at every step, the parameters after as
    ``_params_close`` holds them."""
    params, batches = contrastive
    if not negatives:
        batches = [b._replace(n_ids=None, n_mask=None) for b in batches]
    jt = jtrainer.ContrastiveTrainer(JEmbedderConfig(**TINY), JTrainConfig(**TRAIN))
    own = jax.tree_util.tree_map(jnp.array, params)
    jstate = jtrainer.TrainState(own, jt.tx.init(own), jnp.int32(0))
    tt = ttrainer.ContrastiveTrainer(EmbedderConfig(**TINY), TrainConfig(**TRAIN),
                                     device="cpu")
    tstate = tt.init_state(params=params)
    for b in batches:
        jb = jtrainer.Batch(*(None if t is None else jnp.asarray(t.numpy()) for t in b))
        jstate, jm = jt.train_step(jstate, jb)
        tstate, tm = tt.train_step(tstate, b)
        assert abs(float(jm["loss"]) - float(tm["loss"])) < 1e-4
        assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) < 1e-4
    assert tstate.step == 3
    _params_close(jstate.params, tstate.params, params)


def test_info_nce_loss_matches_optax():
    """``info_nce_loss`` with and without hard negatives against JAX's
    (optax's cross-entropy), within 1e-6."""
    rng = np.random.default_rng(0)
    q, d, n = (rng.standard_normal((5, 16)).astype(np.float32) for _ in range(3))
    for neg in (None, n):
        want = float(jtrainer.info_nce_loss(q, d, 0.05, None if neg is None else neg))
        got = float(ttrainer.info_nce_loss(
            torch.from_numpy(q), torch.from_numpy(d), 0.05,
            None if neg is None else torch.from_numpy(neg)))
        assert abs(want - got) < 1e-6 * max(1.0, abs(want))


def test_dropout_views_and_remat_agree(contrastive):
    """With ``dropout > 0`` two passes over one batch differ (SimCSE views),
    and a recomputed block (``remat=True``) reuses its masks: the loss and
    every gradient equal the saved-activation run's for the same generator
    seed (within 1e-6 relative)."""
    params, batches = contrastive
    cfg = EmbedderConfig(**dict(TINY, dropout=0.1))
    grads = {}
    for remat in (False, True):
        tt = ttrainer.ContrastiveTrainer(cfg, TrainConfig(**dict(TRAIN, remat=remat)),
                                         device="cpu")
        state = tt.init_state(params=params)
        tt.generator.manual_seed(7)
        loss = tt.loss(state.params, batches[0])
        grads[remat] = (loss, torch.autograd.grad(loss, optim.tree_leaves(state.params)))
    assert torch.allclose(grads[False][0], grads[True][0], rtol=1e-6)
    for a, b in zip(grads[False][1], grads[True][1]):
        assert _rel(a.numpy(), b.numpy()) < 1e-6
    model = tt.model(state.params)
    b = batches[0]
    one = model(b.q_ids, b.q_mask, generator=tt.generator)
    two = model(b.q_ids, b.q_mask, generator=tt.generator)
    assert not torch.allclose(one, two) and torch.equal(
        model(b.q_ids, b.q_mask), model(b.q_ids, b.q_mask))


def test_trainers_refuse_a_mesh():
    """A mesh that is not a training mesh (``parallel.dist.TrainMesh``)
    raises, and ``--dp`` that does not split ``--batch-size`` raises before
    any rank is spawned (the mesh itself runs in
    ``tests/test_torch_mesh_train.py``)."""
    with pytest.raises(TypeError, match="TrainMesh"):
        ttrainer.ContrastiveTrainer(EmbedderConfig(**TINY), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="split"):
        ttrain.main(["--dp", "2", "--batch-size", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="split"):
        ttrain.main(["--dp", "4", "--tp", "2", "--batch-size", "6", "--device", "cpu"])


def _pair_batches(chunks, n):
    tok = JTok(512, 128)
    out = []
    for i in range(n):
        sel = chunks[3 * i: 3 * i + 3]
        qs, ds = [c.title for c in sel], [c.content for c in sel]
        neg = [ds[(j + 1) % 3] for j in range(3)]
        ids, mask, seg = jce.encode_pairs(tok, qs + qs, ds + neg)
        out.append((ids, mask, seg, np.r_[np.ones(3), np.zeros(3)]))
    return out


def test_cross_encoder_trainer_three_steps_match_jax(chunks):
    """Three ``CrossEncoderTrainer`` steps (optax ``adamw(3e-4)``, weight
    decay 1e-4, the stable BCE-with-logits) from JAX's params over the same
    pair batches (rolled negatives): loss within 1e-4 of JAX's at every
    step, the parameters after as ``_params_close`` holds them."""
    cfg = JEmbedderConfig(**TINY)
    jt = jce.CrossEncoderTrainer(cfg, lr=3e-4)
    jparams, jopt = jt.init(jax.random.PRNGKey(0))
    tt = tce.CrossEncoderTrainer(EmbedderConfig(**TINY), lr=3e-4, device="cpu")
    init = jax.tree_util.tree_map(np.asarray, jparams)
    tparams, topt = tt.init(params=init)
    for ids, mask, seg, labels in _pair_batches(chunks[0], 3):
        jparams, jopt, jl = jt.step(jparams, jopt, ids, mask, seg, labels)
        tparams, topt, tl = tt.step(tparams, topt, ids, mask, seg, labels)
        assert abs(float(jl) - float(tl)) < 1e-4
    _params_close(jparams, tparams, init)


def test_train_cross_encoder_loop_matches_jax(chunks):
    """``train_cross_encoder`` (numpy permutation, rolled negatives, a last
    batch of one skipped) from JAX's initial params (key 0, as JAX's loop
    draws them): the final loss within 1e-4, the params as
    ``_params_close`` holds them."""
    pairs = [(c.title, c.content) for c in chunks[0][:7]]
    cfg = JEmbedderConfig(**TINY)
    init = jce.CrossEncoder(cfg).init(jax.random.PRNGKey(0))
    jp, _, jloss = jce.train_cross_encoder(pairs, cfg, epochs=2, batch_size=3, lr=3e-4)
    tp, tok, tloss = tce.train_cross_encoder(
        pairs, EmbedderConfig(**TINY), epochs=2, batch_size=3, lr=3e-4, device="cpu",
        params=jax.tree_util.tree_map(np.asarray, init))
    assert abs(jloss - tloss) < 1e-4 and tok == HashCharTokenizer(512, 128)
    _params_close(jp, tp, init)


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """The first 3 chunks of the corpus file."""
    with open(CORPUS, encoding="utf-8") as f:
        raw = f.read()
    starts = [i for i in range(len(raw)) if raw.startswith("chunk_id", i)
              and (i == 0 or raw[i - 1] == "\n")]
    path = tmp_path_factory.mktemp("corpus") / "three.txt"
    path.write_text(raw[:starts[3]], encoding="utf-8")
    assert len(parse_corpus_file(str(path))) == 3
    return str(path)


def test_train_main_writes_a_checkpoint_jax_loads(small_corpus, tmp_path, capsys):
    """``python -m mediquery_rag_tpu_torch.models.train --device cpu`` (one
    layer of the default widths, 2 epochs, batch 2) saves a ``TextEmbedder``
    checkpoint: JAX's ``from_checkpoint`` loads it, leaf for leaf equal to
    the port's own load, and embeds as the port does (bf16 activations:
    per-row cosine >= 0.9999)."""
    out = str(tmp_path / "emb")
    ttrain.main(["--corpus", small_corpus, "--out", out, "--epochs", "2",
                 "--batch-size", "2", "--layers", "1", "--device", "cpu"])
    assert "saved params" in capsys.readouterr().out
    j, t = JTextEmbedder.from_checkpoint(out), TextEmbedder.from_checkpoint(out, device="cpu")
    assert j.cfg.layers == 1 and t.cfg == EmbedderConfig(layers=1)
    texts = ["高血压饮食", "糖尿病的早期症状"]
    assert (j.embed(texts) * t.embed(texts)).sum(1).min() >= 0.9999


def test_train_grader_main_writes_a_checkpoint_jax_loads(small_corpus, tmp_path, capsys):
    """``python -m mediquery_rag_tpu_torch.models.train_grader --device cpu``
    at JAX's grader config (vocab 2048, hidden 128, 2 layers, 4 heads, MLP
    256, 192 tokens, bf16), 2 epochs: JAX's ``TrainedGrader`` loads the
    checkpoint and scores as the port does (bf16: within 1e-2 of logits
    of order 1), and the port's CLI grader loads it."""
    out = str(tmp_path / "grader")
    ttrain_grader.main(["--corpus", small_corpus, "--out", out, "--epochs", "2",
                        "--device", "cpu"])
    assert "saved grader" in capsys.readouterr().out
    j, t = JTrainedGrader.from_checkpoint(out), tce.TrainedGrader.from_checkpoint(
        out, device="cpu")
    assert t.cfg == ttrain_grader.grader_config() and j.cfg.max_len == 192
    qs, ds = ["高血压饮食", "头痛"], ["高血压患者应限盐", "偏头痛的缓解方法"]
    np.testing.assert_allclose(tce.score_pairs(t.params, t.cfg, qs, ds),
                               jce.score_pairs(j.params, j.cfg, qs, ds), atol=1e-2)
    assert isinstance(t(qs[0], ds), bool)


def test_grader_config_matches_jax():
    """The grader architecture both entry points train."""
    cfg = ttrain_grader.grader_config()
    want = JEmbedderConfig(vocab_size=2048, hidden=128, layers=2, heads=4, mlp_dim=256,
                           max_len=192, dtype="bfloat16")
    assert cfg.__dict__ == want.__dict__
    assert ttrain_grader.grader_config(hidden=64, layers=1).mlp_dim == 128
