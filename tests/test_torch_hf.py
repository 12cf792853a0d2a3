"""Parity of the port's HF checkpoint path with the JAX package, on the CPU.

The checkpoints are written by ``chip_smoke.py``'s own writers (safetensors
by hand, a byte-level BPE ``tokenizer.json`` learned from the corpus by a
counting loop, a WordPiece ``vocab.txt`` from the corpus's characters) at
tiny widths, so the code that writes the card's 7B-shaped checkpoint is
held here too: transformers and tokenizers read it as HF's own format. The
same files then go through the JAX package's importer, tokenizers and
models and through the port's. Every port call passes ``device="cpu"``;
the JAX side runs einsum attention (no interpreted flash kernel), its
quantized matmuls as the JAX package's CPU tests run them. Tolerances are
stated per test.

Texts stay within Unicode 15 (Python 3.12's ``unicodedata``): the JAX
tokenizer's ``regex`` package carries newer tables (9,568 code points
differ on ``\\p{L}``), so a character assigned after Unicode 15 may split
differently in the two packages.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mediquery_rag_tpu.llm.tpu_client import TPULLMClient
from mediquery_rag_tpu.models import Decoder as JDecoder
from mediquery_rag_tpu.models import bpe_tokenizer as jbpe
from mediquery_rag_tpu.models import constrain as jconstrain
from mediquery_rag_tpu.models import hf_import as jhf
from mediquery_rag_tpu.models.wordpiece_tokenizer import WordPieceTokenizer as JWordPiece
from mediquery_rag_tpu_torch.llm import TorchLLMClient
from mediquery_rag_tpu_torch.llm.torch_client import render_chat
from mediquery_rag_tpu_torch.models import Decoder, bpe_tokenizer as tbpe
from mediquery_rag_tpu_torch.models import constrain as tconstrain
from mediquery_rag_tpu_torch.models import hf_import as thf
from mediquery_rag_tpu_torch.models.convert import params_from_jax
from mediquery_rag_tpu_torch.models.wordpiece_tokenizer import WordPieceTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (the card's checkpoint writers)

CORPUS = os.path.join(ROOT, "data", "medical_data.txt")
with open(CORPUS, encoding="utf-8") as _f:
    LINES = _f.read().splitlines()
MERGES = 300
TINY_QWEN = dict(cs.QWEN25_7B, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, vocab_size=None,
                 max_position_embeddings=4096)
TINY_BERT = dict(cs.BERT_BASE_ZH, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128)
# texts where a hand-written pre-tokenizer can go wrong (all within Unicode 15)
TRICKY = [
    "高血压患者三十五岁，每天服药三次，十五天复查一次。",
    "第Ⅳ期 Ⅻ 与 ⅳ 的区别", "１２０／８０ｍｍＨｇ 全角数字", "café naïve é ä",
    "It's the doctor's NOTE, they'LL say we'Re fine; I'D go 'S 'ſ",
    "line1\r\nline2\r\n\r\n  \n\tindent \r\r\n", "\x1c\x1d\x1e\x1f 分隔符\x1fA\x1c1",
    "trailing spaces   ", "   ", "", "tab\t\tend\t",
    "<|im_start|>user\n血压高怎么办?<|im_end|>\n<|im_start|>assistant\n",
    "混在<|endoftext|>文中<|im_end|>x", "emoji 🌡️💊 🇨🇳 👨‍⚕️ test",
    " nbsp　ideographic sep\u0085nel", "BMI=23.9；血压 120/80 mmHg!!! ……",
    "x's y'T 'vE 'm 'lL 'd ''s", "  leading and  double  spaces\n\n", "数字12345和字母abc混合",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tier-1 runs six test processes on the machine's cores, and torch's
    default pool of one thread per core in each oversubscribes them: a
    decode loop of small ops then waits in thread barriers (10x slower
    here). Each test of this file runs torch on one thread; the count is
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Tiny checkpoints written by chip_smoke.py's writers: a Qwen2 (untied,
    3 shards, specials right after a dense vocabulary, 5 padding rows), its
    tied twin, and a BERT."""
    base = tmp_path_factory.mktemp("hf")
    dirs = {"qwen": str(base / "qwen"), "tied": str(base / "tied"), "bert": str(base / "bert")}
    cs.write_qwen2_checkpoint(dirs["qwen"], TINY_QWEN, LINES, seed=1, device="cpu",
                              shards=3, merges=MERGES, specials=None)
    cs.write_qwen2_checkpoint(dirs["tied"], dict(TINY_QWEN, tie_word_embeddings=True),
                              LINES, seed=2, device="cpu", shards=1, merges=MERGES,
                              specials=None)
    cs.write_bert_checkpoint(dirs["bert"], TINY_BERT, LINES, seed=3, device="cpu")
    return dirs


def _gpt2_variant(src: str, dst: str) -> str:
    """A copy of ``src``'s tokenizer whose pre-tokenizer is ByteLevel with
    use_regex, so both packages split with the GPT-2 pattern."""
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "tokenizer.json"), encoding="utf-8") as f:
        tj = json.load(f)
    tj["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False,
                           "trim_offsets": False, "use_regex": True}
    with open(os.path.join(dst, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tj, f, ensure_ascii=False)
    with open(os.path.join(src, "tokenizer_config.json")) as f:
        cfg = f.read()
    with open(os.path.join(dst, "tokenizer_config.json"), "w") as f:
        f.write(cfg)
    return dst


# -- the BPE tokenizer ------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["gpt2", "qwen2"])
def test_splitter_matches_regex_package(pattern):
    """The hand-written pre-tokenizer equals ``regex.findall`` of the same
    pattern on the tricky texts, every corpus line and 3,000 random strings
    over letters, numbers (CJK numerals are letters, Roman numerals and
    full-width digits numbers), marks, the contractions' letters (U+017F
    folds to s), White_Space and not-White_Space separators, CR/LF."""
    regex = pytest.importorskip("regex")
    pat = {"gpt2": tbpe._GPT2_PATTERN, "qwen2": tbpe._QWEN2_PATTERN}[pattern]
    assert tbpe._GPT2_PATTERN == jbpe._GPT2_PATTERN
    split, rx = tbpe._Splitter(pat).split, regex.compile(pat)
    pool = list("aZsSrReEvVmMlLdDtT'0９Ⅳ三十高 \t\r\n\x0b\x1c\x1f\x85\xa0　 "
                "́é!,。…🌡ſ_-") + ["'s", "'LL", "\r\n", "  "]
    rng = np.random.default_rng(5)
    texts = TRICKY + LINES + ["".join(rng.choice(pool, size=rng.integers(0, 24)))
                              for _ in range(3000)]
    assert [split(t) for t in texts] == [rx.findall(t) for t in texts]


def test_splitter_rejects_unknown_pattern():
    with pytest.raises(ValueError, match="not one this tokenizer knows"):
        tbpe._Splitter(r"\w+|\s+")
    with pytest.raises(ValueError):
        tbpe.BPETokenizer({"model": {"type": "BPE", "vocab": {}, "merges": []},
                           "pre_tokenizer": {"type": "Split", "pattern": {"Regex": r"\S+"}}})


@pytest.mark.parametrize("pattern", ["qwen2", "gpt2"])
def test_bpe_matches_jax(hf_dirs, tmp_path, pattern):
    """Ids, decoded text and left-padded batches equal the JAX tokenizer's
    on the tricky texts and every corpus chunk; ``decode(encode(t)) == t``
    for every chunk; eos/pad come from ``tokenizer_config.json``."""
    d = hf_dirs["qwen"] if pattern == "qwen2" else _gpt2_variant(hf_dirs["qwen"], str(tmp_path))
    ours = tbpe.BPETokenizer.from_pretrained(d, max_len=512)
    theirs = jbpe.BPETokenizer.from_pretrained(d, max_len=512)
    chunks = [c.text for c in _chunks()]
    for t in TRICKY + chunks:
        ids = ours.encode(t)
        assert ids == theirs.encode(t), t
        assert ours.decode(ids) == theirs.decode(ids)
    assert all(ours.decode(ours.encode(t)) == t for t in chunks)
    assert (ours.eos_id, ours.pad_id) == (theirs.eos_id, theirs.pad_id) == (
        ours.vocab["<|im_end|>"], ours.vocab["<|endoftext|>"])
    for a, b in zip(ours.batch_encode(TRICKY[:6]), theirs.batch_encode(TRICKY[:6])):
        np.testing.assert_array_equal(a, b)
    assert ours.encode(chunks[0], eos=True)[-1] == ours.eos_id


def test_bpe_matches_tokenizers_library(hf_dirs):
    """The file written by hand is the HF format: the ``tokenizers``
    library reads it and gives the port's ids (Qwen2 pattern)."""
    tokenizers = pytest.importorskip("tokenizers")
    lib = tokenizers.Tokenizer.from_file(os.path.join(hf_dirs["qwen"], "tokenizer.json"))
    ours = tbpe.BPETokenizer.from_pretrained(hf_dirs["qwen"], max_len=4096)
    for t in TRICKY + [c.text for c in _chunks()]:
        assert ours.encode(t) == lib.encode(t).ids, t


def test_token_byte_table_matches_jax(hf_dirs):
    """``token_byte_table`` (the constrained decoder's projection) and
    ``byte_token_ids`` equal JAX's, at the model's vocabulary (5 padding
    rows past the tokenizer's ids, never allowed: length 0) and capped by a
    grammar's longest path; specials get length 0 too."""
    with open(os.path.join(hf_dirs["qwen"], "config.json")) as f:
        V = json.load(f)["vocab_size"]
    ours = tbpe.BPETokenizer.from_pretrained(hf_dirs["qwen"])
    theirs = jbpe.BPETokenizer.from_pretrained(hf_dirs["qwen"])
    np.testing.assert_array_equal(ours.byte_token_ids(), theirs.byte_token_ids())
    for cap in (None, 3):
        tb, tl = ours.token_byte_table(vocab_size=V, max_bytes=cap)
        jb, jl = theirs.token_byte_table(vocab_size=V, max_bytes=cap)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
        assert (tl[V - 5:] == 0).all() and all(tl[i] == 0 for i in ours.specials.values())
    assert tl.max() == 3 and (jl > 0).sum() > 256


def _chunks():
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    return parse_corpus_file(CORPUS)


# -- WordPiece and safetensors ----------------------------------------------------------

def test_wordpiece_matches_jax(hf_dirs):
    """Ids, right-padded batches and decoded text equal JAX's WordPiece on
    the vocabulary chip_smoke.py builds from the corpus's characters."""
    d = hf_dirs["bert"]
    ours, theirs = WordPieceTokenizer.from_pretrained(d), JWordPiece.from_pretrained(d)
    texts = ["高血压患者的饮食建议", "What should I eat?", "BP 120/80 mmHg!",
             "混合 mixed 病例 eating", "unknownword 高血压", "", "Café NAÏVE x́",
             "\x00控制�字符​"] + [c.text for c in _chunks()[:40]]
    for t in texts:
        assert ours.encode(t) == theirs.encode(t), t
        assert ours.decode(ours.encode(t)) == theirs.decode(theirs.encode(t))
    for a, b in zip(ours.batch_encode(texts), theirs.batch_encode(texts)):
        np.testing.assert_array_equal(a, b)
    assert len(ours.vocab) == TINY_BERT["vocab_size"] and ours.unk_id == 100


def test_read_safetensors_bit_equal_to_jax(hf_dirs):
    """Every tensor of a bf16 shard (through torch's bf16, not ml_dtypes)
    and of the f32 BERT file equals JAX's reader's bits."""
    files = [os.path.join(hf_dirs["qwen"], "model-00001-of-00003.safetensors"),
             os.path.join(hf_dirs["bert"], "model.safetensors")]
    for path in files:
        ours, theirs = thf.read_safetensors(path), jhf.read_safetensors(path)
        assert sorted(ours) == sorted(theirs)
        for name, a in ours.items():
            b = theirs[name]
            t = a.load("cpu")
            assert a.shape == b.shape == tuple(t.shape)
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(), b.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), b)
    assert thf.read_safetensors(files[0])["model.embed_tokens.weight"].dtype == torch.bfloat16


# -- Qwen2: weights, logits, generation -------------------------------------------------

@pytest.mark.parametrize("which,pdt", [("qwen", "float32"), ("tied", "float32"),
                                        ("qwen", "bfloat16")])
def test_load_qwen2_matches_jax(hf_dirs, which, pdt):
    """``load_qwen2`` fills the port's decoder leaf for leaf bit-equal to
    JAX's tree (q/k/v concatenated with their biases, [out, in] transposed,
    GQA kv heads, the tied head materialized, shards found by glob), and
    the full causal forward's logits (f32, a left-padded row) lie within
    2e-5 of JAX's ``Decoder.apply`` (f32 sums in another order)."""
    d = hf_dirs[which]
    jcfg, jp = jhf.load_qwen2(d, dtype="float32", param_dtype=pdt, attn_impl="einsum")
    cfg, p = thf.load_qwen2(d, dtype="float32", param_dtype=pdt, attn_impl="einsum",
                            device="cpu")
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.qkv_bias and cfg.kv_heads == 2 and cfg.rope_theta == 1e6
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            yield from (leaves(v, prefix + k + ".") if isinstance(v, dict) else [(prefix + k, v)])

    got = dict(leaves(p))
    assert sorted(got) == sorted(dict(leaves(want)))
    for name, w in leaves(want):
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    if pdt == "float32":
        ids = np.array([[5, 9, 23, 77, 41, 3, 8, 150], [0, 0, 11, 64, 12, 99, 42, 7]], np.int32)
        mask = np.ones_like(ids, np.float32)
        mask[1, :2] = 0
        jl = np.asarray(JDecoder(jcfg).apply(jp, ids, mask))
        tl = Decoder(cfg, p).apply(torch.from_numpy(ids), torch.from_numpy(mask)).detach()
        live = mask.astype(bool)
        np.testing.assert_allclose(tl.numpy()[live], jl[live], rtol=0, atol=2e-5)


def _jax_gen(d, quantize, kv_dtype, dtype="bfloat16"):
    """JAX's ``TPULLMClient.from_hf`` generator with einsum attention
    (``from_hf`` itself loads with the interpreted flash kernel)."""
    gen = jhf.load_qwen2_generator(d, kv_dtype=kv_dtype, dtype=dtype, attn_impl="einsum")
    if quantize:
        gen.quantize_weights(bits=quantize)
    return gen


def _port_gen(d, quantize, kv_dtype, dtype="float32"):
    gen = thf.load_qwen2_generator(d, kv_dtype=kv_dtype, dtype=dtype, device="cpu")
    if quantize:
        gen.quantize_weights(bits=quantize)
    return gen


FROM_HF = [(0, ""), (8, ""), (4, ""), (4, "int8")]
PROMPTS = ["高血压患者平时饮食需要注意什么？", "头痛怎么办"]


@pytest.mark.parametrize("quantize,kv", FROM_HF, ids=["bf16", "int8", "int4", "int4-kv8"])
def test_from_hf_greedy_matches_jax(hf_dirs, quantize, kv):
    """``TorchLLMClient.from_hf`` loads bf16 weights, then quantizes (int8,
    int4) and sets the KV cache dtype, with ChatML prompts. 8 greedy tokens
    of the port are fed to both models (JAX's with the same weights): each
    is JAX's argmax, or scores in JAX's logits within twice the step's
    largest |port - JAX| logit of the maximum (a near tie). The port's float
    matmuls keep JAX's f32 sum (ROADMAP Queue C 7), so bf16 logits differ
    only where an f32 sum taken in another order rounds to the other bf16
    neighbour at an intermediate cast: within 1% (relative L2) for bf16
    weights; int8/int4 prompts of up to 128 rows run the matvec path, which
    the repair does not touch, and stay within 3%. In f32 the replies are
    equal (next test)."""
    d = hf_dirs["qwen"]
    ours = TorchLLMClient.from_hf(d, quantize=quantize, kv_dtype=kv, device="cpu")
    g, jg = ours.generator, _jax_gen(d, quantize, kv)
    assert ours.template == "chatml" and g.cfg.kv_dtype == kv and g.cfg.dtype == "bfloat16"
    assert {0: "tok_embed", 8: "q", 4: "q4"}[quantize] in (
        g.params if quantize == 0 else g.params["lm_head"])
    ids, mask = g.tokenizer.batch_encode([render_chat(PROMPTS[0], template="chatml")])
    jdec = JDecoder(jg.cfg)
    jstep = jax.jit(jdec.decode_step)
    tl, tc = g.model.prefill(torch.from_numpy(ids), torch.from_numpy(mask), 256)
    jl, jc = jax.jit(jdec.prefill, static_argnums=3)(jg.params, ids, mask, 256)
    bound = 0.01 if quantize == 0 else 0.03
    for _ in range(8):
        t, j = tl.float().numpy()[0], np.asarray(jl, np.float32)[0]
        noise = np.abs(t - j).max()
        assert np.linalg.norm(t - j) <= bound * np.linalg.norm(j)
        tok = int(t.argmax())
        assert j[tok] >= j.max() - 2 * noise
        tl = g.model.decode_step(tc, torch.tensor([tok]))
        jl, jc = jstep(jg.params, jc, np.array([tok], np.int32))


@pytest.mark.parametrize("quantize,kv", FROM_HF[1::2], ids=["int8", "int4-kv8"])
def test_from_hf_f32_replies_match_jax(hf_dirs, quantize, kv):
    """With f32 activations (the same loader, quantized the same way) the
    greedy replies through the ChatML client equal JAX's."""
    d = hf_dirs["qwen"]
    ours = TorchLLMClient(_port_gen(d, quantize, kv), template="chatml", max_new_tokens=8)
    theirs = TPULLMClient(_jax_gen(d, quantize, kv, "float32"), template="chatml",
                          max_new_tokens=8)
    assert ours.complete_batch(PROMPTS) == theirs.complete_batch(PROMPTS)


@pytest.mark.parametrize("name", ["risk", "followup"])
def test_from_hf_constrained_greedy_matches_jax(hf_dirs, name):
    """Constrained decoding over the BPE vocabulary: multi-byte tokens walk
    the schema's DFA (``token_byte_table`` at the model's padded vocab).
    With int4 weights, an int8 KV cache and f32 activations the greedy JSON
    equals JAX's; ``from_hf``'s bf16 client's reply is accepted by the
    schema too."""
    d = hf_dirs["qwen"]
    schema = {"risk": (tconstrain.RISK_SCHEMA, jconstrain.RISK_SCHEMA),
              "followup": (tconstrain.FOLLOWUP_SCHEMA, jconstrain.FOLLOWUP_SCHEMA)}[name]
    ours = TorchLLMClient(_port_gen(d, 4, "int8"), template="chatml")
    theirs = TPULLMClient(_jax_gen(d, 4, "int8", "float32"), template="chatml")
    prompt = "你是一名分诊护士。用户回答：最近两周经常头晕，偶尔胸闷。JSON："
    got = ours.complete(prompt, schema=schema[0])
    assert got == theirs.complete(prompt, schema=schema[1])
    c = ours._constraints[json.dumps(schema[0], sort_keys=True)]
    assert c.accepts(got) and json.loads(got) is not None
    assert int(c.tok_len.max()) > 1          # multi-byte tokens are allowed
    bf16 = TorchLLMClient.from_hf(d, quantize=4, kv_dtype="int8", device="cpu")
    assert c.accepts(bf16.complete(prompt, schema=schema[0]))


# -- BERT ---------------------------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_bert_embedder_matches_jax(hf_dirs, pooling):
    """``load_bert`` gives JAX's tree bit for bit; in f32 the hidden states
    and pooled embeddings lie within 1e-5 of JAX's; ``BertTextEmbedder``
    (bf16 activations, f32 sums) within 2e-2 of JAX's on unit rows: the
    same graph, but a sum rounded to bf16 in another order can land one
    bf16 ulp (2^-8 relative) away and carry through the layers."""
    from mediquery_rag_tpu.models import BertEncoder as JBert
    from mediquery_rag_tpu_torch.models import BertEncoder

    d = hf_dirs["bert"]
    jcfg, jp = jhf.load_bert(d, pooling=pooling, dtype="float32")
    cfg, p = thf.load_bert(d, pooling=pooling, dtype="float32", device="cpu")
    assert cfg.__dict__ == jcfg.__dict__
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for k in ("tok_embed", "pos_embed", "emb_ln_bias"):
        assert torch.equal(p[k], want[k])
    assert all(torch.equal(p["blocks"][k], want["blocks"][k]) for k in want["blocks"])
    texts = ["高血压患者的饮食建议", "糖尿病 BMI 23.9", "头痛", "儿童咳嗽用药注意什么"]
    tok = WordPieceTokenizer.from_pretrained(d)
    ids, mask = tok.batch_encode(texts)
    enc, jenc = BertEncoder(cfg, p), JBert(jcfg)
    live = mask.astype(bool)
    np.testing.assert_allclose(enc.hidden_states(ids, mask).numpy()[live],
                               np.asarray(jenc.hidden_states(jp, ids, mask))[live],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(enc(ids, mask).numpy(), np.asarray(jenc.apply(jp, ids, mask)),
                               rtol=0, atol=1e-5)
    ours = thf.BertTextEmbedder.from_hf(d, pooling=pooling, device="cpu")
    theirs = jhf.BertTextEmbedder.from_hf(d, pooling=pooling)
    got, ref = ours.embed(texts[:3]), theirs.embed(texts[:3])
    assert got.shape == (3, TINY_BERT["hidden_size"]) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    assert ours.embed([]).shape == (0, TINY_BERT["hidden_size"]) and ours.dim == 48


# -- wiring -------------------------------------------------------------------------------

def test_app_context_serves_hf_models(hf_dirs, tmp_path, monkeypatch):
    """``AppContext.build(device="cpu")`` with ``MEDIQUERY_HF_EMBEDDER`` and
    ``MEDIQUERY_HF_LLM`` (int4 weights, int8 KV) takes the BERT embedder
    (the store is built on its 48-d rows, graded by similarity at JAX's 0.3)
    and serves the HF model through ``TorchLLMClient``; without the
    quantization flag the JAX default, int8, applies; ``MEDIQUERY_HYBRID=1``
    without an encoder checkpoint takes the IDF lexical embedder. Nothing
    raises ``NotImplementedError``."""
    import shutil

    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.cli.interface import _stream_rag
    (tmp_path / "data").mkdir()
    shutil.copy(CORPUS, tmp_path / "data" / "medical_data.txt")
    monkeypatch.setenv("MEDIQUERY_HF_EMBEDDER", hf_dirs["bert"])
    monkeypatch.setenv("MEDIQUERY_HF_LLM", hf_dirs["qwen"])
    monkeypatch.setenv("MEDIQUERY_HF_LLM_QUANT", "4")
    monkeypatch.setenv("MEDIQUERY_HF_LLM_KV", "int8")
    ctx = AppContext.build(str(tmp_path), device="cpu")
    assert isinstance(ctx.embedder, thf.BertTextEmbedder)
    assert ctx.store.live_count == 160 and ctx.store.index.corpus.shape[1] == 48
    assert isinstance(ctx.llm, TorchLLMClient) and ctx.llm.template == "chatml"
    gen = ctx.llm.generator
    assert "q4" in gen.params["lm_head"] and gen.cfg.kv_dtype == "int8"
    assert ctx.store.similarity_search("高血压", k=3)[0].text
    ctx.llm.max_new_tokens = 8
    assert "以上内容仅供参考" in _stream_rag(ctx, "高血压患者平时饮食需要注意什么？",
                                         "anonymous", "t1")
    monkeypatch.delenv("MEDIQUERY_HF_LLM_QUANT")
    ctx2 = AppContext.build(str(tmp_path), device="cpu")
    assert "q" in ctx2.llm.generator.params["lm_head"]
    monkeypatch.setenv("MEDIQUERY_HYBRID", "1")
    monkeypatch.delenv("MEDIQUERY_HF_EMBEDDER")
    # no trained encoder under checkpoints/embedder: as in the JAX package,
    # the hybrid flag falls back to the IDF lexical embedder
    from mediquery_rag_tpu_torch.models import IDFHashingEmbedder
    ctx3 = AppContext.build(str(tmp_path), device="cpu")
    assert type(ctx3.embedder) is IDFHashingEmbedder


def test_hf_draft_and_distill_target_load(hf_dirs, tmp_path):
    """``serve --draft`` takes an HF directory (``load_draft`` through
    ``load_qwen2_generator``, quantized as asked) and the distill CLI an HF
    ``--target``: the draft it saves loads and shares the target's vocab."""
    from mediquery_rag_tpu_torch.models import distill
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.serve.server import check_draft_dir, load_draft

    d = hf_dirs["qwen"]
    assert check_draft_dir(d) is True
    draft = load_draft(d, quantize=8, device="cpu")
    assert isinstance(draft.tokenizer, tbpe.BPETokenizer) and "q" in draft.params["lm_head"]
    pfile = tmp_path / "p.txt"
    pfile.write_text("高血压的饮食\n头痛怎么办\n", encoding="utf-8")
    out = tmp_path / "draft"
    distill.main(["--target", d, "--out", str(out), "--preset", "tiny", "--prompts-file",
                  str(pfile), "--max-new", "8", "--epochs", "1", "--device", "cpu"])
    saved = Generator.from_checkpoint(str(out), device="cpu")
    assert saved.cfg.vocab_size == draft.cfg.vocab_size and saved.cfg.hidden == 64
    assert check_draft_dir(str(out)) is False


def test_chip_smoke_writers_write_hf_format(hf_dirs):
    """transformers reads the hand-written checkpoints as its own: its
    Qwen2 logits (f32) lie within 2e-4 of the port's imported decoder's,
    and its BertModel's last hidden states within 2e-4 of the port's
    encoder in f32 (the tolerance of the JAX package's import tests)."""
    transformers = pytest.importorskip("transformers")
    cfg, p = thf.load_qwen2(hf_dirs["qwen"], dtype="float32", param_dtype="float32",
                            attn_impl="einsum", device="cpu")
    hf = transformers.Qwen2ForCausalLM.from_pretrained(hf_dirs["qwen"],
                                                       torch_dtype=torch.float32).eval()
    ids = torch.tensor([[5, 9, 23, 77, 41, 3, 8, 150]])
    with torch.no_grad():
        want = hf(input_ids=ids).logits
    got = Decoder(cfg, p).apply(ids, torch.ones_like(ids, dtype=torch.float32)).detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    from mediquery_rag_tpu_torch.models import BertEncoder
    bcfg, bp = thf.load_bert(hf_dirs["bert"], dtype="float32", device="cpu")
    bert = transformers.BertModel.from_pretrained(hf_dirs["bert"]).eval()
    ids, mask = WordPieceTokenizer.from_pretrained(hf_dirs["bert"]).batch_encode(
        ["高血压患者的饮食建议", "头痛"])
    with torch.no_grad():
        want = bert(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    live = mask.astype(bool)
    np.testing.assert_allclose(BertEncoder(bcfg, bp).hidden_states(ids, mask).numpy()[live],
                               want.numpy()[live], rtol=2e-4, atol=2e-4)
