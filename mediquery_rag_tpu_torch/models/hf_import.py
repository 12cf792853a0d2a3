"""Import HuggingFace checkpoints (port of ``mediquery_rag_tpu/models/hf_import.py``).

A qwen2-class causal LM (the reference answers with qwen2.5:7b) is read
into the port's ``Decoder`` and a BERT-family encoder (the reference embeds
with a Chinese BERT derivative) into ``BertEncoder``, with the JAX
package's layout mapping (HF stores Linear weights ``[out, in]``; the
models right-multiply ``x @ W`` with ``[in, out]``):

    model.embed_tokens.weight            -> tok_embed            [V, D]
    layers.i.input_layernorm.weight      -> blocks.rms1[i]       [D]
    layers.i.self_attn.{q,k,v}_proj      -> blocks.qkv[i]        [D, (H+2KV)*dh]
    layers.i.self_attn.{q,k,v}_proj.bias -> blocks.qkv_b[i]      [(H+2KV)*dh]
    layers.i.self_attn.o_proj            -> blocks.attn_out[i]   [D, D]
    layers.i.post_attention_layernorm    -> blocks.rms2[i]       [D]
    layers.i.mlp.{gate,up,down}_proj     -> blocks.w_{gate,up,down}[i]
    model.norm.weight                    -> rms_f                [D]
    lm_head.weight (or tied embed)       -> lm_head              [D, V]

The safetensors container (an 8-byte little-endian header length, a JSON
header, the raw tensor buffer) is read by an in-repo reader: zero-copy
``np.memmap`` views, bf16 as an int16 view reinterpreted by torch (the JAX
package views it through ``ml_dtypes``). Each tensor is materialized once
on the host (the memmap is read-only, which ``torch.from_numpy`` warns
about), moved to ``device``, converted there to the parameter dtype and
copied into its slot of the stacked ``[L, ...]`` tensor, which is allocated
on ``device`` up front: a 7B checkpoint never sits in host RAM, one tensor
at a time does.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import BertEmbedderConfig, DecoderConfig
from mediquery_rag_tpu_torch.obs import tracing

# safetensors dtype -> (numpy view of the raw bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class StoredTensor:
    """One tensor of a safetensors file: a zero-copy view of its bytes,
    read when ``load`` is called."""

    def __init__(self, raw: np.ndarray, dtype: torch.dtype):
        self.raw = raw
        self.dtype = dtype

    @property
    def shape(self) -> tuple:
        return tuple(self.raw.shape)

    def load(self, device: str | torch.device = "cpu",
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """The tensor on ``device`` at ``dtype`` (default: the file's):
        one host copy of the bytes, converted on ``device``."""
        t = torch.from_numpy(np.array(self.raw))
        if self.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device).to(dtype or self.dtype)


def read_safetensors(path: str) -> dict[str, StoredTensor]:
    """Minimal safetensors reader: {tensor name: zero-copy view}."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
    base = 8 + header_len
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        view, dt = _DTYPES[info["dtype"]]
        s, e = info["data_offsets"]
        out[name] = StoredTensor(
            buf[base + s: base + e].view(view).reshape(info["shape"]), dt)
    return out


def _load_all_tensors(model_dir: str) -> dict[str, StoredTensor]:
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    tensors: dict[str, StoredTensor] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors


def _stacked(t: dict, L: int, pieces, device, dtype, transpose: bool) -> torch.Tensor:
    """``[L, ...]`` tensor on ``device`` whose layer ``i`` concatenates the
    checkpoint tensors ``pieces(i)`` (each transposed to ``[in, out]`` when
    ``transpose``) along the last axis, filled one tensor at a time."""
    names0 = pieces(0)
    shapes = [t[n].shape[::-1] if transpose else t[n].shape for n in names0]
    width = sum(s[-1] for s in shapes)
    out = torch.empty((L, *shapes[0][:-1], width), dtype=dtype, device=device)
    for i in range(L):
        col = 0
        for name in pieces(i):
            x = t[name].load(device, dtype)
            x = x.T if transpose else x
            out[i, ..., col:col + x.shape[-1]].copy_(x)
            col += x.shape[-1]
    return out


def load_qwen2(model_dir: str, *, max_len: int = 4096, dtype: str = "bfloat16",
               param_dtype: str = "bfloat16", kv_dtype: str = "",
               attn_impl: str = "flash", device: str | torch.device = "cuda"):
    """Read an HF qwen2/qwen2.5 (or any llama-class) checkpoint directory
    onto ``device``. Returns ``(DecoderConfig, params)`` for ``Decoder`` /
    ``Generator``. ``param_dtype`` defaults to bfloat16, as in the JAX
    package: decode is weight-bandwidth bound, and a 7B import takes 15.2
    GB of device memory instead of 30."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    if hf.get("model_type") not in ("qwen2", "llama", "mistral"):
        raise ValueError(
            f"model_type {hf.get('model_type')!r} is not a qwen/llama-class "
            "decoder this importer understands")

    D = hf["hidden_size"]
    L = hf["num_hidden_layers"]
    H = hf["num_attention_heads"]
    KV = hf.get("num_key_value_heads", H)
    Fd = hf["intermediate_size"]
    dh = hf.get("head_dim") or D // H
    if dh != D // H:
        raise ValueError(f"head_dim {dh} != hidden/heads {D // H}: "
                         "unsupported by the fused-qkv decoder layout")

    t = _load_all_tensors(model_dir)
    pdt = _TORCH[param_dtype]
    dev = torch.device(device)
    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in t

    def layer(*names):
        return lambda i: [f"model.layers.{i}.{n}" for n in names]

    def W(*names):
        return _stacked(t, L, layer(*names), dev, pdt, transpose=True)

    def vec(*names):
        return _stacked(t, L, layer(*names), dev, pdt, transpose=False)

    blocks = {
        "rms1": vec("input_layernorm.weight"),
        "qkv": W("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                 "self_attn.v_proj.weight"),
        "attn_out": W("self_attn.o_proj.weight"),
        "rms2": vec("post_attention_layernorm.weight"),
        "w_gate": W("mlp.gate_proj.weight"),
        "w_up": W("mlp.up_proj.weight"),
        "w_down": W("mlp.down_proj.weight"),
    }
    if qkv_bias:
        blocks["qkv_b"] = vec("self_attn.q_proj.bias", "self_attn.k_proj.bias",
                              "self_attn.v_proj.bias")

    embed = t["model.embed_tokens.weight"].load(dev, pdt)
    V = embed.shape[0]
    if hf.get("tie_word_embeddings") or "lm_head.weight" not in t:
        lm_head = embed.T.contiguous()   # materialized (the decoder keeps them apart)
    else:
        lm_head = t["lm_head.weight"].load(dev, pdt).T.contiguous()

    params = {"tok_embed": embed, "blocks": blocks,
              "rms_f": t["model.norm.weight"].load(dev, pdt), "lm_head": lm_head}
    cfg = DecoderConfig(
        vocab_size=V, hidden=D, layers=L, heads=H, kv_heads=KV, mlp_dim=Fd,
        max_len=min(max_len, hf.get("max_position_embeddings", max_len)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        qkv_bias=qkv_bias,
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
        dtype=dtype, param_dtype=param_dtype, kv_dtype=kv_dtype,
        # the flash prefill (B6) by default, as the JAX importer: real
        # checkpoints serve long admissions
        attn_impl=attn_impl,
    )
    return cfg, params


def load_bert(model_dir: str, *, max_len: int | None = None, pooling: str = "mean",
              dtype: str = "bfloat16", device: str | torch.device = "cuda"):
    """Read an HF BERT-family checkpoint onto ``device`` (f32 parameters, as
    in the JAX package). Returns ``(BertEmbedderConfig, params)`` for
    ``models.bert_encoder.BertEncoder``.

    Layout mapping (HF Linear ``[out, in]`` -> ``[in, out]``):

        embeddings.{word,position,token_type}_embeddings -> *_embed
        embeddings.LayerNorm                 -> emb_ln_{scale,bias}
        encoder.layer.i.attention.self.{query,key,value} -> blocks.qkv[i]
        encoder.layer.i.attention.output.dense           -> blocks.attn_out[i]
        encoder.layer.i.attention.output.LayerNorm       -> blocks.ln1_*[i]
        encoder.layer.i.intermediate.dense               -> blocks.wi/bi[i]
        encoder.layer.i.output.dense                     -> blocks.wo/bo[i]
        encoder.layer.i.output.LayerNorm                 -> blocks.ln2_*[i]
    """
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    t = _load_all_tensors(model_dir)
    # BertModel saves bare names; BertFor* tasks prefix with "bert."
    prefix = "bert." if any(k.startswith("bert.") for k in t) else ""
    L = hf["num_hidden_layers"]
    dev = torch.device(device)

    def layer(*names):
        return lambda i: [f"{prefix}encoder.layer.{i}.{n}" for n in names]

    def stack(transpose, *names):
        return _stacked(t, L, layer(*names), dev, torch.float32, transpose)

    def vec(name):
        return t[prefix + name].load(dev, torch.float32)

    att = "attention.self."
    blocks = {
        "qkv": stack(True, att + "query.weight", att + "key.weight", att + "value.weight"),
        "qkv_b": stack(False, att + "query.bias", att + "key.bias", att + "value.bias"),
        "attn_out": stack(True, "attention.output.dense.weight"),
        "attn_out_b": stack(False, "attention.output.dense.bias"),
        "ln1_scale": stack(False, "attention.output.LayerNorm.weight"),
        "ln1_bias": stack(False, "attention.output.LayerNorm.bias"),
        "wi": stack(True, "intermediate.dense.weight"),
        "bi": stack(False, "intermediate.dense.bias"),
        "wo": stack(True, "output.dense.weight"),
        "bo": stack(False, "output.dense.bias"),
        "ln2_scale": stack(False, "output.LayerNorm.weight"),
        "ln2_bias": stack(False, "output.LayerNorm.bias"),
    }
    params = {
        "tok_embed": vec("embeddings.word_embeddings.weight"),
        "pos_embed": vec("embeddings.position_embeddings.weight"),
        "type_embed": vec("embeddings.token_type_embeddings.weight"),
        "emb_ln_scale": vec("embeddings.LayerNorm.weight"),
        "emb_ln_bias": vec("embeddings.LayerNorm.bias"),
        "blocks": blocks,
    }
    cfg = BertEmbedderConfig(
        vocab_size=hf["vocab_size"], hidden=hf["hidden_size"],
        layers=L, heads=hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        max_len=min(max_len or hf["max_position_embeddings"],
                    hf["max_position_embeddings"]),
        type_vocab=hf.get("type_vocab_size", 2),
        ln_eps=float(hf.get("layer_norm_eps", 1e-12)),
        pooling=pooling, dtype=dtype,
    )
    return cfg, params


class BertTextEmbedder:
    """Imported-BERT embedder: tokenizer + encoder behind one ``embed()``
    call returning [n, D] f32 unit rows on the host, a drop-in for the
    ingest pipeline and the engine. The JAX class pads each batch to a
    power of two for its jit cache; padding rows change no real row's
    result and the port has no jit cache, so batches run at their size."""

    def __init__(self, cfg: BertEmbedderConfig, params: dict, tokenizer):
        from mediquery_rag_tpu_torch.models.bert_encoder import BertEncoder

        self.cfg = cfg
        self.model = BertEncoder(cfg, params)
        self.tokenizer = tokenizer

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def embed(self, texts) -> np.ndarray:
        """Unit rows of ``texts``; the tokenizer and the encoder (through its
        host copy) are the ``embed.tokenize`` and ``embed.forward`` spans."""
        if not len(texts):
            return np.zeros((0, self.cfg.hidden), np.float32)
        with tracing.span("embed.tokenize", n=len(texts)):
            ids, mask = self.tokenizer.batch_encode(list(texts))
        with tracing.span("embed.forward", n=len(texts)):
            return self.model(ids, mask).cpu().numpy()

    def __call__(self, texts) -> np.ndarray:
        return self.embed(texts)

    @classmethod
    def from_hf(cls, model_dir: str, *, pooling: str = "mean", max_len: int | None = None,
                device: str | torch.device = "cuda") -> "BertTextEmbedder":
        from mediquery_rag_tpu_torch.models.wordpiece_tokenizer import WordPieceTokenizer

        cfg, params = load_bert(model_dir, max_len=max_len, pooling=pooling, device=device)
        tok = WordPieceTokenizer.from_pretrained(model_dir, max_len=cfg.max_len)
        return cls(cfg, params, tok)


def load_qwen2_generator(model_dir: str, *, max_len: int = 4096,
                         dtype: str = "bfloat16", param_dtype: str = "bfloat16",
                         kv_dtype: str = "", attn_impl: str = "flash",
                         device: str | torch.device = "cuda"):
    """Checkpoint dir -> ``Generator`` on ``device`` (weights + the
    checkpoint's own BPE tokenizer): the in-process replacement for the
    reference's ``ChatOllama(qwen2.5:7b)``."""
    from mediquery_rag_tpu_torch.models.bpe_tokenizer import BPETokenizer
    from mediquery_rag_tpu_torch.models.generate import Generator

    cfg, params = load_qwen2(model_dir, max_len=max_len, dtype=dtype,
                             param_dtype=param_dtype, kv_dtype=kv_dtype,
                             attn_impl=attn_impl, device=device)
    tok = BPETokenizer.from_pretrained(model_dir, max_len=cfg.max_len)
    return Generator(cfg, params=params, tokenizer=tok, device=device)
