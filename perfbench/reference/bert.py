"""Plain post-LN BERT sentence encoder in float32, with its WordPiece
tokenizer (the search cell's reference for query embeddings).

BERT as published: token + position + token-type embeddings and a
LayerNorm, post-LN blocks with biases everywhere and exact-erf GELU, then
the mask-weighted mean of the last layer, L2-normalized
(dmeta-embedding-zh's pooling). The tokenizer is BERT's basic tokenizer
(CJK characters apart, lower case, accents stripped, punctuation split)
and greedy longest-match WordPiece with ``##`` continuations.
``precision="control"`` rounds every activation that enters a weight
product to fp8 e4m3 with a per-row scale (the configuration's bf16, one
step down). Imports nothing of the program."""

from __future__ import annotations

import math
import unicodedata

import torch


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def tokenize(text: str, vocab: dict, max_len: int) -> list[int]:
    """[CLS] + WordPiece ids + [SEP], cut to ``max_len``."""
    spaced = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        spaced.append(f" {ch} " if _is_cjk(cp) else (" " if ch.isspace() else ch))
    ids = [vocab["[CLS]"]]
    for word in "".join(spaced).split():
        word = "".join(c for c in unicodedata.normalize("NFD", word.lower())
                       if unicodedata.category(c) != "Mn")
        pieces, cur = [], []
        for ch in word:
            if _is_punct(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        for p in pieces:
            ids.extend(_wordpiece(p, vocab))
    return ids[: max_len - 1] + [vocab["[SEP]"]]


def _wordpiece(word: str, vocab: dict) -> list[int]:
    if len(word) > 100:
        return [vocab["[UNK]"]]
    out, start = [], 0
    while start < len(word):
        end, hit = len(word), None
        while start < end:
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in vocab:
                hit = vocab[sub]
                break
            end -= 1
        if hit is None:
            return [vocab["[UNK]"]]
        out.append(hit)
        start = end
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


@torch.no_grad()
def embed(params: dict, shape: dict, token_ids: list[list[int]], device,
          precision: str = "reference", batch: int = 256) -> torch.Tensor:
    """Unit sentence embeddings ``[n, D]`` f32; sequences in batches,
    right-padded, the padding masked out of attention and pooling."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.cat([_embed(params, shape, token_ids[i:i + batch], device, precision)
                          for i in range(0, len(token_ids), batch)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _embed(params, shape, token_ids, device, precision):
    act = _fp8 if precision == "control" else (lambda x: x)
    heads, eps = shape["heads"], shape["ln_eps"]
    blocks = params["blocks"]
    B, S = len(token_ids), max(len(t) for t in token_ids)
    ids = torch.zeros((B, S), dtype=torch.long)
    mask = torch.zeros((B, S))
    for r, t in enumerate(token_ids):
        ids[r, :len(t)] = torch.tensor(t)
        mask[r, :len(t)] = 1.0
    ids, mask = ids.to(device), mask.to(device)
    x = params["tok_embed"][ids] + params["pos_embed"][:S][None] + params["type_embed"][0]
    x = _ln(x, params["emb_ln_scale"], params["emb_ln_bias"], eps)
    D = x.shape[-1]
    dh = D // heads
    bias = (mask[:, None, None, :] - 1.0) * 1e9
    for li in range(shape["layers"]):
        qkv = act(x) @ blocks["qkv"][li] + blocks["qkv_b"][li]
        q, k, v = (t.reshape(B, S, heads, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        w = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(dh) + bias, dim=-1)
        ctx = (w @ v).transpose(1, 2).reshape(B, S, D)
        x = _ln(x + act(ctx) @ blocks["attn_out"][li] + blocks["attn_out_b"][li],
                blocks["ln1_scale"][li], blocks["ln1_bias"][li], eps)
        ff = torch.nn.functional.gelu(act(x) @ blocks["wi"][li] + blocks["bi"][li])
        x = _ln(x + act(ff) @ blocks["wo"][li] + blocks["bo"][li],
                blocks["ln2_scale"][li], blocks["ln2_bias"][li], eps)
    m = mask[:, :, None]
    pooled = (x * m).sum(1) / m.sum(1)
    return pooled / pooled.norm(dim=1, keepdim=True).clamp(min=1e-12)
