"""The yardstick's frozen arithmetic: the H100's peaks, a decoder's matmul
FLOPs and the bytes each kernel launch needs.

Copies kept with the benchmark so that a change to the program cannot move
the numbers it is measured by: ``lm_matmul_flops`` and ``mfu`` are
mediquery_rag_tpu_torch/obs/metrics.py's; the byte counts are the bound
rules of PERF.md's kernel table as chip_smoke.py applies them (B7
``matvec_int4``, B5 ``flash_decode_int8`` over the live columns, the int8
IVF scans B8b/B9b over each distinct probed bucket's live rows and scales,
read once)."""

from __future__ import annotations

HBM_BPS = 3.35e12          # NVIDIA H100 SXM data sheet: HBM3 bytes/s
# dense tensor-core rates at 700 W, and f32 on the CUDA cores
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def lm_matmul_flops(*, hidden: int, layers: int, mlp_dim: int, vocab: int, heads: int,
                    kv_heads: int | None, seq_len: float, causal: bool = True,
                    swiglu: bool = True) -> float:
    """Per-token matmul FLOPs of one LM forward pass: 2 m n k for qkv
    (GQA-sized), attn_out, the SwiGLU projections and lm_head, plus
    attention's QK^T and PV at the average causal visible length S/2."""
    kvh = kv_heads or heads
    dh = hidden // heads
    per_layer = (2 * hidden * (heads * dh + 2 * kvh * dh) + 2 * hidden * hidden
                 + (3 if swiglu else 2) * 2 * hidden * mlp_dim)
    vis = seq_len / 2 if causal else seq_len
    attn = 2 * 2 * heads * dh * vis
    return layers * (per_layer + attn) + 2 * hidden * vocab


def mfu(flops_per_token: float, tokens_per_s: float, peak: float = PEAK["bf16"]) -> float:
    """Model-FLOPs utilization in [0, 1]."""
    return flops_per_token * tokens_per_s / peak


def request_flops(shape: dict, prompt: int, out: int) -> tuple[float, float]:
    """(prompt, output) matmul FLOPs of one served request at its own
    lengths: the prompt's tokens at causal visibility with one lm_head row
    (the last token's), and output token i (0-based) attending to
    ``prompt + i + 1`` keys with its own lm_head row."""
    kw = dict(hidden=shape["hidden"], layers=shape["layers"], mlp_dim=shape["mlp_dim"],
              heads=shape["heads"], kv_heads=shape["kv_heads"])
    p = prompt * lm_matmul_flops(vocab=0, seq_len=prompt, **kw)
    p += 2 * shape["hidden"] * shape["vocab"]
    o = sum(lm_matmul_flops(vocab=shape["vocab"], seq_len=2 * (prompt + i + 1), **kw)
            for i in range(out))
    return p, o


def bert_flops(*, hidden: int, layers: int, mlp_dim: int, seq_len: int) -> float:
    """Matmul FLOPs of one post-LN BERT encoder pass over ``seq_len``
    tokens: qkv, attn_out, the two MLP products and attention's QK^T and PV
    over every (query, key) pair."""
    s, d = seq_len, hidden
    per_layer = 2 * s * d * 3 * d + 2 * s * d * d + 2 * 2 * s * d * mlp_dim + 2 * 2 * s * s * d
    return layers * per_layer


def b7_bytes(rows: int, f: int, d: int) -> float:
    """B7 ``matvec_int4``: packed weights (F/2 x D) and their F scales read
    once, int8 x (rows x D) and its corrections, f32 output rows x F."""
    return f // 2 * d + f * 4 + rows * d + rows * 4 + rows * f * 4


def b7_ops(rows: int, f: int, d: int) -> float:
    return 2 * rows * f * d


def b5_int8_bytes(*, lanes: int, heads: int, kv_heads: int, cache_cols: int, dh: int,
                  live_cols: int, fresh: bool) -> float:
    """B5 ``flash_decode_int8``: K and V codes with their scales over the
    live columns of every lane (``live_cols`` summed over lanes), the key
    mask of every column, the bf16 query in and context out, and with the
    fresh-column fold the fresh K/V and the gates."""
    n = (2 * kv_heads * live_cols * (dh + 4) + lanes * cache_cols * 4
         + 4 * lanes * heads * dh)
    if fresh:
        n += 4 * lanes * kv_heads * dh + lanes * 4
    return n


def b5_ops(*, lanes: int, heads: int, dh: int, live_cols: int) -> float:
    return 4 * heads * dh * (live_cols + lanes)


def ivf_int8_bytes(*, live_rows: int, distinct: int, cap: int, queries: int, d: int,
                   nprobe: int, k: int) -> float:
    """B8b/B9b: each distinct probed bucket's live int8 rows and their
    scales once, its ``cap`` slot ids, the int8 queries, the probe lists
    and the (score, id) output."""
    return (live_rows * d + live_rows * 4 + distinct * cap * 4 + queries * d
            + queries * nprobe * 4 + queries * k * 8)


def ivf_int8_ops(*, probed_rows: int, d: int) -> float:
    """Integer multiply-adds of every (query, probed row) pair, 2 a pair."""
    return 2 * d * probed_rows


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """Least time (ms) an H100 needs for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
