"""The frozen arithmetic, pinned to PERF.md's kernel table (bound ms on an
H100 at 3.35 TB/s) and to the MFU formula of the program's obs/metrics.py."""

from __future__ import annotations

import pytest

from perfbench.harness import roofline

QWEN7B = dict(hidden=3584, layers=28, mlp_dim=18944, vocab=152064, heads=28, kv_heads=4)


def test_b7_w_gate_b4():
    # w_gate 18,944 x 3,584 int4, 4 rows: 0.0103 ms (bytes)
    ms, by = roofline.bound_ms(roofline.b7_bytes(4, 18944, 3584),
                               roofline.b7_ops(4, 18944, 3584), "int8")
    assert by == "bytes" and round(ms, 4) == 0.0103


def test_b5_int8_half_live_b4():
    # int8 cache C = 8,192, 4 lanes live from column 37 + 97 lane to 4,133, the
    # fresh-column fold, 28 q / 4 KV heads of 128: 0.0050 ms (bytes)
    cols = sum(4133 - (37 + 97 * lane) for lane in range(4))
    kw = dict(lanes=4, heads=28, dh=128, live_cols=cols)
    ms, by = roofline.bound_ms(
        roofline.b5_int8_bytes(kv_heads=4, cache_cols=8192, fresh=True, **kw),
        roofline.b5_ops(**kw), "bf16")
    assert by == "bytes" and round(ms, 4) == 0.0050


def test_b9b_1m_int8_b64():
    # 1M x 768 int8 rows in 1,024 lists of 1,024 live rows (cap 2,048), 64
    # queries x 32 probes, k = 10, reaching 883 distinct lists: 0.2105 ms
    # (bytes). PR 14's run did not record its distinct count; 883 is the one
    # that gives the table's figure at even fill (64 random probe sets of 32
    # reach 890 on average).
    distinct = 883
    nbytes = roofline.ivf_int8_bytes(live_rows=distinct * 1024, distinct=distinct, cap=2048,
                                     queries=64, d=768, nprobe=32, k=10)
    ms, by = roofline.bound_ms(nbytes, roofline.ivf_int8_ops(probed_rows=64 * 32 * 1024, d=768),
                               "int8")
    assert by == "bytes" and round(ms, 4) == 0.2105


def test_lm_matmul_flops():
    # per token at S = 2,048: 28 layers of (qkv 2 D (28 + 8) 128, attn_out
    # 2 D^2, SwiGLU 6 D F, attention 4 * 28 * 128 * 1,024) + the head 2 D V
    d, f = 3584, 18944
    per_layer = 2 * d * 36 * 128 + 2 * d * d + 6 * d * f + 4 * 28 * 128 * 1024
    assert roofline.lm_matmul_flops(seq_len=2048, **QWEN7B) == 28 * per_layer + 2 * d * 152064
    assert roofline.mfu(1e9, 989e3) == pytest.approx(1.0)


def test_request_flops():
    p, o = roofline.request_flops(QWEN7B, 1000, 3)
    dense = roofline.lm_matmul_flops(vocab=0, seq_len=0, **{k: v for k, v in QWEN7B.items()
                                                             if k != "vocab"})
    attn = 4 * 28 * 128
    assert p == pytest.approx(1000 * (dense + attn * 28 * 500) + 2 * 3584 * 152064)
    assert o == pytest.approx(3 * (dense + 2 * 3584 * 152064) + attn * 28 * (1001 + 1002 + 1003))


def test_bert_flops():
    s, d, f = 32, 768, 3072
    assert roofline.bert_flops(hidden=d, layers=12, mlp_dim=f, seq_len=s) == 12 * (
        2 * s * d * 3 * d + 2 * s * d * d + 4 * s * d * f + 4 * s * s * d)
