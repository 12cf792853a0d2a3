"""Plain Qwen2 forward in float32 (the chat cell's reference).

Qwen2's block as published (RMSNorm, split-half RoPE, grouped-query
attention with q/k/v biases, SwiGLU, untied head), with the storage the
configuration states worked out again from the raw seeded weights:

- every matmul weight as int4 codes, the serving form of the port's
  ``quantize_weights(4)``: a per-input-dim equalizer t = sqrt(max_out |w|)
  scaled to geometric mean 1, per-output-channel absmax/7 codes of w / t,
  clipped to +-7; the product uses codes * scale * t;
- the KV cache as int8: K (after RoPE) and V of each token and KV head
  coded absmax/127 (floor 1e-6), attention reading the dequantized values.

Everything else is f32 with TF32 off. ``precision="control"`` is the same
model one step below what the configuration states: every activation that
enters a product rounded to fp8 e4m3 with a per-row scale (bf16 -> fp8),
and the KV cache coded int4, absmax/7 (int8 -> int4).

It imports nothing of the program: weights come from the benchmark's
seeded maker, token ids from the byte tokenizer's plain rule."""

from __future__ import annotations

import torch

from perfbench.harness import weights

BOS, BYTE0 = 1, 3


def byte_ids(text: str) -> list[int]:
    """The byte tokenizer's ids: BOS, then 3 + each UTF-8 byte."""
    return [BOS] + [BYTE0 + b for b in text.encode("utf-8")]


def int4_weight(w: torch.Tensor) -> torch.Tensor:
    """Raw ``[in, out]`` weight -> the f32 ``[out, in]`` it serves as in int4."""
    wt = w.float().T
    amax = wt.abs().amax(dim=0).clamp(min=1e-12)
    t = amax.sqrt()
    t = t / torch.exp(torch.log(t).mean())
    wn = wt / t[None, :]
    s = wn.abs().amax(dim=1).clamp(min=1e-12) / 7.0
    c = torch.clamp(torch.round(wn / s[:, None]), -7, 7)
    return c * s[:, None] * t[None, :]


def _kv_code(x: torch.Tensor, levels: int) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6) / levels
    return torch.clamp(torch.round(x / s), -levels, levels) * s


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [heads, S, dh], positions 0..S-1, split halves."""
    S, dh = x.shape[1], x.shape[2]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@torch.no_grad()
def logits_at(shape: dict, seed: int, seqs: list[list[int]], positions: list[list[int]],
              device, precision: str = "reference") -> list[torch.Tensor]:
    """f32 logits ``[len(positions[i]), V]`` at ``positions[i]`` of each
    token sequence, each sequence a causal pass from position 0; layer by
    layer, every sequence through a layer before the next is made."""
    if precision not in ("reference", "control"):
        raise ValueError(precision)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(shape, seed, seqs, positions, device, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _logits_at(shape, seed, seqs, positions, device, precision):
    ctl = precision == "control"
    act = _fp8 if ctl else (lambda x: x)
    kv_levels = 7 if ctl else 127
    H, KH, D = shape["heads"], shape["kv_heads"], shape["hidden"]
    dh, g = D // H, H // KH
    eps, theta = shape["rms_eps"], shape["rope_theta"]

    def leaf(name, layer=None):
        return weights.qwen2_leaf(shape, seed, name, layer, device)

    emb = leaf("tok_embed")
    xs = [emb[torch.tensor(s, device=device)].float() for s in seqs]
    del emb
    for li in range(shape["layers"]):
        w = {n: int4_weight(leaf(n, li)) for n in ("qkv", "attn_out", "w_gate", "w_up", "w_down")}
        b = leaf("qkv_b", li).float()
        r1, r2 = leaf("rms1", li).float(), leaf("rms2", li).float()
        for i, x in enumerate(xs):
            S = x.shape[0]
            qkv = act(_rms(x, r1, eps)) @ w["qkv"].T + b
            q = qkv[:, :H * dh].reshape(S, H, dh).transpose(0, 1)
            k = qkv[:, H * dh:(H + KH) * dh].reshape(S, KH, dh).transpose(0, 1)
            v = qkv[:, (H + KH) * dh:].reshape(S, KH, dh).transpose(0, 1)
            q, k = _rope(q, theta), _rope(k, theta)
            k, v = _kv_code(k, kv_levels), _kv_code(v, kv_levels)
            k = k.repeat_interleave(g, dim=0)
            v = v.repeat_interleave(g, dim=0)
            ctx = torch.empty((H, S, dh), device=device)
            causal = torch.ones((S, S), dtype=torch.bool, device=device).tril()
            for h0 in range(0, H, 4):          # a few heads at a time: [4, S, S] scores
                sc = (q[h0:h0 + 4] @ k[h0:h0 + 4].transpose(1, 2)) * dh ** -0.5
                sc = sc.masked_fill(~causal, float("-inf"))
                ctx[h0:h0 + 4] = torch.softmax(sc, dim=-1) @ v[h0:h0 + 4]
            ctx = ctx.transpose(0, 1).reshape(S, D)
            x = x + act(ctx) @ w["attn_out"].T
            h = act(_rms(x, r2, eps))
            ff = torch.nn.functional.silu(h @ w["w_gate"].T) * (h @ w["w_up"].T)
            xs[i] = x + act(ff) @ w["w_down"].T
        del w
    head = int4_weight(leaf("lm_head"))
    rf = leaf("rms_f").float()
    out = []
    for x, pos in zip(xs, positions):
        hx = act(_rms(x[torch.tensor(pos, device=device)], rf, eps))
        out.append(hx @ head.T)
    return out
