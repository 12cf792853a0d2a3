"""Flash attention forward for prefill and decode (port of ``mediquery_rag_tpu/ops/attention.py``).

Every entry point keeps the JAX layout (q ``[B, H, S, dh]``, k/v ``[B, KH,
Sk, dh]`` with heads ``kh*g .. kh*g+g-1`` sharing KV head ``kh``) and the
JAX visibility rule: invisible logits get a -1e9 bias, so a query row with
no visible key yields finite output, never NaN.

- :func:`flash_attention`: causal prefill and the training forward,
  differentiable. CUDA tensors launch ``csrc/flash_prefill.cu`` forward
  (replaces the Pallas ``_flash_kernel``) and ``csrc/flash_backward.cu``
  backward: B10a :func:`flash_dq_cuda` (dQ and the row logsumexp, replaces
  ``_flash_dq_kernel``) then B10b :func:`flash_dkv_cuda` (dK, dV, replaces
  ``_flash_dkv_kernel``).
- :func:`flash_attention_at`: a suffix of queries at cache column ``col0``
  over a whole cache (chunked prefill, chat-session extension), bf16 or
  int8 codes with per-column scales. ``csrc/flash_prefill.cu``
  (``flash_prefill`` / ``flash_prefill_int8``).
- :func:`flash_attention_cached`: mask-only decode attention over the
  cache, bf16 or int8, optionally with the decode step's fresh K/V column
  folded in and gated per lane, or returning each row's softmax state
  ``(m, l)`` beside the output (``return_ml``, speculative
  ``Decoder.extend_slots``). ``csrc/flash_decode.cu`` (``flash_decode`` /
  ``flash_decode_int8``; replaces ``_flash_cached_kernel``).

CPU tensors run the plain versions: :func:`attention_plain` (the op
sequence of the JAX package's ``mha_reference``) for a bf16 cache without
the fold, :func:`flash_plain` (the Pallas kernels' arithmetic: un-normalized
weights times the V scales cast to q's dtype) for int8 caches, the fold and
``return_ml``, and :func:`flash_attention_bwd_plain` for the backward.
"""

from __future__ import annotations

import torch

from mediquery_rag_tpu_torch.ops import _build

_TARGET_BLOCKS = 264   # two blocks per SM of an H100
_PREFILL_ROWS = 128    # folded query rows per B6 block
_DKV_KEYS = 128        # keys per B10b block


def prefill_splits(B: int, KH: int, rows: int, sk: int, quant: bool) -> int:
    """How many blocks B6 splits each row tile's key range over: 1 when the
    ``B * KH * ceil(rows / 128)`` blocks (``rows`` = folded query rows per
    KV head) fill two waves, else up to 4, keeping two key tiles (64 keys
    int8, 128 bf16) per split."""
    blocks = B * KH * -(-rows // _PREFILL_ROWS)
    if blocks >= _TARGET_BLOCKS:
        return 1
    tiles = -(-sk // (64 if quant else 128))
    return max(1, min(4, -(-_TARGET_BLOCKS // blocks), tiles // 2))


def dkv_splits(B: int, KH: int, g: int, sk: int) -> int:
    """How many blocks B10b splits each KV head's ``g`` query heads over:
    the least divisor of ``g`` that brings ``B * KH * ceil(sk / 128)``
    blocks to two waves (then f32 parts, summed in order by a second
    kernel), else ``g``."""
    blocks = B * KH * -(-sk // _DKV_KEYS)
    for d in range(1, g + 1):
        if g % d == 0 and blocks * d >= _TARGET_BLOCKS:
            return d
    return g


def _rows4(t: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """``t`` as f32 ``[rows, n]``, each row padded with zeros to a multiple
    of 4 values, contiguous at a 16-byte aligned address: the kernels read
    these rows by TMA, which wants 16-byte row strides and addresses."""
    t = t.float().reshape(rows, n)
    if n % 4:
        t = torch.nn.functional.pad(t, (0, 4 - n % 4))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prefill_parts(q, KH, sk, quant):
    """B6's split of the key range and its partial-state scratch: (nsplit,
    [m, l, o]), the list empty when not split."""
    B, H, S, dh = q.shape
    rows = H // KH * S
    nsplit = prefill_splits(B, KH, rows, sk, quant)
    if nsplit == 1:
        return 1, []
    rpad = -(-rows // _PREFILL_ROWS) * _PREFILL_ROWS
    ml = [torch.empty((B * KH, nsplit, rpad), dtype=torch.float32, device=q.device)
          for _ in "ml"]
    return nsplit, [*ml, torch.empty((B * KH, nsplit, rpad, dh), dtype=torch.float32,
                                     device=q.device)]


def _ptrs(ts, n):
    """Data pointers of ``ts``, or ``n`` null pointers for an empty list."""
    return [t.data_ptr() for t in ts] or [None] * n


def _visible(key_mask, S, sk, causal, q_offset):
    """Key c visible to query row r: ``key_mask[b, c] > 0`` and, if
    ``causal``, ``c <= q_offset[b] + r``. Returns bool ``[B, 1, S|1, Sk]``."""
    vis = (key_mask.float() > 0)[:, None, None, :]
    if causal:
        B = key_mask.shape[0]
        off = (torch.zeros(B, dtype=torch.int64, device=key_mask.device)
               if q_offset is None else q_offset.long())
        rows = torch.arange(S, device=key_mask.device)[None, :] + off[:, None]
        cols = torch.arange(sk, device=key_mask.device)
        vis = vis & (cols[None, None, :] <= rows[:, :, None])[:, None]
    return vis


def _rep(t, g):
    """Repeat the KV-head axis (dim 1) over its ``g`` query heads."""
    return t.float().repeat_interleave(g, dim=1)


def _softmax_weights(q, k, v, key_mask, scale, causal, q_offset, k_scale=None,
                     v_scale=None, fresh_k=None, fresh_v=None, fresh_gate=None):
    """f32 softmax weights ``[B, H, S, Sk]`` (-1e9 bias on invisible keys)
    and v in f32 with its KV heads repeated over their query heads; int8
    codes are dequantized with their scales, and the fresh column (its
    logit shifted by log(gate), so a gated-off lane drops it) is appended."""
    B, H, S, _ = q.shape
    g = H // k.shape[1]
    kf, vf = _rep(k, g), _rep(v, g)
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    if k_scale is not None:
        logits = logits * _rep(k_scale, g)[:, :, None, :]
        vf = vf * _rep(v_scale, g)[..., None]
    vis = _visible(key_mask, S, k.shape[2], causal, q_offset)
    logits = logits + (vis.float() - 1.0) * 1e9
    if fresh_k is not None:
        gate = (torch.ones(B, device=q.device) if fresh_gate is None
                else fresh_gate.float())
        s2 = (q.float() * _rep(fresh_k, g)).sum(-1, keepdim=True) * scale
        logits = torch.cat([logits, s2 + torch.log(gate)[:, None, None, None]], -1)
        vf = torch.cat([vf, _rep(fresh_v, g)], -2)
    return torch.softmax(logits, dim=-1), vf


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor, scale: float, *, causal: bool,
                    q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of both kernels: f32 logits, -1e9 bias on invisible
    keys (key c visible to query row r iff ``key_mask[b, c] > 0`` and, if
    ``causal``, ``c <= q_offset[b] + r``), softmax, weights cast to q's
    dtype, f32 P.V. Returns q's dtype."""
    w, vf = _softmax_weights(q, k, v, key_mask, scale, causal, q_offset)
    return (w.to(q.dtype).float() @ vf).to(q.dtype)


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: torch.Tensor, scale: float, *, causal: bool = False,
                q_offset: torch.Tensor | None = None,
                k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
                fresh_k: torch.Tensor | None = None, fresh_v: torch.Tensor | None = None,
                fresh_gate: torch.Tensor | None = None, return_ml: bool = False):
    """Plain version of the int8, fresh-fold and (m, l) kernels, in the
    Pallas kernels' arithmetic: logits ``(q . k) * scale [* ks]`` plus the
    -1e9 bias, ``m = max``, ``p = e^(s - m)``, ``l = sum p``, ``acc =
    bf16(p [* vs]) . v`` (codes for an int8 cache); then ``acc / l``, or
    with the fresh column (``[B, KH, 1, dh]``, gate ``[B]``): ``s2 = q . kn
    * scale``, ``m2 = max(m, s2)``, ``a1 = e^(m - m2) l``, ``a2 = e^(s2 -
    m2) gate``, ``(acc e^(m - m2) + a2 vn) / max(a1 + a2, 1e-30)``. Returns
    q's dtype, or with ``return_ml`` the tuple ``(acc / l, m, l)``, m and l
    f32 ``[B, H, S]`` (never with the fold)."""
    if return_ml and fresh_k is not None:
        raise ValueError("the fresh-column fold replaces the (m, l) path")
    B, H, S, _ = q.shape
    g = H // k.shape[1]
    qf = q.float()
    s = (qf @ _rep(k, g).transpose(-1, -2)) * scale
    if k_scale is not None:
        s = s * _rep(k_scale, g)[:, :, None, :]
    vis = _visible(key_mask, S, k.shape[2], causal, q_offset)
    s = s + (vis.float() - 1.0) * 1e9
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * _rep(v_scale, g)[:, :, None, :]
    acc = p.to(q.dtype).float() @ _rep(v, g)
    if return_ml:
        return (acc / l).to(q.dtype), m[..., 0], l[..., 0]
    if fresh_k is None:
        return (acc / l).to(q.dtype)
    gate = (torch.ones(B, device=q.device) if fresh_gate is None
            else fresh_gate.float())[:, None, None, None]
    s2 = (qf * _rep(fresh_k, g)).sum(dim=-1, keepdim=True) * scale
    m2 = torch.maximum(m, s2)
    c1 = torch.exp(m - m2)
    a2 = torch.exp(s2 - m2) * gate
    ctx = acc * c1 + a2 * _rep(fresh_v, g)
    return (ctx / torch.clamp(c1 * l + a2, min=1e-30)).to(q.dtype)


def attention_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor, scale: float, ref: torch.Tensor,
                          *, causal: bool, q_offset: torch.Tensor | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None,
                          fresh_k: torch.Tensor | None = None,
                          fresh_v: torch.Tensor | None = None,
                          fresh_gate: torch.Tensor | None = None) -> torch.Tensor:
    """Per-element bound on ``|kernel - ref|`` for the bf16-weight kernels,
    where ``ref`` is :func:`attention_plain` (or :func:`flash_plain`) on the
    same inputs. Both round the weights fed to P.V to bf16 (at another
    running max, or before vs after normalizing): each differs by at most
    2^-7 relative, so the gap is at most ``2^-7 sum w|v|``; the roundings
    are independent, so it stays within ``2^-5 sqrt(sum w^2 v^2)`` (about
    13 standard deviations). With an int8 cache the rounded weight is
    ``p * vs`` against a code, so v is the dequantized ``code * vs``; the
    fresh column's term is not rounded and only loosens the bound. Both
    results are then rounded to bf16: up to 2 ulp of ``|ref|``."""
    w, vf = _softmax_weights(q, k, v, key_mask, scale, causal, q_offset, k_scale,
                             v_scale, fresh_k, fresh_v, fresh_gate)
    worst = w @ vf.abs()
    spread = ((w * w) @ (vf * vf)).sqrt()
    del w
    _, e = torch.frexp(ref.float())
    ulp = torch.where(ref != 0, torch.ldexp(torch.ones_like(worst), e - 8),
                      torch.zeros_like(worst))
    return 2 * ulp + torch.minimum(worst * 2.0 ** -7, spread * 2.0 ** -5)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_mask: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, scale: float
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the causal flash backward (B10a + B10b): recomputes
    the softmax weights P in f32 with the forward's -1e9 bias, forms D =
    rowsum(dO * O) in f32 from the forward's output, and rounds as the JAX
    kernels do: P is cast to the input dtype before dV = P^T dO, dS = P
    (dP - D) scale before dQ = dS K and dK = dS^T Q. dK and dV are summed
    over each KV head's query group. Returns (dq, dk, dv) in the input
    dtypes."""
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    w, vf = _softmax_weights(q, k, v, key_mask, scale, True, None)
    do = dout.float()
    D = (do * out.float()).sum(-1, keepdim=True)
    dv = w.to(q.dtype).float().transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    ds = (w * (dp - D) * scale).to(q.dtype).float()
    del w, dp
    dq = ds @ _rep(k, g)
    dk = ds.transpose(-1, -2) @ q.float()
    fold = (B, KH, g, Sk, dh)
    return (dq.to(q.dtype), dk.reshape(fold).sum(2).to(k.dtype),
            dv.reshape(fold).sum(2).to(v.dtype))


def attention_grad_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               key_mask: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, scale: float,
                               refs: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-element bounds on ``|kernel - ref|`` for (dQ, dK, dV), where
    ``refs`` is :func:`flash_attention_bwd_plain` on the same inputs. Built
    like :func:`attention_error_bound`: the kernels and the plain version
    each round P (before dV) and dS (before dQ and dK) to bf16, at
    different points (the dQ pass rounds the un-normalized dS), so each
    rounded factor differs by at most 2^-7 relative. dV's gap is then at
    most ``2^-7 sum_r P|dO|`` and within ``2^-5 sqrt(sum_r P^2 dO^2)``
    (about 13 standard deviations of independent roundings); dQ's the same
    over ``|dS||K|``, dK's over ``|dS||Q|``. The smaller of the two is
    taken, plus ``2^-12`` of the worst case for f32 sums in another order
    over up to 4K keys. dP and D are f32 sums of dh products each, summed
    in another order by the kernels: up to ``dh 2^-24 (|dO|.|V| +
    |dO|.|O|)`` per logit, times ``P scale``, carried into dQ and dK (it
    is what remains where dS cancels to 0, as on a row's first position).
    Both results are then rounded to bf16: up to 2 ulp of ``|ref|``."""
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    w, vf = _softmax_weights(q, k, v, key_mask, scale, True, None)
    do = dout.float()
    D = (do * out.float()).sum(-1, keepdim=True)
    ds = (w * ((do @ vf.transpose(-1, -2)) - D) * scale).abs()
    dots = w * (do.abs() @ vf.abs().transpose(-1, -2)
                + (do * out.float()).abs().sum(-1, keepdim=True)) * (scale * dh * 2.0 ** -24)
    fold = (B, KH, g, Sk, dh)

    def group(t):
        return t.reshape(fold).sum(2)

    def gap(a, x, f32=None, sum_group=False):
        worst, spread = a @ x.abs(), (a * a) @ (x * x)
        sums = 0.0 if f32 is None else f32 @ x.abs()
        if sum_group:
            worst, spread = group(worst), group(spread)
            sums = sums if f32 is None else group(sums)
        return (torch.minimum(worst * 2.0 ** -7, spread.sqrt() * 2.0 ** -5)
                + worst * 2.0 ** -12 + sums)

    gaps = (gap(ds, _rep(k, g), dots),
            gap(ds.transpose(-1, -2), q.float(), dots.transpose(-1, -2), sum_group=True),
            gap(w.transpose(-1, -2), do, sum_group=True))
    del w, ds, dots
    bounds = []
    for ref, e in zip(refs, gaps):
        _, ex = torch.frexp(ref.float())
        ulp = torch.where(ref != 0, torch.ldexp(torch.ones_like(e), ex - 8),
                          torch.zeros_like(e))
        bounds.append(2 * ulp + e)
    return tuple(bounds)


def _check_cuda(q, k, v, *more, quant: bool = False):
    if q.dtype != torch.bfloat16:
        raise ValueError("the CUDA attention kernels take bfloat16 queries")
    want = torch.int8 if quant else torch.bfloat16
    for t in (k, v):
        if t.dtype != want:
            raise ValueError(f"this CUDA attention kernel takes a {want} cache, "
                             f"got {t.dtype}")
    for t in (q, k, v, *more):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("attention operands must be contiguous and "
                             "16-byte aligned")
    dh = q.shape[-1]
    if dh not in (64, 128):
        raise ValueError(f"the CUDA attention kernels take dh 64 or 128, got {dh}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")


def _scales(k, k_scale, v_scale):
    """Per-column int8 scales as contiguous f32 ``[B, KH, C]``."""
    want = tuple(k.shape[:3])
    out = []
    for t in (k_scale, v_scale):
        if t is None or tuple(t.shape) != want:
            raise ValueError(f"int8 cache needs k_scale and v_scale of shape {want}")
        out.append(t.float().contiguous())
    return out


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_mask: torch.Tensor, q_offset: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Launch ``csrc/flash_prefill.cu`` (causal, per-row query offset)."""
    _check_cuda(q, k, v)
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    lib = _build.load("flash_prefill")
    mask = _rows4(key_mask, B, Sk)
    off = q_offset.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit, parts = _prefill_parts(q, KH, Sk, False)
    _build.check(lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        off.data_ptr(), out.data_ptr(), *_ptrs(parts, 3), B, H, KH, S, Sk, dh, nsplit,
        float(scale), _build.stream_ptr(q)), "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0


def _bwd_operands(q, k, v, key_mask, dout, *rows):
    """Checks shared by B10a and B10b; returns the f32 mask and the
    contiguous f32 ``[B, H, S]`` row vectors (D, lse)."""
    _check_cuda(q, k, v, dout)
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError("dout must match q in shape and dtype")
    want = tuple(q.shape[:3])
    for t in rows:
        if tuple(t.shape) != want:
            raise ValueError(f"row vectors must be [B, H, S] = {want}, got {tuple(t.shape)}")
    return key_mask.float().contiguous(), [t.float().contiguous() for t in rows]


def flash_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: torch.Tensor, dout: torch.Tensor, D: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """B10a: launch ``flash_bwd_dq`` of ``csrc/flash_backward.cu`` (causal).
    ``D`` = rowsum(dO * O) [B, H, S] f32. Returns (dq bf16 [B, H, S, dh],
    the per-row logsumexp [B, H, S] f32)."""
    mask, (D,) = _bwd_operands(q, k, v, key_mask, dout, D)
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    lib = _build.load("flash_backward")
    dq = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _build.check(lib.flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask.data_ptr(),
        D.data_ptr(), dq.data_ptr(), lse.data_ptr(), B, H, KH, S, Sk, dh,
        float(scale), _build.stream_ptr(q)), "flash_bwd_dq")
    flash_dq_cuda.launches += 1
    return dq, lse


flash_dq_cuda.launches = 0


def flash_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                   D: torch.Tensor, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """B10b: launch ``flash_bwd_dkv`` of ``csrc/flash_backward.cu`` (causal),
    which rebuilds P from B10a's logsumexp and sums each KV head's gradient
    over its query group: inside the block, or, when :func:`dkv_splits`
    splits the group's heads over blocks, as f32 parts in a scratch buffer
    summed in order by a second kernel. Returns (dk, dv) bf16 [B, KH, Sk,
    dh]."""
    mask, rows = _bwd_operands(q, k, v, key_mask, dout, lse, D)
    B, H, S, dh = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    mask = _rows4(mask, B, Sk)
    lse, D = (_rows4(t, B * KH, H // KH * S) for t in rows)
    lib = _build.load("flash_backward")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    nsplit = dkv_splits(B, KH, H // KH, Sk)
    parts = ([torch.empty((nsplit, B, KH, Sk, dh), dtype=torch.float32, device=q.device)
              for _ in "kv"] if nsplit > 1 else [])
    _build.check(lib.flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_ptrs(parts, 2), B, H, KH, S, Sk, dh, nsplit,
        float(scale), _build.stream_ptr(q)), "flash_bwd_dkv")
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_dkv_cuda.launches = 0


def flash_prefill_int8_cuda(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                            k_scale: torch.Tensor, v_scale: torch.Tensor,
                            key_mask: torch.Tensor, q_offset: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Launch ``flash_prefill_int8`` of ``csrc/flash_prefill.cu``: causal,
    per-row query offset, over int8 codes with ``[B, KH, Sk]`` scales."""
    _check_cuda(q, k8, v8, quant=True)
    B, H, S, dh = q.shape
    KH, Sk = k8.shape[1], k8.shape[2]
    ks, vs = (_rows4(t, B * KH, Sk) for t in _scales(k8, k_scale, v_scale))
    lib = _build.load("flash_prefill")
    mask = _rows4(key_mask, B, Sk)
    off = q_offset.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    nsplit, parts = _prefill_parts(q, KH, Sk, True)
    _build.check(lib.flash_prefill_int8(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        mask.data_ptr(), off.data_ptr(), out.data_ptr(), *_ptrs(parts, 3), B, H, KH, S, Sk, dh,
        nsplit, float(scale), _build.stream_ptr(q)), "flash_prefill_int8")
    flash_prefill_int8_cuda.launches += 1
    return out


flash_prefill_int8_cuda.launches = 0


def _decode_launch(entry: str, q, k, v, scales, key_mask, scale, fresh_k, fresh_v,
                   fresh_gate, ml: bool = False):
    """Shared set-up of both decode kernels: the split of the cache over
    blocks, the partial-state scratch, the fresh-fold operands and, with
    ``ml``, the (m, l) outputs. Returns the output, or (output, m, l)."""
    B, H, S, dh = q.shape
    KH, C = k.shape[1], k.shape[2]
    dev = q.device
    fresh = []
    if fresh_k is not None:
        if S != 1:
            raise ValueError("the fresh-column fold takes one query position")
        for t in (fresh_k, fresh_v):
            if tuple(t.shape) != (B, KH, 1, dh):
                raise ValueError(f"fresh_k/fresh_v must be [B, KH, 1, dh], got {tuple(t.shape)}")
        gate = (torch.ones(B, device=dev) if fresh_gate is None
                else fresh_gate.float()).contiguous()
        fresh = [fresh_k.to(torch.bfloat16).contiguous(),
                 fresh_v.to(torch.bfloat16).contiguous(), gate]
    lib = _build.load("flash_decode")
    nsplit = max(1, min(-(-C // 64), -(-_TARGET_BLOCKS // (B * KH))))
    per_split = -(-C // nsplit)
    chunk = -(-per_split // 64) * 64          # whole 64-key tiles per split
    nsplit = -(-C // chunk)
    rpad = -(-(H // KH) * S // 16) * 16
    part_m = torch.empty((B * KH, nsplit, rpad), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * KH, nsplit, rpad, dh), dtype=torch.float32,
                           device=dev)
    mask = key_mask.float().contiguous()
    out = torch.empty_like(q)
    fptrs = [t.data_ptr() for t in fresh] if fresh else [None, None, None]
    ml_out = [torch.empty((B, H, S), dtype=torch.float32, device=dev)
              for _ in range(2)] if ml else []
    _build.check(getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *[t.data_ptr() for t in scales],
        mask.data_ptr(), *fptrs, part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(),
        *([t.data_ptr() for t in ml_out] if ml else [None, None]),
        B, H, KH, S, C, dh, nsplit, chunk, float(scale), _build.stream_ptr(q)), entry)
    return (out, *ml_out) if ml else out


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor, scale: float, *,
                      fresh_k: torch.Tensor | None = None,
                      fresh_v: torch.Tensor | None = None,
                      fresh_gate: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``flash_decode`` of ``csrc/flash_decode.cu`` (mask-only, split
    over the bf16 cache; optionally the gated fresh-column fold)."""
    _check_cuda(q, k, v)
    out = _decode_launch("flash_decode", q, k, v, [], key_mask, scale,
                         fresh_k, fresh_v, fresh_gate)
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode_int8_cuda(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           key_mask: torch.Tensor, scale: float, *,
                           fresh_k: torch.Tensor | None = None,
                           fresh_v: torch.Tensor | None = None,
                           fresh_gate: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``flash_decode_int8`` of ``csrc/flash_decode.cu``: the decode
    kernel over int8 codes with ``[B, KH, C]`` scales, optionally with the
    gated fresh-column fold."""
    _check_cuda(q, k8, v8, quant=True)
    scales = _scales(k8, k_scale, v_scale)
    out = _decode_launch("flash_decode_int8", q, k8, v8, scales, key_mask, scale,
                         fresh_k, fresh_v, fresh_gate)
    flash_decode_int8_cuda.launches += 1
    return out


flash_decode_int8_cuda.launches = 0


def flash_decode_ml_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_mask: torch.Tensor, scale: float, *,
                         k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``flash_decode`` (bf16 cache) or ``flash_decode_int8`` (int8
    codes with ``[B, KH, C]`` scales) of ``csrc/flash_decode.cu`` with the
    (m, l) outputs: returns (o ``[B, H, S, dh]`` in q's dtype, the row max
    m and denominator l ``[B, H, S]`` f32)."""
    _check_cuda(q, k, v, quant=k_scale is not None)
    scales = [] if k_scale is None else _scales(k, k_scale, v_scale)
    entry = "flash_decode" if k_scale is None else "flash_decode_int8"
    out = _decode_launch(entry, q, k, v, scales, key_mask, scale, None, None, None,
                         ml=True)
    flash_decode_ml_cuda.launches += 1
    return out


flash_decode_ml_cuda.launches = 0


@torch.library.custom_op("mediquery_torch::flash_attention", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The causal forward as one registered op, so that a selective
    checkpoint policy can keep its output (``Decoder.apply(remat="names")``)
    instead of re-running the kernel: B6 for CUDA tensors, else
    :func:`attention_plain`."""
    off = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return flash_prefill_cuda(q, k, v, key_mask, off, scale)
    return attention_plain(q, k, v, key_mask, scale, causal=True, q_offset=off)


@_flash_fwd.register_fake
def _(q, k, v, key_mask, scale):
    return torch.empty_like(q)


def _flash_setup(ctx, inputs, output):
    q, k, v, key_mask, scale = inputs
    ctx.save_for_backward(q, k, v, key_mask, output)
    ctx.scale = scale


def _flash_bwd(ctx, dout):
    """B10a then B10b for CUDA tensors (D = rowsum(dO * O) in f32 beside
    them), the plain backward for CPU tensors; no gradient for the mask."""
    q, k, v, key_mask, out = ctx.saved_tensors
    dout = dout.contiguous()
    if q.is_cuda:
        D = (dout.float() * out.float()).sum(-1)
        dq, lse = flash_dq_cuda(q, k, v, key_mask, dout, D, ctx.scale)
        dk, dv = flash_dkv_cuda(q, k, v, key_mask, dout, lse, D, ctx.scale)
    else:
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, key_mask, out, dout, ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd.register_autograd(_flash_bwd, setup_context=_flash_setup)


def flash_attention(
    q: torch.Tensor,            # [B, H, S, dh]
    k: torch.Tensor,            # [B, KH, S, dh] — KH divides H (GQA)
    v: torch.Tensor,            # [B, KH, S, dh]
    key_mask: torch.Tensor,     # [B, S], 1.0 = real token
    *,
    scale: float | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Causal attention without materializing ``[S, S]``, differentiable in
    q, k and v (the JAX package's ``custom_vjp``). Query position ``r``
    attends to keys ``c <= r`` with ``key_mask[b, c] == 1``. Returns ``[B,
    H, S, dh]`` in q's dtype. Non-causal calls raise (no caller of the JAX
    package makes one)."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")
    if not causal:
        raise NotImplementedError(
            "non-causal flash_attention: use flash_attention_cached")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                      key_mask.float().contiguous(), float(scale))


def _check_scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")


def flash_attention_at(
    q: torch.Tensor,            # [B, H, S, dh] — a fresh suffix of S tokens
    k: torch.Tensor,            # [B, KH, C, dh] — the whole cache, the suffix's
    v: torch.Tensor,            #   K/V already written at col0 .. col0+S-1
    key_mask: torch.Tensor,     # [B, C] — cache validity incl. the suffix
    col0: torch.Tensor,         # [B] int — cache column of each lane's query 0
    *,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,   # [B, KH, C] f32 — int8 cache
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Continuation attention (``Decoder.prefill_extend``): query ``r`` sees
    mask-live cache columns ``c <= col0[b] + r``. With ``k_scale``/
    ``v_scale`` the cache holds int8 codes. Returns ``[B, H, S, dh]`` in q's
    dtype."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")
    _check_scales(k_scale, v_scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    col0 = torch.as_tensor(col0, device=q.device).reshape(q.shape[0])
    if q.is_cuda:
        if k_scale is not None:
            return flash_prefill_int8_cuda(q, k, v, k_scale, v_scale, key_mask, col0, scale)
        return flash_prefill_cuda(q, k, v, key_mask, col0, scale)
    if k_scale is not None:
        return flash_plain(q, k, v, key_mask, scale, causal=True, q_offset=col0,
                           k_scale=k_scale, v_scale=v_scale)
    return attention_plain(q, k, v, key_mask, scale, causal=True, q_offset=col0)


def flash_attention_cached(
    q: torch.Tensor,            # [B, H, S, dh] — decode-step queries
    k: torch.Tensor,            # [B, KH, C, dh] — one layer of the cache
    v: torch.Tensor,            # [B, KH, C, dh]
    key_mask: torch.Tensor,     # [B, C] — 1.0 = live cache column
    *,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,    # [B, KH, C] f32 — int8 cache
    v_scale: torch.Tensor | None = None,
    return_ml: bool = False,
    fresh_k: torch.Tensor | None = None,    # [B, KH, 1, dh] float — the decode
    fresh_v: torch.Tensor | None = None,    #   step's own column, not yet cached
    fresh_gate: torch.Tensor | None = None,  # [B] f32, 1 = lane active
):
    """Mask-only cache attention (the key mask alone says what each lane
    sees). With ``k_scale``/``v_scale`` the cache holds int8 codes; with
    ``fresh_k``/``fresh_v`` the step's fresh column is one more key, its
    term gated per lane by ``fresh_gate`` (default 1), and an inactive lane
    over an empty cache gives finite output. Returns ``[B, H, S, dh]`` in
    q's dtype; with ``return_ml`` the tuple (o, m, l): each row's running
    max m and denominator l ``[B, H, S]`` f32, so the caller can fold more
    softmax columns in outside the kernel (speculative ``extend_slots``).
    The fold and ``return_ml`` cannot be combined."""
    if return_ml and fresh_k is not None:
        raise ValueError("the fresh-column fold replaces the (m, l) path")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} % kv_heads {k.shape[1]} != 0")
    _check_scales(k_scale, v_scale)
    if (fresh_k is None) != (fresh_v is None):
        raise ValueError("fresh_k and fresh_v must be given together")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if return_ml:
        if q.is_cuda:
            return flash_decode_ml_cuda(q, k, v, key_mask, scale, k_scale=k_scale,
                                        v_scale=v_scale)
        return flash_plain(q, k, v, key_mask, scale, k_scale=k_scale, v_scale=v_scale,
                           return_ml=True)
    fresh = {"fresh_k": fresh_k, "fresh_v": fresh_v, "fresh_gate": fresh_gate}
    if q.is_cuda:
        if k_scale is not None:
            return flash_decode_int8_cuda(q, k, v, k_scale, v_scale, key_mask, scale,
                                          **fresh)
        return flash_decode_cuda(q, k, v, key_mask, scale, **fresh)
    if k_scale is None and fresh_k is None:
        return attention_plain(q, k, v, key_mask, scale, causal=False)
    return flash_plain(q, k, v, key_mask, scale, k_scale=k_scale, v_scale=v_scale,
                       **fresh)
