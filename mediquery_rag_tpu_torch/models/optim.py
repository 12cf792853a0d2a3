"""The optimizers of the LM trainers, written to equal optax's (the JAX
package's ``optax.chain`` recipes in ``models/train_lm.py`` and
``models/lora.py``; the port has no optax).

A transform is ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)`` over lists of tensors (a parameter tree's leaves in
JAX order, :func:`tree_leaves`); ``chain`` composes them as ``optax.chain``
does. Step counts are host ints and schedules are evaluated in float32 on
the host, as optax does on its int32 counts, so no step waits on the
device. Optimizer state lives on the parameters' device. ``torch.optim``
is not used: its AdamW and Adafactor differ from optax's in epsilon
placement, decay scaling and defaults.

Over a training mesh each leaf may be this rank's shard of a tensor-parallel
parameter (``parallel.dist.Layout``; ``shards``: one ``LeafShard`` or None
per leaf). Every transform that reduces over a whole leaf then computes the
whole leaf's value: the global norm, Adafactor's factored means (which
dims to factor is decided from the full shape) and the block RMSes sum
their sharded parts over the model group (``parallel.dist.sharded_sum``),
so the step equals the one-process step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from mediquery_rag_tpu_torch.parallel.dist import sharded_mean, sharded_sum

Schedule = Callable[[int], torch.Tensor]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """Leaves of a nested dict in JAX tree-flatten order (keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value``; ``decay_steps`` includes the warmup. Returns a
    function of the int step count giving a float32 scalar, computed in
    optax's float32 operation order."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)
    if not cos_steps > 0:
        raise ValueError(f"decay_steps must exceed warmup_steps, got {decay_steps}")

    def warmup(count: int) -> torch.Tensor:
        if warmup_steps <= 0:
            return _f32(init_value)
        c = _f32(min(max(count, 0), warmup_steps))
        frac = 1 - c / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count: int) -> torch.Tensor:
        c = torch.minimum(_f32(count), _f32(cos_steps))
        decay = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(cos_steps)))
        return peak_value * ((1 - alpha) * decay ** exponent + alpha)

    def schedule(count: int) -> torch.Tensor:
        return warmup(count) if count < warmup_steps else cosine(count - warmup_steps)

    return schedule


def _shards(shards, n: int) -> list:
    return [None] * n if shards is None else list(shards)


def global_norm(tensors: Sequence[torch.Tensor], shards=None) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's sum of
    squares (a device scalar; no host sync), of the whole leaves when
    ``shards`` says which are this rank's parts."""
    return torch.sqrt(sum(sharded_sum(t.float() * t.float(), s, None if s is None else s.dim)
                          for t, s in zip(tensors, _shards(shards, len(tensors)))))


def chain(*txs: Transform) -> Transform:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(grads, state, params):
        new = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new.append(s)
        return grads, new

    return Transform(init, update)


def _stateless(fn) -> Transform:
    return Transform(lambda params: None, lambda u, s, p: (fn(u, p), None))


def clip_by_global_norm(max_norm: float, shards=None) -> Transform:
    """``optax.clip_by_global_norm``: ``g * max / norm`` only where the
    norm exceeds ``max`` (not torch's ``max / (norm + 1e-6)``)."""
    def clip(updates, params):
        g = global_norm(updates, shards)
        keep = g < max_norm
        return [torch.where(keep, t, (t / g.to(t.dtype)) * max_norm) for t in updates]
    return _stateless(clip)


def scale(step: float) -> Transform:
    return _stateless(lambda updates, params: [step * u for u in updates])


def scale_by_schedule(step_size: Schedule) -> Transform:
    """Multiply by ``step_size(count)``; the count is read before it is
    incremented (optax ``scale_by_schedule``)."""
    def update(updates, count, params):
        s = step_size(count)
        return [s.to(u.device, u.dtype) * u for u in updates], count + 1
    return Transform(lambda params: 0, update)


def scale_by_learning_rate(lr: Schedule | float, *, flip_sign: bool = True) -> Transform:
    """A schedule, or a constant ``lr`` (optax's ``scale(-lr)``: the f32
    value of ``-lr`` times each update)."""
    m = -1 if flip_sign else 1
    if not callable(lr):
        return scale_by_schedule(lambda count: _f32(m * lr))
    return scale_by_schedule(lambda count: m * lr(count))


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """``optax.scale_by_adam``: bias-corrected moments, ``m / (sqrt(v) + eps)``."""
    def init(params):
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(updates, state, params):
        count = state.count + 1
        c1 = 1 - _f32(b1) ** count
        c2 = 1 - _f32(b2) ** count
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state.mu)]
        nu = [(1 - b2) * g ** 2 + b2 * v for g, v in zip(updates, state.nu)]
        out = [(m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device)) + eps)
               for m, v in zip(mu, nu)]
        return out, AdamState(count, mu, nu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    return _stateless(lambda updates, params: [
        g + weight_decay * p.detach() for g, p in zip(updates, params)])


def adam(learning_rate: Schedule) -> Transform:
    return chain(scale_by_adam(), scale_by_learning_rate(learning_rate))


def adamw(learning_rate: Schedule, weight_decay: float = 1e-4) -> Transform:
    """``optax.adamw``: Adam (eps 1e-8), decoupled decay ``wd * p`` added
    before the (scheduled) learning rate, so the decay is scaled by it."""
    return chain(scale_by_adam(), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice of the two largest dims to factor (numpy's argsort, as
    optax calls it), or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class FactoredState(NamedTuple):
    count: int
    v_row: list
    v_col: list
    v: list


def _whole_shape(p: torch.Tensor, s) -> tuple:
    return tuple(p.shape) if s is None else tuple(s.full_shape(p.shape))


def _minus(dim: int | None, removed: int) -> int | None:
    """Where a tensor's dim ``dim`` lands once dim ``removed`` is reduced
    away (None: gone, or nothing there)."""
    if dim is None or dim == removed:
        return None
    return dim - (dim > removed)


def scale_by_factored_rms(decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30, shards=None) -> Transform:
    """``optax.scale_by_factored_rms`` (factored second moment: row and
    column means of ``g^2 + eps`` for a parameter whose two largest dims
    reach ``min_dim_size_to_factor``, else the full per-element moment)."""
    def init(params):
        rows, cols, full = [], [], []
        for p, s in zip(params, _shards(shards, len(params))):
            dims = _factored_dims(_whole_shape(p, s), min_dim_size_to_factor)
            z = p.new_zeros(1)
            if dims is None:
                row, col, v = z, z, torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                row = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                col = p.new_zeros(shape[:d1] + shape[d1 + 1:])
                v = z
            rows.append(row)
            cols.append(col)
            full.append(v)
        return FactoredState(0, rows, cols, full)

    def update(grads, state, params):
        rate = 1.0 - _f32(state.count + 1) ** (-decay_rate)
        out, rows, cols, full = [], [], [], []
        for g, vr, vc, v, p, s in zip(grads, state.v_row, state.v_col, state.v, params,
                                      _shards(shards, len(params))):
            r = rate.to(g.device)
            gsq = g * g + epsilon
            dims = _factored_dims(_whole_shape(p, s), min_dim_size_to_factor)
            sd = None if s is None else s.dim
            if dims is None:
                v = r * v + (1.0 - r) * gsq
                out.append(g * v ** -0.5)
            else:
                d1, d0 = dims
                vr = r * vr + (1.0 - r) * sharded_mean(gsq, s, sd, d0)
                vc = r * vc + (1.0 - r) * sharded_mean(gsq, s, sd, d1)
                rd1 = d1 - 1 if d1 > d0 else d1
                row_mean = sharded_mean(vr, s, _minus(sd, d0), rd1, keepdim=True)
                row_factor = (vr / row_mean) ** -0.5
                out.append(g * row_factor.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1))
            rows.append(vr)
            cols.append(vc)
            full.append(v)
        return out, FactoredState(state.count + 1, rows, cols, full)

    return Transform(init, update)


def _rms(t: torch.Tensor, s) -> torch.Tensor:
    """The whole leaf's root mean square (``t`` this rank's part per ``s``)."""
    return torch.sqrt(sharded_mean(t * t, s, None if s is None else s.dim))


def clip_by_block_rms(threshold: float, shards=None) -> Transform:
    return _stateless(lambda updates, params: [
        u / torch.clamp(_rms(u, s) / threshold, min=1.0)
        for u, s in zip(updates, _shards(shards, len(updates)))])


def scale_by_param_block_rms(min_scale: float = 1e-3, shards=None) -> Transform:
    """Multiply by each parameter's RMS, floored at ``min_scale``."""
    def rms(p, s):
        r = _rms(p.detach(), s)
        return torch.where(r <= min_scale, torch.full_like(r, min_scale), r)
    return _stateless(lambda updates, params: [
        u * rms(p, s) for u, p, s in zip(updates, params, _shards(shards, len(params)))])


def adafactor(learning_rate: Schedule, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, clipping_threshold: float = 1.0,
              epsilon: float = 1e-30, shards=None) -> Transform:
    """``optax.adafactor`` with its defaults (no momentum, no weight decay,
    multiply_by_parameter_scale): factored RMS scaling, block-RMS clipping,
    the learning rate, the parameter-scale factor, then the sign flip."""
    return chain(scale_by_factored_rms(decay_rate, min_dim_size_to_factor, epsilon, shards),
                 clip_by_block_rms(clipping_threshold, shards),
                 scale_by_learning_rate(learning_rate, flip_sign=False),
                 scale_by_param_block_rms(shards=shards), scale(-1.0))


def scheduled_decay(schedule: Schedule, rate: float) -> Transform:
    """Decoupled weight decay scaled by the learning-rate schedule (JAX
    ``train_lm._scheduled_decay``): ``u - lr_t * rate * p`` after the
    optimizer's update. An identity when ``rate`` is 0."""
    if not rate:
        return _stateless(lambda updates, params: updates)

    def update(updates, count, params):
        lr = schedule(count)
        return [u - lr.to(u.device) * rate * p.detach()
                for u, p in zip(updates, params)], count + 1

    return Transform(lambda params: 0, update)


def state_shards(state, params: Sequence[torch.Tensor], shards):
    """The optimizer state's structure with, for each of its tensors, the
    ``LeafShard`` it is split by (None: whole on every rank), for the
    leaves ``params`` split by ``shards``: Adam's moments are split as
    their leaves; a factored row (column) moment loses the dim it averaged
    over, so its split dim moves down past it, or it is whole when that
    was the split dim (its mean was all-reduced)."""
    if isinstance(state, AdamState):
        return AdamState(None, list(shards), list(shards))
    if isinstance(state, FactoredState):
        rows, cols, full = [], [], []
        for p, s, v in zip(params, shards, state.v):
            if s is None or v.shape == p.shape:          # not factored
                rows.append(None)
                cols.append(None)
                full.append(s)
                continue
            order = np.argsort(s.full_shape(p.shape))
            d1, d0 = int(order[-2]), int(order[-1])
            rows.append(None if s.dim == d0 else dataclasses.replace(s, dim=_minus(s.dim, d0)))
            cols.append(None if s.dim == d1 else dataclasses.replace(s, dim=_minus(s.dim, d1)))
            full.append(None)
        return FactoredState(None, rows, cols, full)
    if isinstance(state, (list, tuple)):
        return [state_shards(x, params, shards) for x in state]
    return None


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` IN PLACE (the JAX trainers donate their state to the step,
    so the old parameters are never kept either)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
