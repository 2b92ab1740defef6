"""Learning-rate policies and plain optimizers of the port.

Port of the pieces of ``deeplearningexamples_tpu/core/optimizers.py`` and of
optax that the ported recipes use:

- ``_warmup`` and ``lr_poly_warmup`` (BERT pretraining). JAX evaluates them
  in fp32 on an int32 step; so does this port, in numpy fp32 on the host,
  and returns the fp32 value as a Python float.
- ``sgd`` (``optax.sgd(lr)``, no momentum), ``adam`` (``optax.adam``) and
  ``partition`` (``optax.multi_transform``), for DLRM's dual optimizer. Each
  is a ``Transform`` over a dict name -> tensor; a schedule is read at the
  update count before the update, as optax's ``scale_by_schedule``.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..ops.lamb import Transform

__all__ = ["AdamState", "adam", "lr_poly_warmup", "partition", "sgd"]

_F = np.float32

LearningRate = float | Callable[[int], float]


def _warmup(base_lr: float, step: int, warmup_steps: int) -> np.float32:
    if warmup_steps > 0:
        return _F(base_lr) * min(_F(step + 1) / _F(max(warmup_steps, 1)), _F(1.0))
    return _F(base_lr)


def lr_poly_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                   power: float = 0.5) -> Callable[[int], float]:
    """BERT PolyWarmUpScheduler (reference BERT ``schedulers.py:109``):
    linear warmup over ``warmup_steps``, then ``(1 - frac) ** power`` decay."""

    def sched(step: int) -> float:
        if step < warmup_steps:
            return float(_warmup(base_lr, step, warmup_steps))
        frac = _F(step - warmup_steps) / _F(max(total_steps - warmup_steps, 1))
        frac = min(max(frac, _F(0.0)), _F(1.0))
        return float(_F(base_lr) * (_F(1.0) - frac) ** _F(power))

    return sched


def _lr(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


def sgd(learning_rate: LearningRate) -> Transform:
    """``optax.sgd(lr)`` without momentum: updates are ``-lr * g``; the
    state is the update count."""

    def init(params: Mapping[str, torch.Tensor]) -> int:
        return 0

    def update(grads, count: int, params=None):
        names = list(grads)
        if not names:
            return {}, count + 1
        upd = torch._foreach_mul([grads[n] for n in names],
                                 -_lr(learning_rate, count))
        return dict(zip(names, upd)), count + 1

    return Transform(init, update)


class AdamState(NamedTuple):
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam``: fp32 moments, bias-corrected, ``-lr * m_hat /
    (sqrt(v_hat) + eps)``."""

    def init(params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                         {n: torch.zeros_like(p) for n, p in params.items()})

    def update(grads, state: AdamState, params=None):
        names = list(grads)
        if not names:
            return {}, state._replace(count=state.count + 1)
        g = [grads[n] for n in names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state.mu[n] for n in names], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state.nu[n] for n in names], b2))
        count = state.count + 1
        c1 = float(_F(1) - _F(b1) ** _F(count))
        c2 = float(_F(1) - _F(b2) ** _F(count))
        u = torch._foreach_div(
            torch._foreach_div(mu, c1),
            torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), eps))
        upd = torch._foreach_mul(u, -_lr(learning_rate, state.count))
        return dict(zip(names, upd)), AdamState(count, dict(zip(names, mu)),
                                                dict(zip(names, nu)))

    return Transform(init, update)


def partition(transforms: Mapping[str, Transform],
              label: Callable[[str], str]) -> Transform:
    """``optax.multi_transform``: each parameter goes to the transform its
    name's ``label`` picks; the state is a dict label -> that state."""

    def split(tree: Mapping[str, torch.Tensor]) -> dict[str, dict]:
        parts: dict[str, dict] = {k: {} for k in transforms}
        for n, x in tree.items():
            parts[label(n)][n] = x
        return parts

    def init(params):
        return {k: transforms[k].init(sub) for k, sub in split(params).items()}

    def update(grads, state, params=None):
        p_parts = split(params) if params is not None else {}
        updates, new_state = {}, {}
        for k, sub in split(grads).items():
            upd, new_state[k] = transforms[k].update(sub, state[k],
                                                     p_parts.get(k))
            updates.update(upd)
        return {n: updates[n] for n in grads}, new_state

    return Transform(init, update)
