"""Learning-rate policies and plain optimizers of the port.

Port of the pieces of ``deeplearningexamples_tpu/core/optimizers.py`` and of
optax that the ported recipes use:

- ``_warmup`` and the LR policies: ``lr_poly_warmup`` (BERT pretraining),
  ``lr_step_policy``, ``lr_linear_policy``, ``lr_cosine_policy`` and
  ``lr_exponential_policy`` (ConvNets). JAX evaluates them in fp32 on an
  int32 step; so does this port, in numpy fp32 on the host, and returns the
  fp32 value as a Python float.
- ``sgd``: without momentum ``optax.sgd(lr)`` (DLRM's dual optimizer, with
  ``adam`` and ``partition``, ``optax.multi_transform``); with momentum,
  nesterov and weight decay JAX's ConvNets ``sgd`` (``add_decayed_weights``
  under ``no_decay_mask``, then ``trace``, then ``-lr(count)``).
- ``bert_adam`` (the reference's ``BertAdam``) and ``adamw``
  (``optax.adamw``), the two optimizers of BERT fine-tuning.
- ``clip_by_global_norm`` and ``chain`` (optax's), which Tacotron2 and
  WaveGlow train under: ``chain(clip_by_global_norm(1.0), adam(lr))``.
- ``rmsprop`` (EfficientNet's RMSprop) and ``dlrm_lr_schedule`` (DLRM's
  warmup and polynomial decay): no command calls them, as in JAX.

Each is a ``Transform`` over a dict name -> tensor; a schedule is read at the
update count before the update, as optax's ``scale_by_schedule``. The
updates run as ``torch._foreach_*`` ops over the whole parameter list, so a
step launches the same few kernels however many tensors the model has (JAX
has no kernel here either: XLA fuses the update).
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..ops.lamb import Transform, global_norm, norms

__all__ = ["AdamState", "RmspropState", "SgdState", "adam", "adamw",
           "bert_adam", "chain", "clip_by_global_norm", "dlrm_lr_schedule",
           "lr_cosine_policy", "lr_exponential_policy", "lr_linear_policy",
           "lr_poly_warmup", "lr_step_policy", "no_decay_mask", "partition",
           "rmsprop", "sgd"]

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


def dlrm_lr_schedule(base_lr: float, warmup_steps: int, warmup_factor: float,
                     decay_start_step: int, decay_steps: int,
                     decay_power: float = 2.0, end_lr_factor: float = 0.0
                     ) -> Callable[[int], float]:
    """DLRM polynomial decay with stepped warmup (reference
    ``dlrm/scripts/utils.py`` ``LearningRateScheduler``; JAX
    ``dlrm_lr_schedule``): ``base_lr * (step + 1) / warmup_steps`` during
    warmup, ``base_lr`` until ``decay_start_step``, then ``base_lr *
    max((1 - frac) ** decay_power, end_lr_factor)`` over ``decay_steps``.
    ``warmup_factor`` is taken and unused, as in JAX."""

    def sched(step: int) -> float:
        warm = (_F(base_lr) * (_F(step + 1) / _F(max(warmup_steps, 1)))
                if warmup_steps else _F(base_lr))
        frac = _F(step - decay_start_step) / _F(max(decay_steps, 1))
        frac = min(max(frac, _F(0.0)), _F(1.0))
        decayed = _F(base_lr) * max((_F(1.0) - frac) ** _F(decay_power),
                                    _F(end_lr_factor))
        if step >= decay_start_step:
            return float(decayed)
        return float(warm if step < warmup_steps else _F(base_lr))

    return sched


def _after_warmup(base_lr: float, step: int, warmup_steps: int,
                  lr: np.float32) -> float:
    return float(_warmup(base_lr, step, warmup_steps) if step < warmup_steps
                 else lr)


def lr_step_policy(base_lr: float, steps: list[int], decay_factor: float,
                   warmup_epochs: int, steps_per_epoch: int
                   ) -> Callable[[int], float]:
    """Decay by ``decay_factor`` at each epoch of ``steps`` (reference
    ``optimizers.py:94-105``), after a linear warmup."""
    boundaries = [s * steps_per_epoch for s in steps]
    warmup_steps = warmup_epochs * steps_per_epoch

    def sched(step: int) -> float:
        n = sum(step >= b for b in boundaries)
        return _after_warmup(base_lr, step, warmup_steps,
                             _F(base_lr) * _F(decay_factor) ** _F(n))

    return sched


def _frac(step: int, warmup_steps: int, total: int) -> np.float32:
    return _F(step - warmup_steps) / _F(max(total - warmup_steps, 1))


def lr_linear_policy(base_lr: float, warmup_epochs: int, epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Linear decay to 0 at the last step, after a linear warmup."""
    warmup_steps = warmup_epochs * steps_per_epoch
    total = epochs * steps_per_epoch

    def sched(step: int) -> float:
        frac = _frac(step, warmup_steps, total)
        lr = _F(base_lr) * np.clip(_F(1.0) - frac, _F(0.0), _F(1.0))
        return _after_warmup(base_lr, step, warmup_steps, lr)

    return sched


def lr_cosine_policy(base_lr: float, warmup_epochs: int, epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Cosine anneal from ``base_lr`` to 0 after a linear warmup (reference
    ``optimizers.py:120-130``)."""
    warmup_steps = warmup_epochs * steps_per_epoch
    total = epochs * steps_per_epoch

    def sched(step: int) -> float:
        frac = np.clip(_frac(step, warmup_steps, total), _F(0.0), _F(1.0))
        lr = _F(base_lr) * _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * frac))
        return _after_warmup(base_lr, step, warmup_steps, lr)

    return sched


def lr_exponential_policy(base_lr: float, warmup_epochs: int, epochs: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """Decay once an epoch after a linear warmup, by the factor that reaches
    0.001 of ``base_lr`` at the last epoch (reference
    ``optimizers.py:133-154`` at its defaults)."""
    warmup_steps = warmup_epochs * steps_per_epoch
    decay_factor = float(np.exp(np.log(0.001)
                                / max(epochs - warmup_epochs, 1)))

    def sched(step: int) -> float:
        e = (step - warmup_steps) // steps_per_epoch
        lr = _F(base_lr) * _F(decay_factor) ** _F(max(e, 0))
        return _after_warmup(base_lr, step, warmup_steps, lr)

    return sched


def no_decay_mask(params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """Name -> True where weight decay applies: not on 1-D tensors (biases,
    norm scales) nor on a name holding batchnorm, layernorm, groupnorm or
    embedding (any case)."""
    skip = ("batchnorm", "layernorm", "groupnorm", "embedding")
    return {n: p.dim() > 1 and not any(s in n.lower() for s in skip)
            for n, p in params.items()}


def _lr(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


class SgdState(NamedTuple):
    count: int
    trace: dict[str, torch.Tensor]


def sgd(learning_rate: LearningRate, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False,
        mask: Mapping[str, bool] | None = None) -> Transform:
    """SGD as JAX builds it. Without momentum ``optax.sgd(lr)``: updates
    ``-lr * g``, the state the update count. With momentum, JAX's ConvNets
    ``sgd``: ``g + weight_decay * p`` where ``mask`` (name -> bool, every
    tensor without one) says so, then ``optax.trace``'s buffer ``t = g +
    momentum * t`` (zeros at first, so the first is ``g``), the update ``t``,
    or ``g + momentum * t`` with nesterov, times ``-lr(count)``; the state
    is ``SgdState``, its buffers updated in place."""

    def init(params: Mapping[str, torch.Tensor]):
        if not momentum:
            return 0
        return SgdState(0, {n: torch.zeros_like(p) for n, p in params.items()})

    def update(grads, state, params=None):
        count = state.count if momentum else state
        names = list(grads)
        if not names:
            return {}, (state._replace(count=count + 1) if momentum
                        else count + 1)
        g = [grads[n] for n in names]
        if weight_decay:
            g = [gi + params[n] * weight_decay
                 if mask is None or mask[n] else gi
                 for gi, n in zip(g, names)]
        if momentum:
            t = [state.trace[n] for n in names]
            torch._foreach_mul_(t, momentum)
            torch._foreach_add_(t, g)
            g = torch._foreach_add(g, torch._foreach_mul(t, momentum)) \
                if nesterov else t
        upd = torch._foreach_mul(g, -_lr(learning_rate, count))
        return dict(zip(names, upd)), (SgdState(count + 1, state.trace)
                                       if momentum else count + 1)

    return Transform(init, update)


class RmspropState(NamedTuple):
    count: int
    nu: dict[str, torch.Tensor]
    trace: dict[str, torch.Tensor] | None


def rmsprop(learning_rate: LearningRate, alpha: float = 0.9,
            momentum: float = 0.9, eps: float = 1e-3, weight_decay: float = 0.0,
            mask: Mapping[str, bool] | None = None) -> Transform:
    """RMSprop as EfficientNet uses it (reference ``optimizers.py:69-90``;
    JAX ``rmsprop``): ``g + weight_decay * p`` where ``mask`` (name -> bool,
    every tensor without one) says so, then optax's ``scale_by_rms`` with eps
    outside the square root (``torch.optim.RMSprop``'s placement): ``nu =
    (1 - alpha) * g^2 + alpha * nu`` (zeros at first), ``g / (sqrt(nu) +
    eps)``; then ``optax.trace``'s ``t = u + momentum * t``; times
    ``-lr(count)``. The state's tensors are updated in place."""

    def init(params: Mapping[str, torch.Tensor]) -> RmspropState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return RmspropState(0, zeros(), zeros() if momentum else None)

    def update(grads, state: RmspropState, params=None):
        names = list(grads)
        if not names:
            return {}, state._replace(count=state.count + 1)
        g = [grads[n] for n in names]
        if weight_decay:
            g = [gi + params[n] * weight_decay
                 if mask is None or mask[n] else gi
                 for gi, n in zip(g, names)]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(nu, alpha)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - alpha))
        scaling = torch._foreach_reciprocal(
            torch._foreach_add(torch._foreach_sqrt(nu), eps))
        u = torch._foreach_mul(scaling, g)
        if momentum:
            t = [state.trace[n] for n in names]
            torch._foreach_mul_(t, momentum)
            torch._foreach_add_(t, u)
            u = t
        upd = torch._foreach_mul(u, -_lr(learning_rate, state.count))
        return dict(zip(names, upd)), state._replace(count=state.count + 1)

    return Transform(init, update)


class AdamState(NamedTuple):
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def _adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    """Count 0 and fp32 moments of zeros, one pair per tensor."""
    return AdamState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                     {n: torch.zeros_like(p) for n, p in params.items()})


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam``: fp32 moments, bias-corrected, ``-lr * m_hat /
    (sqrt(v_hat) + eps)``."""
    return adamw(learning_rate, b1, b2, eps, weight_decay=0.0)


def adamw(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Transform:
    """``optax.adamw`` without a mask: ``optax.adam``'s step plus
    ``weight_decay * p`` on every parameter (LayerNorm and biases too), both
    scaled by the scheduled ``-lr``. The moments are updated in place."""

    def update(grads, state: AdamState, params=None):
        names = list(grads)
        if not names:
            return {}, state._replace(count=state.count + 1)
        g = [grads[n] for n in names]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        # mu * b1 + g * (1 - b1), nu * b2 + g^2 * (1 - b2), as optax rounds
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        count = state.count + 1
        c1 = float(_F(1) - _F(b1) ** _F(count))
        c2 = float(_F(1) - _F(b2) ** _F(count))
        u = torch._foreach_div(
            torch._foreach_div(mu, c1),
            torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), eps))
        if weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(
                [params[n] for n in names], weight_decay))
        upd = torch._foreach_mul(u, -_lr(learning_rate, state.count))
        return dict(zip(names, upd)), state._replace(count=count)

    return Transform(_adam_init, update)


_BERT_SCHEDULES = ("warmup_linear", "warmup_constant", "warmup_poly",
                   "warmup_cosine")


def _bert_schedule_mult(schedule: str, warmup: float, x: np.float32) -> np.float32:
    """``BertAdam``'s schedules at the fraction ``x`` of ``t_total``, in
    fp32 as JAX evaluates them."""
    if schedule == "warmup_linear":
        w = max((x - _F(1.0)) / _F(warmup - 1.0), _F(0.0))
    elif schedule == "warmup_constant":
        w = _F(1.0)
    elif schedule == "warmup_poly":
        w = (_F(1.0) - x) ** _F(0.5)
    else:  # warmup_cosine
        w = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * x))
    return x / _F(warmup) if x < _F(warmup) else _F(w)


def bert_adam(lr: float, warmup: float = -1.0, t_total: int = -1,
              schedule: str = "warmup_linear", b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.01,
              max_grad_norm: float = 1.0,
              mask: Mapping[str, bool] | None = None) -> Transform:
    """``BertAdam`` (reference ``BERT/optimization.py:64-176``; JAX
    ``core/optimizers.py`` ``bert_adam``) with its quirks:

    - no bias correction: ``u = m / (sqrt(v) + eps)``;
    - each tensor's gradient clipped on its own norm, as ``clip_grad_norm_``
      inside the parameter loop: ``g * min(max_grad_norm / (|g| + 1e-6),
      1)``;
    - decoupled weight decay ``u + weight_decay * p`` where ``mask`` (name ->
      bool) is true, on every tensor without a mask;
    - the schedule read at the count before the increment, so under
      ``warmup_linear`` the first update is exactly zero.

    The per-tensor clip factors are copied to the host once a step (one
    sync), because a foreach op takes per-tensor factors only as numbers."""
    if schedule not in _BERT_SCHEDULES:
        raise ValueError(f"unknown schedule {schedule}")

    def update(grads, state: AdamState, params):
        names = list(grads)
        g = [grads[n].float() for n in names]
        if max_grad_norm > 0:
            coef = max_grad_norm / (torch.stack(norms(g)) + 1e-6)
            g = torch._foreach_mul(g, coef.clamp(max=1.0).tolist())
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        # b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g, as JAX rounds
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        u = torch._foreach_div(mu, torch._foreach_add(torch._foreach_sqrt(nu), eps))
        if weight_decay > 0:
            dec = [i for i, n in enumerate(names) if mask is None or mask[n]]
            if dec:
                torch._foreach_add_([u[i] for i in dec], torch._foreach_mul(
                    [params[names[i]].float() for i in dec], weight_decay))
        lr_t = _F(lr)
        if t_total != -1:
            lr_t = lr_t * _bert_schedule_mult(
                schedule, warmup, _F(state.count) / _F(t_total))
        upd = torch._foreach_mul(u, -float(lr_t))
        return ({n: x.to(params[n].dtype) for n, x in zip(names, upd)},
                AdamState(state.count + 1, state.mu, state.nu))

    return Transform(_adam_init, update)


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


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: where the global norm of the updates
    is ``max_norm`` or more, each becomes ``(t / norm) * max_norm``, else
    it passes as it is; no state. The choice is made on the device, without
    a sync."""

    def update(grads, state, params=None):
        names = list(grads)
        if not names:
            return {}, state
        g = [grads[n] for n in names]
        norm = global_norm(g)
        keep = norm < max_norm
        one = torch.ones_like(norm)
        clipped = torch._foreach_mul(
            torch._foreach_div(g, torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, max_norm)))
        return dict(zip(names, clipped)), state

    return Transform(lambda params: (), update)


def chain(*transforms: Transform) -> Transform:
    """``optax.chain``: each transform takes the updates of the one before;
    the state is the tuple of their states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)
