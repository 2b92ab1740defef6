"""TrainState and the train/eval step factories: the harness core.

Port of ``deeplearningexamples_tpu/core/train.py``. JAX keeps an immutable
state and a jitted step; PyTorch runs eagerly, so here the state holds the
model (whose parameters the optimizer updates in place), the optimizer state
and a CPU ``torch.Generator`` for dropout, and the step is a plain function.
The semantics are JAX's:

- bf16 forward/backward with fp32 parameters, no loss scaling;
- ``accum_steps`` splits the batch into microbatches (a remainder raises),
  sums their gradients in fp32 and divides by ``accum_steps``; metrics are
  the microbatches' means;
- ``grad_norm`` is the global norm of those (unclipped) gradients;
- EMA of the parameters every ``ema_steps`` steps;
- a transform with ``returns_new_params`` (the flat fused LAMB) has already
  written the new parameters, so no update is added.

The loss function contract::

    loss_fn(model, model_state, batch, generator) -> (loss, (model_state, metrics))

``params`` in the state is what the optimizer sees: a dict name -> parameter
of the model, or the flat buffer its parameters are views of
(``core/flat.py``). Each has its gradient in ``.grad``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping

import torch
from torch import nn

from ..ops.lamb import Transform, global_norm

__all__ = ["TrainState", "create_train_state", "make_eval_step",
           "make_train_step"]

Params = dict[str, torch.Tensor] | torch.Tensor


@dataclass
class TrainState:
    step: int
    model: nn.Module
    params: Params
    opt_state: Any
    ema_params: Params | None  # None when EMA is off
    generator: torch.Generator  # CPU; dropout seeds are drawn from it
    model_state: dict = field(default_factory=dict)


def _leaves(params: Params) -> list[torch.Tensor]:
    return [params] if isinstance(params, torch.Tensor) else list(params.values())


def create_train_state(model: nn.Module, tx: Transform, seed: int,
                       params: Params | None = None, model_state=None,
                       ema: bool = False) -> TrainState:
    """``params`` defaults to the model's named parameters; pass the flat
    buffer from ``flatten_train`` for the flat path."""
    if params is None:
        params = dict(model.named_parameters())
    ema_params = None
    if ema:
        ema_params = (params.detach().clone() if isinstance(params, torch.Tensor)
                      else {n: p.detach().clone() for n, p in params.items()})
    return TrainState(0, model, params, tx.init(params), ema_params,
                      torch.Generator().manual_seed(seed), model_state or {})


def _split_microbatches(batch: Mapping[str, torch.Tensor], n: int) -> list[dict]:
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} of {k!r} not divisible by "
                             f"accum_steps={n}")
    return [{k: x.chunk(n)[i] for k, x in batch.items()} for i in range(n)]


def _zero_grads(params: Params) -> None:
    if isinstance(params, torch.Tensor):
        params.grad.zero_()  # the parameters' grads are views of it
    else:
        for p in params.values():
            p.grad = None


def _grads(params: Params) -> Params:
    if isinstance(params, torch.Tensor):
        return params.grad
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}


def make_train_step(
    loss_fn: Callable,
    tx: Transform,
    *,
    accum_steps: int = 1,
    ema_decay: float | None = None,
    ema_steps: int = 1,
) -> Callable[[TrainState, Mapping], tuple[TrainState, dict]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics are 0-d
    tensors on the device, read by the caller when it needs them."""

    def train_step(state: TrainState, batch: Mapping) -> tuple[TrainState, dict]:
        params = state.params
        _zero_grads(params)
        micro = _split_microbatches(batch, accum_steps) if accum_steps > 1 \
            else [batch]
        model_state, per_micro = state.model_state, []
        for mb in micro:
            loss, (model_state, metrics) = loss_fn(
                state.model, model_state, mb, state.generator)
            loss.backward()
            per_micro.append({**{k: v.detach() for k, v in metrics.items()},
                              "loss": loss.detach()})
        metrics = {k: torch.stack([m[k].detach().float() for m in per_micro]).mean()
                   for k in per_micro[0]} if accum_steps > 1 else per_micro[0]
        with torch.no_grad():
            grads = _grads(params)
            if accum_steps > 1:
                torch._foreach_div_(_leaves(grads), float(accum_steps))
            grad_norm = global_norm(_leaves(grads))
            updates, opt_state = tx.update(grads, state.opt_state, params)
            if not tx.returns_new_params:
                torch._foreach_add_(_leaves(params),
                                    [updates[n] for n in params])
            ema = state.ema_params
            if ema_decay is not None and ema is not None \
                    and state.step % ema_steps == 0:
                # e * d + p * (1 - d); a step without an update leaves e as is
                torch._foreach_mul_(_leaves(ema), ema_decay)
                torch._foreach_add_(_leaves(ema), torch._foreach_mul(
                    _leaves(params), 1.0 - ema_decay))
        metrics = {**metrics, "grad_norm": grad_norm}
        return replace(state, step=state.step + 1, opt_state=opt_state,
                       model_state=model_state), metrics

    return train_step


def make_eval_step(metric_fn: Callable) -> Callable:
    """``metric_fn(model, model_state, batch) -> metrics`` without gradients."""

    @torch.no_grad()
    def eval_step(model, model_state, batch):
        return metric_fn(model, model_state, batch)

    return eval_step
