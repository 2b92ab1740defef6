"""Checkpoint manager on ``torch.save``: the whole train state, resumable bit
for bit.

Port of ``deeplearningexamples_tpu/core/checkpoint.py``, which saves the JAX
``TrainState`` with orbax. One file per step, ``ckpt_{step}.pt``, holds the
step, the parameters (a dict of tensors, or the flat buffer), the optimizer
state, the EMA parameters, the model state and the dropout generator's state,
so a resumed run draws the same dropout masks and matches an uninterrupted one
bit for bit. Keep-last-N and best-metric tracking mirror the reference's
``Checkpointer`` (``utils.py:39-80``); metrics live in ``metrics.json``.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import replace
from typing import Any

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_saved(x: Any) -> Any:
    """Tensors to CPU copies, named tuples to tuples, containers recursively."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _to_saved(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_to_saved(v) for v in x]
    return x


def _restore_into(template: Any, saved: Any) -> Any:
    """Copy ``saved`` into the template's tensors in place (so views of a
    flat buffer and references held by the model stay valid); rebuild
    containers and scalars in the template's types."""
    if isinstance(template, torch.Tensor):
        if tuple(template.shape) != tuple(saved.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} != "
                             f"{tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError("checkpoint keys differ from the state's")
        return {k: _restore_into(v, saved[k]) for k, v in template.items()}
    if isinstance(template, tuple):
        vals = [_restore_into(t, s) for t, s in zip(template, saved)]
        return type(template)(*vals) if hasattr(template, "_fields") \
            else tuple(vals)
    if isinstance(template, list):
        return [_restore_into(t, s) for t, s in zip(template, saved)]
    return saved


class CheckpointManager:
    """Keep-last-N checkpoints with best-metric tracking.

    ``save(step, state, metric=...)`` / ``restore(state_template)``.
    """

    def __init__(self, directory: str, keep: int = 3, best_mode: str = "max"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.best_mode = best_mode
        self._metrics_path = os.path.join(self.directory, "metrics.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def _metrics(self) -> dict[str, float]:
        if not os.path.exists(self._metrics_path):
            return {}
        with open(self._metrics_path) as f:
            return json.load(f)

    def save(self, step: int, state: Any, metric: float | None = None) -> None:
        blob = {
            "step": int(state.step),
            "params": _to_saved(state.params),
            "opt_state": _to_saved(state.opt_state),
            "ema_params": _to_saved(state.ema_params),
            "model_state": _to_saved(state.model_state),
            "generator": state.generator.get_state(),
        }
        path = self._path(int(step))
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)  # a reader never sees half a file
        metrics = self._metrics()
        if metric is not None:
            metrics[str(int(step))] = float(metric)
        keep = set(self._steps()[-self.keep:])
        best = self.best_step_of(metrics)
        for s in self._steps():
            if s not in keep and s != best:
                os.remove(self._path(s))
                metrics.pop(str(s), None)
        with open(self._metrics_path, "w") as f:
            json.dump(metrics, f)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def best_step_of(self, metrics: dict[str, float]) -> int | None:
        if not metrics:
            return None
        pick = max if self.best_mode == "max" else min
        return int(pick(metrics, key=lambda s: metrics[s]))

    def best_step(self) -> int | None:
        return self.best_step_of(self._metrics())

    def restore_params(self, params: dict[str, torch.Tensor],
                       step: int | None = None) -> None:
        """Copy only the saved parameters into ``params`` (a dict name ->
        tensor), in place: a fresh optimizer then starts from them."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(self._path(int(step)), map_location="cpu",
                           weights_only=True)["params"]
        if not isinstance(saved, dict):
            raise ValueError(f"{self._path(int(step))} holds a flat buffer; "
                             "its parameters come back only with --flat-lamb "
                             "and --resume")
        _restore_into(params, saved)

    def restore(self, state_template: Any, step: int | None = None) -> Any:
        """Restore into the tensors of ``state_template`` (in place) and
        return the state with the saved step, optimizer state and
        generator."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        blob = torch.load(self._path(int(step)), map_location="cpu",
                          weights_only=True)
        generator = state_template.generator
        generator.set_state(blob["generator"])
        return replace(
            state_template,
            step=blob["step"],
            params=_restore_into(state_template.params, blob["params"]),
            opt_state=_restore_into(state_template.opt_state, blob["opt_state"]),
            ema_params=_restore_into(state_template.ema_params, blob["ema_params"]),
            model_state=_restore_into(state_template.model_state,
                                      blob["model_state"]),
            generator=generator,
        )
