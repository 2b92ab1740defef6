"""Learning-rate policies of the port (step -> lr).

Port of the schedules in ``deeplearningexamples_tpu/core/optimizers.py`` that
BERT pretraining uses: ``_warmup`` and ``lr_poly_warmup``. JAX evaluates them
in fp32 on an int32 step; so does this port, in numpy fp32 on the host, and
returns the fp32 value as a Python float.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["lr_poly_warmup"]

_F = np.float32


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
