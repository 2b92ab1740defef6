"""Mask-regenerating dropout: the backward redraws the keep mask from a seed.

Port of ``deeplearningexamples_tpu/ops/dropout.py`` (``RegenDropout``,
``regen_dropout``). Autograd would otherwise keep each layer's mask until the
backward; here the only thing saved is an integer seed, and the backward draws
the identical mask again from a generator seeded with it, on the tensor's
device. Semantics are inverted dropout: keep with probability ``1 - rate``,
kept values scaled by ``1 / (1 - rate)`` in fp32 and then cast to the input's
dtype, as in JAX. The bits come from ``torch.Generator`` and cannot match
``jax.random``'s, so parity with JAX is checked by statistics.

Under a data axis (``parallel/mesh.py``) a rank holds rows ``[off, off +
n)`` of the global batch on dim 0, and draws the global batch's mask and
keeps its rows: the mask the one-rank run draws for those rows, at the cost
of drawing the data degree's times the uniforms.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import data_rows

__all__ = ["RegenDropout", "draw_seed", "regen_dropout"]


def draw_seed(generator: torch.Generator) -> int:
    """A fresh 62-bit seed from ``generator`` (a CPU generator, so no device
    sync)."""
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def _keep_scale(seed: int, shape, rate: float, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    off, rows = data_rows(shape[0])
    u = torch.rand((rows, *shape[1:]), generator=gen, device=device)
    if rows != shape[0]:  # this rank's rows of the global draw
        u = u[off:off + shape[0]]
    return torch.where(u >= rate, float(np.float32(1.0) / np.float32(1.0 - rate)),
                       0.0)


class _RegenDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return x * _keep_scale(seed, x.shape, rate, x.device).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        keep = _keep_scale(ctx.seed, g.shape, ctx.rate, g.device).to(g.dtype)
        return g * keep, None, None


def regen_dropout(x: torch.Tensor, rate: float,
                  generator: torch.Generator) -> torch.Tensor:
    """``x`` scaled-masked with keep probability ``1 - rate``; the mask's seed
    is drawn from ``generator``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return _RegenDropout.apply(x, rate, draw_seed(generator))


class RegenDropout(nn.Module):
    """Drop-in for ``nn.Dropout`` whose backward regenerates the mask. It
    drops only when given a generator; ``generator=None`` is the JAX
    ``deterministic=True``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if generator is None or self.rate == 0.0:
            return x
        return regen_dropout(x, self.rate, generator)
