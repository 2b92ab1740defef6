"""The ConvNets' building blocks with flax's semantics: convolution, dense
layer, BatchNorm and the squeeze-and-excitation block.

Port of the flax layers the JAX models build from (``nn.Conv``,
``nn.Dense``, ``nn.BatchNorm``; ``SqueezeExcite`` of
``deeplearningexamples_tpu/models/convnets/resnet.py:47-67``). The port's
tensors are NCHW with ``channels_last`` memory, which is the JAX package's
NHWC in memory; kernels are OIHW (``in / groups`` for grouped and depthwise
convolutions), dense weights (out, in). Parameters are fp32; a layer casts
its weight to its compute dtype at each call, as flax does.

``BatchNorm2d`` differs from ``nn.BatchNorm2d`` where flax does: the running
statistics take ``momentum * ra + (1 - momentum) * batch`` with
``momentum=0.9`` and the **biased** batch variance (torch's module takes the
unbiased one, n / (n - 1) larger). The batch statistics and the
normalisation come from ``aten.native_batch_norm`` without running buffers
(fp32 statistics for bf16 activations, fp32 parameters, the output in the
activations' dtype); the buffers are then updated from its mean and
``1 / sqrt(var + eps)``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import DATA_AXIS, current_mesh, sum_over_ranks

__all__ = ["BatchNorm2d", "Conv2d", "Dense", "MOMENTUM", "SqueezeExcite",
           "init_weights_"]

# flax's BatchNorm momentum in every ConvNets model: ra = 0.9 ra + 0.1 batch
MOMENTUM = 0.9

# flax's truncated normal: std / this keeps the variance after truncation
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Module):
    """``nn.Conv`` without bias: a (out, in / groups, k, k) fp32 kernel in
    ``channels_last``, symmetric zero padding ``padding``, computed in
    ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = \
            stride, padding, groups, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k)
                                   .contiguous(memory_format=torch.channels_last))

    def kernel(self) -> torch.Tensor:
        return self.weight.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.kernel(), None, self.stride,
                        self.padding, 1, self.groups)

    def init_(self, generator: torch.Generator) -> None:
        """``variance_scaling(2.0, "fan_out", "normal")``: std sqrt(2 /
        (out * k * k))."""
        cout, _, kh, kw = self.weight.shape
        w = torch.empty(self.weight.shape).normal_(
            0.0, math.sqrt(2.0 / (cout * kh * kw)), generator=generator)
        self.weight.copy_(w)


class Dense(nn.Linear):
    """``nn.Dense``: input, weight and bias (``use_bias``) cast to
    ``dtype``; lecun normal (truncated) weight, zero bias."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        w = torch.empty(self.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()


def _global_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float):
    """Training-mode BN over the data axis's global batch: (y in x's
    dtype, mean, biased variance), the statistics in fp32 (float64 for a
    float64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    dims = [0, *range(2, x.dim())]
    c = x.shape[1]
    stats = sum_over_ranks(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]))
    n = x.numel() // c * current_mesh().size(DATA_AXIS)
    mean = stats[:c] / n
    var = (stats[c:] / n - mean * mean).clamp_min(0.0)
    view = (1, c) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + eps) * weight.to(acc)
    y = (xf - mean.view(view)) * scale.view(view) + bias.to(acc).view(view)
    return y.to(x.dtype), mean.detach(), var.detach()


class BatchNorm2d(nn.Module):
    """``nn.BatchNorm(momentum=momentum, epsilon=eps)`` over the channels of
    an NCHW tensor (flax's momentum: torch's is ``1 - momentum``). Training
    normalises with the batch statistics and updates the running ones in
    place; eval normalises with the running ones.
    ``zero_init`` starts the scale at 0 (a residual branch's last BN).

    Under a data axis (``parallel/mesh.py``) the batch statistics are the
    global batch's, as under JAX's SPMD: the fp32 sum, sum of squares and
    count are summed over the data axis (``sum_over_ranks``, whose backward
    sums the cotangents, so the gradients flow through the global
    statistics) and the variance is flax's ``E[x^2] - E[x]^2``."""

    def __init__(self, c: int, eps: float = 1e-5, zero_init: bool = False,
                 momentum: float = MOMENTUM):
        super().__init__()
        self.eps, self.zero_init, self.momentum = eps, zero_init, momentum
        self.weight = nn.Parameter(torch.zeros(c) if zero_init else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if current_mesh().size(DATA_AXIS) > 1:
            y, mean, var = _global_batch_norm(x, self.weight, self.bias,
                                              self.eps)
        else:
            y, mean, invstd = torch.ops.aten.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = invstd.double().pow(-2).sub(self.eps)
                var = var.clamp_min(0.0).float()
        with torch.no_grad():
            m, dt = self.momentum, self.running_mean.dtype
            self.running_mean.mul_(m).add_(mean.to(dt) * (1.0 - m))
            self.running_var.mul_(m).add_(var.to(dt) * (1.0 - m))
        return y

    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class SqueezeExcite(nn.Module):
    """Channel squeeze-and-excitation: ``x * sigmoid(expand(act(squeeze(
    mean(x)))))``, the mean over H, W taken in fp32 and cast to ``dtype``
    (ReLU for SE-ResNeXt, SiLU for EfficientNet)."""

    def __init__(self, c: int, hidden: int, act: Callable, dtype: torch.dtype):
        super().__init__()
        self.act, self.dtype = act, dtype
        self.squeeze = Dense(c, hidden, dtype)
        self.expand = Dense(hidden, c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        s = torch.sigmoid(self.expand(self.act(self.squeeze(s))))
        return x * s[:, :, None, None]


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, drawn from ``generator`` (a CPU generator) in
    the modules' order."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Dense, BatchNorm2d)):
            m.init_(generator)
