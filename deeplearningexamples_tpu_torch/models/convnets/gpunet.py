"""Port of ``deeplearningexamples_tpu/models/convnets/gpunet.py``: the GPUNet
family, the NAS-found convnets GPUNet-0, -1 and -2.

The reference (``PyTorch/Classification/GPUNet/models/gpunet_modules.py``:
``Prologue`` :635, ``ConvBnAct`` :200, ``EdgeResidual`` (fused IRB) :481,
``InvertedResidual`` (IRB) :350, ``Epilogue`` :667) builds the net from the
searched layer lists of ``configs/batch1/GV100/{0.65,0.85,1.75}ms.json``;
JAX encodes the three released ones as layer-spec tuples, copied here.
Kept from JAX:

- IRB: 1x1 expand (BN, act), depthwise kxk (BN, act), optional SE (squeeze
  width ``round(mid * 0.25 / expansion)``, ``gpunet_modules.py:409-413``),
  1x1 project (BN, linear); the fused IRB folds expand and depthwise into one
  dense kxk convolution. A residual iff stride 1 and in == out.
- Two paddings: the prologue, ``ConvBnAct`` and the IRB's depthwise
  convolutions pad symmetrically by ``((s - 1) + (k - 1)) // 2``
  (``gpunet_modules.py:37-39``); the fused IRB's expansion pads as TF's
  "SAME" (flax's default), which under stride 2 puts the odd step on the
  right and bottom.
- BN eps 1e-3 and flax's momentum 0.9 (``layers.BatchNorm2d``); the
  prologue's act swish; the epilogue 1x1 -> 1280, BN, ReLU, the pool in fp32,
  dropout 0.2, ``fc`` in fp32.
- QAT: int8 fake-quant on every convolution (``quant.QATConv``), the same
  parameters.

The names follow JAX's (``stem.conv``, ``layers.{i}.{conv,bn,exp,bn1,se,
proj,bn2,pw,dw,bn3,pwl}``, ``head.conv``, ``head.bn``, ``fc``); the bridge is
``utils.jax_bridge.gpunet_state_dict_from_jax``. A training forward's dropout
draws come from the step's CPU generator (``draws``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import data_rows
from .layers import BatchNorm2d, Conv2d, Dense, SqueezeExcite, init_weights_
from .quant import QATConv

__all__ = ["GPUNET_ARCHS", "GPUNet", "GPUNetArch", "Layer"]

EPS = 1e-3
DROPOUT = 0.2
HEAD = 1280


def _make_divisible(v: float, divisor: int = 8) -> int:
    """timm ``make_divisible`` (reference ``gpunet_modules.py:129``)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclass(frozen=True)
class Layer:
    kind: str  # conv | fused_irb | irb
    out: int
    stride: int = 1
    expansion: int = 1
    kernel: int = 3
    act: str = "relu"
    se: bool = False


@dataclass(frozen=True)
class GPUNetArch:
    resolution: int
    stem: int
    layers: tuple[Layer, ...]


# searched layer lists (configs/batch1/GV100/*.json; README model table:
# GPUNet-0 = 0.65ms, GPUNet-1 = 0.85ms, GPUNet-2 = 1.75ms)
GPUNET_ARCHS: dict[str, GPUNetArch] = {
    "gpunet-0": GPUNetArch(320, 32, (
        Layer("conv", 32), Layer("conv", 32),
        Layer("fused_irb", 32, 2, 5, 3, "relu"),
        Layer("fused_irb", 32, 1, 5, 3, "relu"),
        Layer("fused_irb", 64, 2, 5, 3, "relu"),
        Layer("fused_irb", 64, 1, 5, 3, "relu"),
        Layer("fused_irb", 64, 1, 5, 3, "relu"),
        Layer("irb", 256, 2, 5, 3, "swish"),
        Layer("irb", 256, 1, 5, 3, "swish"),
        Layer("irb", 256, 1, 5, 3, "swish"),
        Layer("irb", 704, 2, 5, 3, "relu", True),
        Layer("irb", 704, 1, 5, 3, "relu", True),
    )),
    "gpunet-1": GPUNetArch(288, 24, (
        Layer("conv", 24),
        Layer("fused_irb", 64, 2, 4, 3, "swish"),
        Layer("fused_irb", 64, 1, 4, 3, "swish"),
        Layer("fused_irb", 96, 2, 4, 3, "swish"),
        Layer("fused_irb", 96, 1, 4, 3, "swish"),
        Layer("irb", 160, 2, 2, 3, "swish", True),
        Layer("irb", 288, 1, 5, 3, "relu"),
        Layer("irb", 288, 1, 5, 3, "relu"),
        Layer("irb", 288, 1, 5, 3, "relu"),
        Layer("irb", 288, 1, 5, 3, "relu"),
        Layer("irb", 448, 2, 4, 3, "relu", True),
        Layer("irb", 448, 1, 4, 3, "relu", True),
        Layer("irb", 448, 1, 4, 3, "relu", True),
        Layer("irb", 448, 1, 4, 3, "relu", True),
    )),
    "gpunet-2": GPUNetArch(384, 32, (
        Layer("conv", 32), Layer("conv", 32), Layer("conv", 32),
        Layer("fused_irb", 32, 2, 6, 5, "swish", True),
        Layer("fused_irb", 112, 2, 3, 3, "swish"),
        Layer("fused_irb", 112, 1, 3, 3, "swish"),
        Layer("fused_irb", 112, 1, 3, 3, "swish"),
        *[Layer("irb", 144, 2 if i == 0 else 1, 6, 3, "swish")
          for i in range(6)],
        *[Layer("irb", 160, 1, 3, 5, "relu") for _ in range(4)],
        *[Layer("irb", 224, 2 if i == 0 else 1, 3, 3, "swish", True)
          for i in range(8)],
        *[Layer("irb", 832, 1, 2, 5, "relu") for _ in range(7)],
    )),
}

_ACTS = {"relu": F.relu, "swish": F.silu}


def _tpad(k: int, s: int) -> int:
    """torch's symmetric padding (``gpunet_modules.py:37-39``)."""
    return ((s - 1) + (k - 1)) // 2


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF/flax "SAME" zero padding of an NCHW tensor for a k x k convolution
    at stride s: ceil(n / s) outputs, the odd step of padding after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Block(nn.Module):
    """One entry of the layer list: ``conv`` (ConvBnAct), ``fused_irb`` or
    ``irb``."""

    def __init__(self, layer: Layer, cin: int, conv, dtype: torch.dtype):
        super().__init__()
        self.layer, self.act = layer, _ACTS[layer.act]
        self.residual = layer.kind != "conv" and layer.stride == 1 \
            and cin == layer.out
        k, s = layer.kernel, layer.stride
        mid = _make_divisible(cin * layer.expansion)
        se = (SqueezeExcite(mid, round(mid * 0.25 / layer.expansion), self.act,
                            dtype) if layer.se else None)
        if layer.kind == "conv":
            self.conv = conv(cin, layer.out, k, s, _tpad(k, s), 1, dtype)
            self.bn = BatchNorm2d(layer.out, EPS)
        elif layer.kind == "fused_irb":
            self.exp = conv(cin, mid, k, s, 0, 1, dtype)  # padded "SAME"
            self.bn1 = BatchNorm2d(mid, EPS)
            self.se = se
            self.proj = conv(mid, layer.out, 1, 1, 0, 1, dtype)
            self.bn2 = BatchNorm2d(layer.out, EPS)
        else:
            self.pw = conv(cin, mid, 1, 1, 0, 1, dtype)
            self.bn1 = BatchNorm2d(mid, EPS)
            self.dw = conv(mid, mid, k, s, _tpad(k, s), mid, dtype)
            self.bn2 = BatchNorm2d(mid, EPS)
            self.se = se
            self.pwl = conv(mid, layer.out, 1, 1, 0, 1, dtype)
            self.bn3 = BatchNorm2d(layer.out, EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kind, act = self.layer.kind, self.act
        if kind == "conv":
            return act(self.bn(self.conv(x)))
        if kind == "fused_irb":
            y = act(self.bn1(self.exp(same_pad(x, self.layer.kernel,
                                               self.layer.stride))))
            if self.se is not None:
                y = self.se(y)
            y = self.bn2(self.proj(y))
        else:
            y = act(self.bn1(self.pw(x)))
            y = act(self.bn2(self.dw(y)))
            if self.se is not None:
                y = self.se(y)
            y = self.bn3(self.pwl(y))
        return y + x if self.residual else y


class _ConvBN(nn.Module):
    def __init__(self, conv, cin: int, cout: int, k: int, s: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv = conv(cin, cout, k, s, _tpad(k, s), 1, dtype)
        self.bn = BatchNorm2d(cout, EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class GPUNet(nn.Module):
    """``forward(x, generator)``: x (B, 3, R, R) -> fp32 logits. A training
    forward draws its dropout from ``generator`` (or takes ``u``, (B, 1280)
    uniforms)."""

    def __init__(self, arch: GPUNetArch, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, quantized: bool = False):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        conv = QATConv if quantized else Conv2d
        self.stem = _ConvBN(conv, 3, arch.stem, 3, 2, dtype)
        blocks, cin = [], arch.stem
        for layer in arch.layers:
            blocks.append(_Block(layer, cin, conv, dtype))
            cin = layer.out
        self.layers = nn.ModuleList(blocks)
        self.head = _ConvBN(conv, cin, HEAD, 1, 1, dtype)
        self.fc = Dense(HEAD, num_classes, torch.float32)

    def init_weights_(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def draws(self, generator: torch.Generator | None, b: int,
              device: torch.device) -> torch.Tensor | None:
        """The dropout's (B, 1280) uniforms of a training forward (None in
        eval), drawn on the CPU and copied to ``device`` once."""
        if not self.training:
            return None
        if generator is None:
            raise ValueError("a training forward with dropout needs a "
                             "generator")
        off, rows = data_rows(b)  # this rank's rows of the global draw
        u = torch.rand(rows, HEAD, generator=generator)[off:off + b]
        if device.type == "cuda":
            u = u.pin_memory()
        return u.to(device, non_blocking=True)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                u: torch.Tensor | None = None) -> torch.Tensor:
        if u is None:
            u = self.draws(generator, x.shape[0], x.device)
        x = F.silu(self.stem(x.to(self.dtype)))
        for blk in self.layers:
            x = blk(x)
        x = F.relu(self.head(x))
        x = x.mean((2, 3), dtype=torch.float32)
        if u is not None:
            keep = 1.0 - DROPOUT
            x = torch.where(u < keep, x / keep, 0.0)
        return self.fc(x)
