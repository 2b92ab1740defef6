"""ResNet v1.5 family: ResNet-18/34/50/101, ResNeXt101-32x4d and
SE-ResNeXt101-32x4d.

Port of ``deeplearningexamples_tpu/models/convnets/resnet.py`` (reference
``image_classification/models/resnet.py``). Kept from JAX:

- v1.5: the stride of a bottleneck sits on its 3x3 convolution;
- explicit symmetric padding, the max pool padded with -inf;
- the scale of each residual branch's last BN initialised to zero;
- grouped 3x3 convolutions for ResNeXt (``cardinality``, ``base_width``);
- SE with its squeeze taken as a fp32 mean;
- the global average pool and ``fc`` in fp32;
- ``return_features`` (the four stages' outputs, for a detection backbone).

The parameter and buffer names are the reference's ``state_dict`` names
(``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0`` / ``.1``,
``fc``; ``se.squeeze`` / ``se.expand`` for SE), so JAX's
``utils/torch_import.convert_resnet50`` reads the port's weights as they are.
Activations are ``channels_last`` all the way; under bf16 the convolutions
and BN outputs are bf16, the parameters and BN statistics fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d, Dense, SqueezeExcite, init_weights_
from .quant import QATConv

__all__ = ["ARCHS", "BasicBlock", "Bottleneck", "ResNet", "ResNetArch"]


@dataclass(frozen=True)
class ResNetArch:
    """Arch dataclass (reference ``resnet.py:320-405``)."""

    block: str = "bottleneck"  # bottleneck | basic
    layers: tuple[int, ...] = (3, 4, 6, 3)
    widths: tuple[int, ...] = (64, 128, 256, 512)
    expansion: int = 4
    cardinality: int = 1
    base_width: int = 64
    use_se: bool = False
    se_squeeze: int = 16


ARCHS: dict[str, ResNetArch] = {
    "resnet50": ResNetArch(),
    "resnet18": ResNetArch(block="basic", layers=(2, 2, 2, 2), expansion=1),
    "resnet34": ResNetArch(block="basic", layers=(3, 4, 6, 3), expansion=1),
    "resnet101": ResNetArch(layers=(3, 4, 23, 3)),
    "resnext101-32x4d": ResNetArch(layers=(3, 4, 23, 3), cardinality=32,
                                   base_width=4),
    "se-resnext101-32x4d": ResNetArch(layers=(3, 4, 23, 3), cardinality=32,
                                      base_width=4, use_se=True),
}


class _Block(nn.Module):
    """The residual sum, its projection and SE, shared by both blocks."""

    def _tail(self, cin: int, out: int, stride: int, arch: ResNetArch, conv,
              dtype: torch.dtype) -> None:
        self.se = SqueezeExcite(out, out // arch.se_squeeze, F.relu, dtype) \
            if arch.use_se else None
        self.downsample = nn.Sequential(conv(cin, out, 1, stride, 0, 1, dtype),
                                        BatchNorm2d(out)) \
            if stride != 1 or cin != out else None

    def _join(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(_Block):
    def __init__(self, cin: int, width: int, stride: int, arch: ResNetArch,
                 conv, dtype: torch.dtype):
        super().__init__()
        d = int(width * (arch.base_width / 64.0)) * arch.cardinality
        out = width * arch.expansion
        self.conv1 = conv(cin, d, 1, 1, 0, 1, dtype)
        self.bn1 = BatchNorm2d(d)
        self.conv2 = conv(d, d, 3, stride, 1, arch.cardinality, dtype)
        self.bn2 = BatchNorm2d(d)
        self.conv3 = conv(d, out, 1, 1, 0, 1, dtype)
        self.bn3 = BatchNorm2d(out, zero_init=True)
        self._tail(cin, out, stride, arch, conv, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return self._join(x, self.bn3(self.conv3(y)))


class BasicBlock(_Block):
    def __init__(self, cin: int, width: int, stride: int, arch: ResNetArch,
                 conv, dtype: torch.dtype):
        super().__init__()
        out = width * arch.expansion
        self.conv1 = conv(cin, width, 3, stride, 1, 1, dtype)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = conv(width, out, 3, 1, 1, 1, dtype)
        self.bn2 = BatchNorm2d(out, zero_init=True)
        self._tail(cin, out, stride, arch, conv, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return self._join(x, self.bn2(self.conv2(y)))


class ResNet(nn.Module):
    """``forward(x)``: x (B, 3, H, W) (an NHWC batch permuted) -> fp32
    logits (B, num_classes); with ``return_features`` the four stages'
    outputs instead. ``num_classes=0`` builds no ``fc`` (a detection
    backbone: JAX's ResNet creates its ``fc`` only when it reaches it)."""

    def __init__(self, arch: ResNetArch = ResNetArch(), num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, quantized: bool = False):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        conv = QATConv if quantized else Conv2d
        block = Bottleneck if arch.block == "bottleneck" else BasicBlock
        self.conv1 = conv(3, 64, 7, 2, 3, 1, dtype)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for i, (n, width) in enumerate(zip(arch.layers, arch.widths)):
            blocks = []
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block(cin, width, stride, arch, conv, dtype))
                cin = width * arch.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = Dense(cin, num_classes, torch.float32) if num_classes \
            else None

    def init_weights_(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)  # implicit -inf padding
        features = []
        for i in range(len(self.arch.layers)):
            x = getattr(self, f"layer{i + 1}")(x)
            features.append(x)
        if return_features:
            return features
        return self.fc(x.mean((2, 3), dtype=torch.float32))
