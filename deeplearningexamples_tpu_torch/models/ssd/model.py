"""SSD300 detector.

Port of ``deeplearningexamples_tpu/models/ssd/model.py`` (reference
``PyTorch/Detection/SSD/ssd/model.py``): ResNet-50 truncated after layer3,
whose first block has stride 1 (so a 300x300 input gives a 38x38 map, :20-48),
five extra feature blocks (:55-85) and 3x3 loc/conf heads over the anchor
counts [4, 6, 6, 6, 4, 4] (:87-102). ``forward`` returns fp32 loc (B, 8732,
4) and conf (B, 8732, num_classes).

The parameter and buffer names are the reference's ``state_dict`` names
(``feature_extractor.feature_extractor.{0,1,4,5,6}`` for conv1, bn1 and
layers 1-3; ``additional_blocks.{i}.{0,1,3,4}``; ``loc.{i}``, ``conf.{i}``),
the ones JAX's ``utils/torch_import.convert_ssd300`` reads. So the heads
keep the reference's channel layout: channel ``k * A + a`` holds coordinate
(or class) ``k`` of anchor ``a``, where JAX's kernels hold it at ``a * 4 +
k``; both give anchor ``a * H * W + h * W + w`` of a level. Activations are
``channels_last``; the reshapes of the head outputs are this model's only
copies. Under bf16 the convolutions and BN outputs are bf16, the
parameters, BN statistics and outputs fp32 (float64 in a float64 model).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..convnets.layers import BatchNorm2d, Conv2d, init_weights_
from ..convnets.resnet import Bottleneck, ResNetArch

__all__ = ["ANCHORS_PER_LOC", "SSD300", "SSDResNetBackbone"]

ANCHORS_PER_LOC = (4, 6, 6, 6, 4, 4)
EXTRA_CHANNELS = (1024, 512, 512, 256, 256, 256)
EXTRA_MID = (256, 256, 128, 128, 128)


class SSDResNetBackbone(nn.Module):
    """ResNet-50's conv1, bn1, max pool and layers 1-3, layer3's first block
    at stride 1 (it still projects 512 to 1024 channels), as the
    reference's ``nn.Sequential`` ``feature_extractor``: (B, 3, 300, 300)
    -> (B, 1024, 38, 38)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        arch = ResNetArch()
        layers, cin = [], 64
        for width, n, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 1)):
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, width, stride if j == 0 else 1,
                                         arch, Conv2d, dtype))
                cin = width * arch.expansion
            layers.append(nn.Sequential(*blocks))
        self.feature_extractor = nn.Sequential(
            Conv2d(3, 64, 7, 2, 3, 1, dtype), BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, 2, 1), *layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feature_extractor(x)


class SSDConv2d(Conv2d):
    """The extra blocks' and heads' convolution: flax's
    ``variance_scaling(1.0, "fan_out", "uniform")`` kernel and, with
    ``bias``, a zero bias added in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride, padding, 1, dtype)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.kernel(), bias, self.stride,
                        self.padding)

    def init_(self, generator: torch.Generator) -> None:
        cout, _, kh, kw = self.weight.shape
        limit = math.sqrt(3.0 / (cout * kh * kw))
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -limit, limit, generator=generator))
        if self.bias is not None:
            self.bias.zero_()


def _extra_block(cin: int, mid: int, cout: int, stride: int, padding: int,
                 dtype: torch.dtype) -> nn.Sequential:
    """1x1 reduce, then a 3x3 at ``stride``: stride 2 pads 1 on each side
    (torch's padding, where XLA's SAME would pad one side), the last two
    blocks none."""
    return nn.Sequential(
        SSDConv2d(cin, mid, 1, dtype=dtype), BatchNorm2d(mid), nn.ReLU(),
        SSDConv2d(mid, cout, 3, stride, padding, dtype=dtype),
        BatchNorm2d(cout), nn.ReLU())


def _bbox_view(y: torch.Tensor, anchors: int) -> torch.Tensor:
    """A head's (B, k * A + a, H, W) output -> (B, A * H * W, k): anchor
    ``a * H * W + h * W + w``, one copy."""
    b = y.shape[0]
    return y.unflatten(1, (-1, anchors)).permute(0, 2, 3, 4, 1).reshape(
        b, -1, y.shape[1] // anchors)


class SSD300(nn.Module):
    """``forward(x)``: x (B, 3, 300, 300) (an NHWC batch permuted) -> (loc
    (B, 8732, 4), conf (B, 8732, num_classes)), both fp32."""

    def __init__(self, num_classes: int = 81,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.feature_extractor = SSDResNetBackbone(dtype)
        strides, paddings = (2, 2, 2, 1, 1), (1, 1, 1, 0, 0)
        self.additional_blocks = nn.ModuleList(
            _extra_block(cin, mid, cout, s, p, dtype)
            for cin, mid, cout, s, p in zip(EXTRA_CHANNELS[:-1], EXTRA_MID,
                                            EXTRA_CHANNELS[1:], strides,
                                            paddings))
        self.loc = nn.ModuleList(
            SSDConv2d(c, na * 4, 3, 1, 1, bias=True, dtype=dtype)
            for c, na in zip(EXTRA_CHANNELS, ANCHORS_PER_LOC))
        self.conf = nn.ModuleList(
            SSDConv2d(c, na * num_classes, 3, 1, 1, bias=True, dtype=dtype)
            for c, na in zip(EXTRA_CHANNELS, ANCHORS_PER_LOC))

    def init_weights_(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        features = [self.feature_extractor(x.to(self.dtype))]
        for block in self.additional_blocks:
            features.append(block(features[-1]))
        locs, confs = [], []
        for f, loc, conf, na in zip(features, self.loc, self.conf,
                                    ANCHORS_PER_LOC):
            locs.append(_bbox_view(loc(f), na))
            confs.append(_bbox_view(conf(f), na))
        out = torch.promote_types(self.dtype, torch.float32)  # fp32, or f64
        return torch.cat(locs, 1).to(out), torch.cat(confs, 1).to(out)
