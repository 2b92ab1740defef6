"""EfficientNet family: B0 and B4, and their widese variants.

Port of ``deeplearningexamples_tpu/models/convnets/efficientnet.py``
(reference ``image_classification/models/efficientnet.py``). Kept from
JAX:

- the compound scaling: widths rounded to 8 (never below 90% of the scaled
  width), depths rounded up;
- ``MBConvBlock``: expand 1x1, depthwise kxk (``groups = mid``, symmetric
  ``(k - 1) // 2`` padding), SE with SiLU (its squeeze width from the
  block's input channels, or from ``mid`` for widese), project 1x1, BN eps
  1e-3;
- stochastic depth on the residual blocks, per sample: block i of n keeps
  its branch with probability ``1 - (1 - survival_prob) * i / (n - 1)``,
  and a kept branch is ``y / p``;
- head dropout, the pool and ``fc`` in fp32.

The names are the reference's ``state_dict`` names (``stem.conv``,
``layers.{stage}.block{j}.expand.conv``, ``.depsep.bn``, ``.se.squeeze``,
``.proj.conv``, ``features.conv``, ``classifier.fc``), which JAX's
``utils/torch_import.convert_efficientnet`` reads.

The random draws of a training forward (stochastic depth and dropout) come
from the step's CPU generator in one draw, copied to the card once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import data_rows
from .layers import BatchNorm2d, Conv2d, Dense, SqueezeExcite, init_weights_
from .quant import QATConv

__all__ = ["EFFNET_ARCHS", "EffNetArch", "EfficientNet", "MBConvBlock"]

EPS = 1e-3


@dataclass(frozen=True)
class EffNetArch:
    width_coeff: float = 1.0
    depth_coeff: float = 1.0
    resolution: int = 224
    dropout: float = 0.2
    survival_prob: float = 0.8  # stochastic depth (reference drop_connect)
    se_ratio: float = 0.25
    widese: bool = False  # widese variants: SE width scales with width_coeff

    # base (B0) stage settings
    kernels: tuple[int, ...] = (3, 3, 5, 3, 5, 5, 3)
    widths: tuple[int, ...] = (16, 24, 40, 80, 112, 192, 320)
    depths: tuple[int, ...] = (1, 2, 2, 3, 3, 4, 1)
    strides: tuple[int, ...] = (1, 2, 2, 2, 1, 2, 1)
    expands: tuple[int, ...] = (1, 6, 6, 6, 6, 6, 6)

    def scaled_width(self, w: int) -> int:
        """Round-to-8 width scaling (reference ``EffNetArch.scale``)."""
        w = w * self.width_coeff
        new_w = max(8, int(w + 4) // 8 * 8)
        if new_w < 0.9 * w:
            new_w += 8
        return new_w

    def scaled_depth(self, d: int) -> int:
        return int(math.ceil(d * self.depth_coeff))


EFFNET_ARCHS = {
    "efficientnet-b0": EffNetArch(),
    "efficientnet-b4": EffNetArch(
        width_coeff=1.4, depth_coeff=1.8, resolution=380, dropout=0.4
    ),
    "efficientnet-widese-b0": EffNetArch(widese=True),
    "efficientnet-widese-b4": EffNetArch(
        width_coeff=1.4, depth_coeff=1.8, resolution=380, dropout=0.4, widese=True
    ),
}


class _ConvBN(nn.Module):
    """``conv`` then ``bn`` (the reference's names), without activation."""

    def __init__(self, conv, cin: int, cout: int, k: int, stride: int,
                 groups: int, dtype: torch.dtype):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, (k - 1) // 2, groups, dtype)
        self.bn = BatchNorm2d(cout, EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class MBConvBlock(nn.Module):
    def __init__(self, arch: EffNetArch, kernel: int, cin: int, cout: int,
                 expand: int, stride: int, survival_prob: float, conv,
                 dtype: torch.dtype):
        super().__init__()
        mid = cin * expand
        self.survival_prob = survival_prob
        self.residual = stride == 1 and cin == cout
        self.expand = _ConvBN(conv, cin, mid, 1, 1, 1, dtype) \
            if expand != 1 else None
        self.depsep = _ConvBN(conv, mid, mid, kernel, stride, mid, dtype)
        self.se = None
        if arch.se_ratio:
            base = mid if arch.widese else cin
            self.se = SqueezeExcite(mid, max(1, int(base * arch.se_ratio)),
                                    F.silu, dtype)
        self.proj = _ConvBN(conv, mid, cout, 1, 1, 1, dtype)

    @property
    def drops(self) -> bool:
        """Whether a training forward draws this block's keep mask."""
        return self.residual and self.survival_prob < 1.0

    def forward(self, x: torch.Tensor, u: torch.Tensor | None = None
                ) -> torch.Tensor:
        """``u``: (B,) uniform draws where ``drops`` in training, else
        None."""
        y = x if self.expand is None else F.silu(self.expand(x))
        y = F.silu(self.depsep(y))
        if self.se is not None:
            y = self.se(y)
        y = self.proj(y)
        if not self.residual:
            return y
        if u is not None:
            keep = (u < self.survival_prob)[:, None, None, None]
            y = torch.where(keep, y / self.survival_prob, 0.0)
        return y + x


class EfficientNet(nn.Module):
    """``forward(x, generator)``: x (B, 3, R, R) -> fp32 logits, or with
    ``features_only`` the taps ``{"p3", "p4", "p5"}`` after stages 2, 4 and
    6 (EfficientDet's backbone; no head is built). A training forward with
    stochastic depth or dropout needs ``generator``."""

    def __init__(self, arch: EffNetArch = EffNetArch(), num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
                 features_only: bool = False):
        super().__init__()
        self.arch, self.dtype, self.features_only = arch, dtype, features_only
        conv = QATConv if quantized else Conv2d
        stem = arch.scaled_width(32)
        self.stem = _ConvBN(conv, 3, stem, 3, 2, 1, dtype)
        total = sum(arch.scaled_depth(d) for d in arch.depths)
        cin, idx = stem, 0
        stages = []
        for k, w, d, st, e in zip(arch.kernels, arch.widths, arch.depths,
                                  arch.strides, arch.expands):
            cout = arch.scaled_width(w)
            blocks = {}
            for j in range(arch.scaled_depth(d)):
                # survival decays linearly over the blocks (reference)
                sp = 1.0 - (1.0 - arch.survival_prob) * idx / max(total - 1, 1)
                blocks[f"block{j}"] = MBConvBlock(
                    arch, k, cin, cout, e, st if j == 0 else 1, sp, conv, dtype)
                cin, idx = cout, idx + 1
            stages.append(nn.ModuleDict(blocks))
        self.layers = nn.ModuleList(stages)
        self.widths = [arch.scaled_width(w) for w in arch.widths]
        if features_only:
            return
        head = arch.scaled_width(1280)
        self.features = _ConvBN(conv, cin, head, 1, 1, 1, dtype)
        self.classifier = nn.ModuleDict({"fc": Dense(head, num_classes,
                                                     torch.float32)})

    def init_weights_(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def _draws(self, generator: torch.Generator | None, b: int, head: int,
               device: torch.device) -> list[torch.Tensor | None]:
        """One uniform draw for the whole forward: (B,) per block that
        drops, then (B, head) for the dropout; None where nothing is
        drawn."""
        blocks = [blk for stage in self.layers for blk in stage.values()]
        off, rows = data_rows(b)  # the global batch's draw, under a data axis
        sizes = [rows if self.training and blk.drops else 0 for blk in blocks]
        sizes.append(rows * head if self.training and self.arch.dropout > 0
                     and not self.features_only else 0)
        if not sum(sizes):
            return [None] * len(sizes)
        if generator is None:
            raise ValueError("a training forward with stochastic depth or "
                             "dropout needs a generator")
        u = torch.rand(sum(sizes), generator=generator)
        if device.type == "cuda":
            u = u.pin_memory()
        u = u.to(device, non_blocking=True)
        return [p.view(rows, -1)[off:off + b].reshape(-1) if n else None
                for p, n in zip(torch.split(u, sizes), sizes)]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        head = 0 if self.features_only else self.features.conv.weight.shape[0]
        draws = self._draws(generator, x.shape[0], head, x.device)
        x = F.silu(self.stem(x.to(self.dtype)))
        i, feats = 0, {}
        for s, stage in enumerate(self.layers):
            for blk in stage.values():
                x = blk(x, draws[i])
                i += 1
            # multi-scale taps for detection FPNs (strides 8, 16, 32)
            if s in (2, 4, 6):
                feats[f"p{3 + (s - 2) // 2}"] = x
        if self.features_only:
            return feats
        x = F.silu(self.features(x))
        x = x.mean((2, 3), dtype=torch.float32)
        if draws[-1] is not None:
            keep_prob = 1.0 - self.arch.dropout
            keep = draws[-1].view(x.shape) < keep_prob
            x = torch.where(keep, x / keep_prob, 0.0)
        return self.classifier["fc"](x)
