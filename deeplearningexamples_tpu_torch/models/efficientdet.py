"""Port of ``deeplearningexamples_tpu/models/efficientdet.py``: EfficientDet,
the BiFPN detector over the EfficientNet backbone (D0 by default).

The reference (``PyTorch/Detection/Efficientdet/effdet/``): EfficientNet
feature taps, the BiFPN with fast-normalized weighted fusion (``bifpn.py``),
separable-conv class and box heads shared across levels (``HeadNet``),
per-level anchors (``anchors.py``: 3 octave scales x 3 aspect ratios), the
focal classification loss and a Huber box loss on matched anchors
(``loss.py``), and NMS for inference (``ops/detection.py`` replaces
``csrc/nms``). Kept from JAX:

- the backbone is the port's ``EfficientNet`` with ``features_only`` (p3,
  p4, p5; its BN momentum 0.9, stochastic depth from the step's generator);
  P6 = 1x1 conv + BN + max-pool of P5, P7 = max-pool of P6;
- every other BN has flax's momentum 0.99 (torch's 0.01) and eps 1e-3;
- the BiFPN's fusion weights are ReLU'd and normalized with ``+ 1e-4``
  (``model.py:162-165``), the weighted sum in fp32; max-pools are 3x3 at
  stride 2 padded by 1 with -inf; upsampling is nearest;
- the convolutions of the BiFPN and the heads take flax's default
  initialiser (lecun normal, truncated), zero biases;
- static shapes: matching pads to ``max_gt`` boxes per image, NMS returns a
  fixed top ``max_out``.

The module names are JAX's (``resample_p6``, ``bifpn_{d}.node{n}_...``,
``class_net``, ``box_net``; the backbone's are the port's EfficientNet's);
``utils.jax_bridge.efficientdet_state_dict_from_jax`` carries JAX's
parameters over. Outputs are NCHW inside, flattened per level as JAX's NHWC
(location-major, then anchor, then class).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.detection import batched_nms, box_iou, match_proposals
from ..parallel.mesh import data_mean
from .convnets.efficientnet import EFFNET_ARCHS, EfficientNet
from .convnets.layers import _TRUNC_STD, BatchNorm2d, Conv2d, init_weights_

__all__ = ["EfficientDet", "EfficientDetConfig", "EfficientDetTask",
           "efficientdet_anchors"]

EPS = 1e-3
MOMENTUM = 0.99  # flax's: running = 0.99 running + 0.01 batch


@dataclass(frozen=True)
class EfficientDetConfig:
    backbone: str = "efficientnet-b0"
    image_size: int = 512
    num_classes: int = 90
    fpn_width: int = 64
    fpn_depth: int = 3
    head_depth: int = 3
    num_scales: int = 3
    aspect_ratios: tuple[tuple[float, float], ...] = (
        (1.0, 1.0), (1.4, 0.7), (0.7, 1.4))
    anchor_scale: float = 4.0
    min_level: int = 3
    max_level: int = 7

    @property
    def num_anchors(self) -> int:
        return self.num_scales * len(self.aspect_ratios)

    @property
    def num_levels(self) -> int:
        return self.max_level - self.min_level + 1


def efficientdet_anchors(cfg: EfficientDetConfig) -> np.ndarray:
    """All anchors, xyxy image coords (reference ``anchors.py:101-170``).
    Aspect "ratios" are (w_mult, h_mult) PAIRS — the published (1.4, 0.7)
    values, not sqrt(2)-derived — applied to the octave-scaled base size."""
    out = []
    for level in range(cfg.min_level, cfg.max_level + 1):
        stride = 2 ** level
        size = cfg.image_size // stride
        for y in range(size):
            for x in range(size):
                cy, cx = (y + 0.5) * stride, (x + 0.5) * stride
                for s in range(cfg.num_scales):
                    base = cfg.anchor_scale * stride * 2 ** (s / cfg.num_scales)
                    for wm, hm in cfg.aspect_ratios:
                        w = base * wm
                        h = base * hm
                        out.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    return np.asarray(out, np.float32)


class _Conv(Conv2d):
    """flax's ``nn.Conv`` at its defaults: "SAME" padding (symmetric for the
    odd kernels at stride 1 used here), lecun normal (truncated) kernel,
    an optional zero bias."""

    def __init__(self, cin: int, cout: int, k: int, groups: int,
                 dtype: torch.dtype, bias: bool = False):
        super().__init__(cin, cout, k, 1, (k - 1) // 2, groups, dtype)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.kernel(), b, 1, self.padding,
                        1, self.groups)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        _, cin, kh, kw = self.weight.shape
        std = math.sqrt(1.0 / (cin * kh * kw)) / _TRUNC_STD
        w = torch.empty(self.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, EPS, momentum=MOMENTUM)


class SeparableConv(nn.Module):
    """SeparableConv2d (reference ``model.py:77-103``): depthwise 3x3 (no
    bias) + pointwise 1x1; d0 sets redundant_bias=False so the pointwise
    bias exists only on the predict layers."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 bias: bool = False):
        super().__init__()
        self.dw = _Conv(cin, cin, 3, cin, dtype)
        self.pw = _Conv(cin, cout, 1, 1, dtype, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class Resample(nn.Module):
    """ResampleFeatureMap (reference ``model.py:106-156``): 1x1 conv (+BN, no
    bias) when channels change, then max-pool or nearest upsampling by the
    reduction ratio (the conv BEFORE the downsample)."""

    def __init__(self, cin: int, cout: int, ratio: float, dtype: torch.dtype):
        super().__init__()
        self.ratio = ratio
        if cin != cout:
            self.conv = _Conv(cin, cout, 1, 1, dtype)
            self.bn = _bn(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            x = self.bn(self.conv(x))
        if self.ratio > 1:
            for _ in range(int(np.log2(self.ratio))):
                x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf
        elif self.ratio < 1:
            f = int(1 / self.ratio)
            x = x.repeat_interleave(f, 2).repeat_interleave(f, 3)
        return x


# bifpn_fa_config nodes (reference config/model_config.py:430-444),
# reductions relative to base_reduction=8; offsets index the growing
# feature list [P3, P4, P5, P6, P7, node0, node1, ...]
_BIFPN_NODES = (
    (64, (3, 4)), (32, (2, 5)), (16, (1, 6)), (8, (0, 7)),
    (16, (1, 7, 8)), (32, (2, 6, 9)), (64, (3, 5, 10)), (128, (4, 11)),
)


class BiFPNLayer(nn.Module):
    """BiFpnLayer (reference ``model.py:213-259``): eight fusion nodes over
    the growing feature list, fast-attention weighting, swish ->
    separable-conv(+BN) after each combine; emits the last five nodes."""

    def __init__(self, width: int, channels: list[int], dtype: torch.dtype):
        super().__init__()
        self.width, self.dtype = width, dtype
        chans = list(channels)
        reds = [8, 16, 32, 64, 128]
        for ni, (target, offsets) in enumerate(_BIFPN_NODES):
            for off in offsets:
                setattr(self, f"node{ni}_resample_{off}", Resample(
                    chans[off], width, target / reds[off], dtype))
            setattr(self, f"node{ni}_weights",
                    nn.Parameter(torch.ones(len(offsets))))
            setattr(self, f"node{ni}_conv", SeparableConv(width, width, dtype))
            setattr(self, f"node{ni}_bn", _bn(width))
            chans.append(width)
            reds.append(target)

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        x = list(feats)
        for ni, (_, offsets) in enumerate(_BIFPN_NODES):
            # the weighted sum in fp32 (float64 in a float64 model)
            nodes = [getattr(self, f"node{ni}_resample_{off}")(x[off])
                     for off in offsets]
            nodes = [n.to(torch.promote_types(n.dtype, torch.float32))
                     for n in nodes]
            w = F.relu(getattr(self, f"node{ni}_weights"))
            fused = sum(wi * n for wi, n in zip(w, nodes)) / (w.sum() + 1e-4)
            y = F.silu(fused.to(self.dtype))
            y = getattr(self, f"node{ni}_bn")(getattr(self, f"node{ni}_conv")(y))
            x.append(y)
        return x[-5:]


class HeadNet(nn.Module):
    """Class/box head (reference ``model.py:322-375``): shared separable
    convs (no bias, no BN inside), per-level BN, swish; biased predict."""

    def __init__(self, out_ch: int, depth: int, width: int, num_levels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.depth, self.num_levels = depth, num_levels
        for i in range(depth):
            setattr(self, f"conv_{i}", SeparableConv(width, width, dtype))
        self.predict = SeparableConv(width, out_ch, dtype, bias=True)
        for lvl in range(num_levels):
            for i in range(depth):
                setattr(self, f"bn_{lvl}_{i}", _bn(width))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for lvl, x in enumerate(feats):
            for i in range(self.depth):
                x = getattr(self, f"conv_{i}")(x)
                x = F.silu(getattr(self, f"bn_{lvl}_{i}")(x))
            outs.append(self.predict(x))
        return outs


class EfficientDet(nn.Module):
    """``forward(images, generator)``: images (B, 3, S, S) -> (cls (B, A,
    num_classes), box (B, A, 4)), fp32. A training forward draws the
    backbone's stochastic depth from ``generator``."""

    def __init__(self, cfg: EfficientDetConfig = EfficientDetConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.backbone = EfficientNet(EFFNET_ARCHS[cfg.backbone], dtype=dtype,
                                     features_only=True)
        w = self.backbone.widths
        chans = [w[2], w[4], w[6], cfg.fpn_width, cfg.fpn_width]
        self.resample_p6 = Resample(chans[2], cfg.fpn_width, 2.0, dtype)
        self.resample_p7 = Resample(cfg.fpn_width, cfg.fpn_width, 2.0, dtype)
        for d in range(cfg.fpn_depth):
            setattr(self, f"bifpn_{d}", BiFPNLayer(cfg.fpn_width, chans, dtype))
            chans = [cfg.fpn_width] * 5
        self.class_net = HeadNet(cfg.num_anchors * cfg.num_classes,
                                 cfg.head_depth, cfg.fpn_width, cfg.num_levels,
                                 dtype)
        self.box_net = HeadNet(cfg.num_anchors * 4, cfg.head_depth,
                               cfg.fpn_width, cfg.num_levels, dtype)

    def init_weights_(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        feats = self.backbone(images, generator)
        x = [feats["p3"], feats["p4"], feats["p5"]]
        p6 = self.resample_p6(x[-1])
        x += [p6, self.resample_p7(p6)]
        for d in range(cfg.fpn_depth):
            x = getattr(self, f"bifpn_{d}")(x)
        b = images.shape[0]

        def flat(outs, k):
            out = torch.cat([o.permute(0, 2, 3, 1).reshape(b, -1, k)
                             for o in outs], 1)
            return out.to(torch.promote_types(out.dtype, torch.float32))

        return (flat(self.class_net(x), cfg.num_classes),
                flat(self.box_net(x), 4))


def _encode_boxes(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Faster-RCNN box encoding (reference anchors.py decode inverse)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-3)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-3)
    gx = gt[..., 0] + gw / 2
    gy = gt[..., 1] + gh / 2
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                        torch.log(gh / ah)], -1)


def _decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(deltas[..., 2].clamp(-8, 8)) * aw
    h = torch.exp(deltas[..., 3].clamp(-8, 8)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@dataclass
class EfficientDetTask:
    """EfficientDet in the train step's contract::

        loss_fn(model, model_state, batch, generator) -> (loss, (model_state,
        {"cls_loss", "box_loss"}))

    A batch holds ``image`` (B, S, S, 3) fp32, ``boxes`` (B, G, 4) xyxy
    pixels, ``labels`` (B, G) int (0-based), ``valid`` (B, G) bool on the
    model's device. ``model_state`` is the dict of BN running statistics (the
    buffers themselves)."""

    cfg: EfficientDetConfig = field(default_factory=EfficientDetConfig)
    dtype: torch.dtype = torch.bfloat16
    max_gt: int = 32  # padded gt boxes per image

    def __post_init__(self):
        self._anchors = torch.from_numpy(efficientdet_anchors(self.cfg))

    def anchors(self, device) -> torch.Tensor:
        if self._anchors.device != torch.device(device):
            self._anchors = self._anchors.to(device)
        return self._anchors

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> EfficientDet:
        """A model with its initialisers drawn on the CPU from ``generator``,
        then placed on ``device``, in training mode."""
        model = EfficientDet(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        return dict(model.named_buffers())

    def targets(self, boxes, labels, valid):
        """Anchor targets of a batch: boxes (B, G, 4), labels (B, G), valid
        (B, G) -> (cls_t (B, A) with -1 for background, box_t (B, A, 4), pos
        (B, A), ignore (B, A))."""
        anchors = self.anchors(boxes.device)
        iou = box_iou(boxes, anchors[None])  # (B, G, A)
        iou = torch.where(valid[..., None], iou, -1.0)
        match = match_proposals(iou, high_threshold=0.5, low_threshold=0.4)
        pos, ignore = match >= 0, match == -2
        safe = match.clamp_min(0).long()
        cls_t = torch.where(pos, labels.gather(1, safe).long(), -1)
        gt = boxes.float().gather(1, safe[..., None].expand(*safe.shape, 4))
        return cls_t, _encode_boxes(anchors, gt), pos, ignore

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        cls, box = model(batch["image"].permute(0, 3, 1, 2), generator)
        cls_t, box_t, pos, ignore = self.targets(
            batch["boxes"], batch["labels"], batch["valid"])
        n_pos = pos.sum().float()  # summed over the data axis by data_mean
        # focal loss over anchors; background = all-zero one-hot
        onehot = F.one_hot(cls_t.clamp_min(0), self.cfg.num_classes).float()
        onehot = onehot * (cls_t >= 0)[..., None]
        p = torch.sigmoid(cls)
        alpha, gamma = 0.25, 1.5
        pt = torch.where(onehot > 0, p, 1 - p)
        a_t = torch.where(onehot > 0, alpha, 1 - alpha)
        bce = -torch.log(pt.clamp_min(1e-8))
        fl = a_t * (1 - pt) ** gamma * bce
        fl = torch.where(ignore[..., None], 0.0, fl)
        cls_loss = data_mean(fl.sum(), n_pos)
        # huber box loss on positives (reference loss.py delta=0.1)
        err = box - box_t
        huber = torch.where(err.abs() < 0.1, 0.5 * err ** 2 / 0.1,
                            err.abs() - 0.05)
        box_loss = data_mean(torch.where(pos[..., None], huber, 0.0).sum(),
                             n_pos)
        loss = cls_loss + 50.0 * box_loss
        return loss, (model_state, {"cls_loss": cls_loss.detach(),
                                    "box_loss": box_loss.detach()})

    @torch.no_grad()
    def predict(self, model: nn.Module, images: torch.Tensor, *,
                max_out: int = 100, score_threshold: float = 0.05,
                iou_threshold: float = 0.5):
        """An eval-mode forward (the model's mode is put back) and per-class
        NMS: images (B, S, S, 3) -> (boxes (B, max_out, 4), scores, labels,
        valid), each image's picks first, padded after."""
        training = model.training
        model.eval()
        try:
            cls, box = model(images.permute(0, 3, 1, 2))
        finally:
            model.train(training)
        anchors = self.anchors(images.device)
        scores = torch.sigmoid(cls)
        best, label = scores.amax(-1), scores.argmax(-1)
        decoded = _decode_boxes(anchors, box)
        # per-class NMS (reference generate_detections runs NMS within each
        # class): offset boxes by class id so co-located objects of
        # different classes never suppress each other
        shifted = decoded + (label.float() * (self.cfg.image_size + 1.0)
                             )[..., None]
        idx, valid = batched_nms(shifted, best, iou_threshold=iou_threshold,
                                 max_out=max_out,
                                 score_threshold=score_threshold)
        safe = idx.clamp_min(0).long()
        return (decoded.gather(1, safe[..., None].expand(*safe.shape, 4)),
                best.gather(1, safe), label.gather(1, safe), valid)
