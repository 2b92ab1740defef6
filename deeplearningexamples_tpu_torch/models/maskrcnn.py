"""Port of ``deeplearningexamples_tpu/models/maskrcnn.py``: Mask R-CNN, the
ResNet-FPN backbone with the RPN and the ROI box and mask heads.

The reference (``PyTorch/Segmentation/MaskRCNN/pytorch/maskrcnn_benchmark/``)
runs bespoke CUDA kernels (``ROIAlign_cuda.cu``, ``nms.cu``,
``match_proposals.cu``, ``generate_mask_targets.cu``); JAX made each a
static-shape ``jnp`` op, and the port runs them as plain PyTorch
(``ops/detection.py``). Kept from JAX:

- static shapes: a fixed top-k of proposals per level, 512 kept per image,
  fixed positive and negative sample slots with validity masks, the losses
  normalised by the live count; every image of a batch at once where JAX
  ``vmap``s;
- the sampler (``_random_subset``): U(0, 1) noise plus the mask, top-k;
  the uniforms come from ``MaskRCNNTask.draws``, which a test can fill with
  ``jax.random``'s, and the top-k keeps ``lax.top_k``'s order (descending,
  the lower index first among equal values), so the positives fill slots
  ``0..n_pos`` and the mask head reads exactly those;
- the proposals come from detached RPN outputs; the backbone's BN updates
  its statistics in training (JAX's choice, not the reference's frozen BN);
- the box coder's weights: the RPN's 1s, the box head's (10, 10, 5, 5);
- on dead slots the error is zeroed, not the loss (a ``where`` after a NaN
  still back-propagates NaN);
- mask targets: ``roi_align`` of each matched instance's dense grid at
  ``spatial_scale = mg / image_size``, then ``>= 0.5``;
- class-aware NMS in ``predict``: boxes offset by ``label * (image_size +
  1)``.

JAX pools each ROI at all four FPN levels and keeps one by multiplying (a
TPU choice); the port pools each ROI at its own level only, from one table
of the four levels' rows (``roi_align_rows``). The layout is the ConvNets'
(NCHW in ``channels_last`` memory); the module and parameter names are the
reference's ``state_dict`` names (``fpn.fpn_inner{i}``, ``rpn.cls_logits``,
``box_ext.fc6``, ``box_pred.bbox_pred``, ``mask_pred.conv5_mask``, ...), so
JAX's ``utils/torch_import.convert_maskrcnn_heads`` reads the port's heads;
``fc6`` reads the pooled features channel-major, as the reference's does,
and ``conv5_mask`` is a ``ConvTranspose2d`` (JAX's kernel reversed in
space). ``utils.jax_bridge.maskrcnn_state_dict_from_jax`` carries JAX's
variables over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.detection import (batched_nms, box_iou, decode_boxes,
                             encode_boxes, match_proposals, roi_align,
                             roi_align_rows)
from .convnets.layers import Dense, init_weights_
from .convnets.resnet import ARCHS, ResNet
from .efficientdet import _Conv
from ..parallel.mesh import data_mean, draw_rows
from .tts.layers import device_generator, lecun_normal_

__all__ = ["MaskRCNN", "MaskRCNNConfig", "MaskRCNNTask", "ROI_BOX_WEIGHTS",
           "SPANS", "fpn_anchors", "top_k"]

# reference box_coder weights (config defaults): RPN 1s, ROI heads 10/10/5/5
ROI_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
# the training forward's parts, each in a ``record_function`` span
SPANS = ("maskrcnn.backbone", "maskrcnn.rpn_loss", "maskrcnn.proposals",
         "maskrcnn.box_head", "maskrcnn.mask_head")


@dataclass(frozen=True)
class MaskRCNNConfig:
    """JAX's ``MaskRCNNConfig`` (reference ``e2e_mask_rcnn_R_50_FPN_1x``)."""

    backbone: str = "resnet50"
    image_size: int = 800  # square, static (reference pads to divisible)
    num_classes: int = 81  # includes background at index 0 (COCO: 80 + bg)
    fpn_width: int = 256
    # anchors: one size per level P2..P6 (32*2^k), 3 aspect ratios
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_base: float = 32.0
    rpn_pre_nms_top_n: int = 1000  # per level (reference: 2000 train FPN)
    rpn_post_nms_top_n: int = 512  # proposals kept per image
    rpn_nms_thresh: float = 0.7
    rpn_batch_per_image: int = 256
    rpn_pos_fraction: float = 0.5
    roi_batch_per_image: int = 128  # reference 512
    roi_pos_fraction: float = 0.25
    mask_resolution: int = 28
    head_fc_dim: int = 1024

    @property
    def num_anchors(self) -> int:
        return len(self.aspect_ratios)

    @property
    def strides(self) -> tuple[int, ...]:
        return (4, 8, 16, 32, 64)  # P2..P6


def fpn_anchors(cfg: MaskRCNNConfig) -> list[np.ndarray]:
    """Per-level anchors, xyxy image coords (reference anchor_generator.py:
    sizes (32, 64, 128, 256, 512) on strides (4, 8, 16, 32, 64)); each
    level (n * n * A, 4), the anchors fastest within a cell."""
    out = []
    for k, stride in enumerate(cfg.strides):
        size = cfg.anchor_base * 2**k
        n = cfg.image_size // stride
        ctr = (np.arange(n, dtype=np.float32) + 0.5) * stride
        cy, cx = np.meshgrid(ctr, ctr, indexing="ij")
        level = []
        for ar in cfg.aspect_ratios:
            w = size * np.sqrt(1.0 / ar)
            h = size * np.sqrt(ar)
            level.append(np.stack([
                cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1))
        out.append(np.stack(level, axis=2).reshape(-1, 4).astype(np.float32))
    return out


class FPN(nn.Module):
    """Top-down feature pyramid (reference ``backbone/fpn.py``): lateral 1x1
    on C2..C5, nearest-neighbour top-down sum, 3x3 output convolutions, P6 =
    every second row and column of P5 (``LastLevelMaxPool``'s 1x1 pool at
    stride 2)."""

    def __init__(self, channels: list[int], width: int, dtype: torch.dtype):
        super().__init__()
        for i, c in enumerate(channels):
            setattr(self, f"fpn_inner{i + 1}", _Conv(c, width, 1, 1, dtype,
                                                     bias=True))
            setattr(self, f"fpn_layer{i + 1}", _Conv(width, width, 3, 1,
                                                     dtype, bias=True))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        lat = [getattr(self, f"fpn_inner{i + 1}")(x)
               for i, x in enumerate(feats)]
        for i in range(len(lat) - 2, -1, -1):
            # jax.image.resize's nearest: source floor((o + 0.5) * in / out)
            lat[i] = lat[i] + F.interpolate(lat[i + 1], lat[i].shape[-2:],
                                            mode="nearest-exact")
        outs = [getattr(self, f"fpn_layer{i + 1}")(x)
                for i, x in enumerate(lat)]
        return outs + [outs[-1][:, :, ::2, ::2]]  # P2..P6


class RPNHead(nn.Module):
    """Shared RPN head (reference ``rpn.py RPNHead``): 3x3 conv + ReLU, 1x1
    objectness and 1x1 box deltas on every level; per level (B, H*W*A) and
    (B, H*W*A, 4), location-major as JAX's NHWC."""

    def __init__(self, width: int, num_anchors: int, dtype: torch.dtype):
        super().__init__()
        self.conv = _Conv(width, width, 3, 1, dtype, bias=True)
        self.cls_logits = _Conv(width, num_anchors, 1, 1, dtype, bias=True)
        self.bbox_pred = _Conv(width, num_anchors * 4, 1, 1, dtype, bias=True)

    def forward(self, feats: list[torch.Tensor]):
        logits, deltas = [], []
        for x in feats:
            t = F.relu(self.conv(x))
            # fp32 (float64 in a float64 model), where JAX casts to fp32
            b, acc = x.shape[0], torch.promote_types(x.dtype, torch.float32)
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1)
                          .reshape(b, -1).to(acc))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4).to(acc))
        return logits, deltas


class ConvTranspose2x2(nn.Module):
    """flax's ``nn.ConvTranspose(c, (2, 2), strides=(2, 2))`` as the
    reference's ``ConvTranspose2d`` (weight (in, out, 2, 2): JAX's kernel
    reversed in space), with a bias; lecun normal (truncated) over fan in
    ``4 * in``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, 4 * self.weight.shape[0], generator)
        self.bias.zero_()


class MaskRCNN(nn.Module):
    """Backbone + FPN + RPN + ROI heads; the task runs the two stages with
    the proposals between them (``features``, ``rpn``, ``box_head``,
    ``mask_head``)."""

    def __init__(self, cfg: MaskRCNNConfig = MaskRCNNConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        arch = ARCHS[cfg.backbone]
        self.backbone = ResNet(arch, 0, dtype)
        w, k = cfg.fpn_width, cfg.num_classes
        self.fpn = FPN([c * arch.expansion for c in arch.widths], w, dtype)
        self.rpn = RPNHead(w, cfg.num_anchors, dtype)
        self.box_ext = nn.ModuleDict({
            "fc6": Dense(w * 7 * 7, cfg.head_fc_dim, dtype),
            "fc7": Dense(cfg.head_fc_dim, cfg.head_fc_dim, dtype)})
        self.box_pred = nn.ModuleDict({
            "cls_score": Dense(cfg.head_fc_dim, k, torch.float32),
            "bbox_pred": Dense(cfg.head_fc_dim, k * 4, torch.float32)})
        self.mask_ext = nn.ModuleDict({
            f"mask_fcn{i + 1}": _Conv(w if i == 0 else 256, 256, 3, 1, dtype,
                                      bias=True) for i in range(4)})
        self.mask_pred = nn.ModuleDict({
            "conv5_mask": ConvTranspose2x2(256, 256, dtype),
            "mask_fcn_logits": _Conv(256, k, 1, 1, torch.float32, bias=True)})

    def init_weights_(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)
        self.mask_pred["conv5_mask"].init_(generator)

    def features(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images (B, S, S, 3) -> P2..P6 (B, C, H, W); BN on its batch
        statistics in training mode."""
        return self.fpn(self.backbone(images.permute(0, 3, 1, 2),
                                      return_features=True))

    def box_head(self, pooled: torch.Tensor):
        """pooled (R, 7, 7, C) -> (class logits (R, K), deltas (R, K, 4)):
        2 FC + the predictors (reference ``roi_heads/box_head``)."""
        r = pooled.shape[0]
        x = pooled.permute(0, 3, 1, 2).reshape(r, -1)  # channel-major
        x = F.relu(self.box_ext["fc6"](x))
        x = F.relu(self.box_ext["fc7"](x))
        return (self.box_pred["cls_score"](x),
                self.box_pred["bbox_pred"](x).reshape(r, -1, 4))

    def mask_head(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled (R, 14, 14, C) -> mask logits (R, K, 28, 28): 4 convs, the
        2x deconvolution, the per-class 1x1 predictor (reference
        ``roi_heads/mask_head``)."""
        x = pooled.permute(0, 3, 1, 2)  # channels_last NCHW
        for i in range(4):
            x = F.relu(self.mask_ext[f"mask_fcn{i + 1}"](x))
        x = F.relu(self.mask_pred["conv5_mask"](x))
        return self.mask_pred["mask_fcn_logits"](x)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _random_subset(u: torch.Tensor, mask: torch.Tensor, k: int):
    """Up to ``k`` uniformly random True positions of ``mask`` (..., N),
    given U(0, 1) draws ``u`` of its shape: the top k of ``u + mask``
    (static-shape stand-in for the reference's ``randperm`` sampler) ->
    (idx (..., k), ok (..., k))."""
    val, idx = top_k(u + mask.to(u.dtype), k)
    return idx, val >= 1.0


def _smooth_l1(err: torch.Tensor, beta: float) -> torch.Tensor:
    a = err.abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def _roi_level(boxes: torch.Tensor) -> torch.Tensor:
    """FPN level per ROI relative to P2 (reference ``poolers.py
    LevelMapper``): floor(4 + log2(sqrt(area) / 224)) - 2 in [0, 3]."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1.0)
    k = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-8)) - 2
    return k.clamp(0, 3).long()


def _multilevel_roi_align(feats: list[torch.Tensor], boxes: torch.Tensor,
                          output_size: int, strides) -> torch.Tensor:
    """ROIAlign of each ROI at its own level of P2..P5: feats (B, C, H, W)
    each, boxes (B, R, 4) -> (B, R, n, n, C). The levels' rows (NHWC, which
    is their ``channels_last`` memory) form one table."""
    b, c = feats[0].shape[:2]
    dev = boxes.device
    sizes = [f.shape[2] * f.shape[3] for f in feats]
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c) for f in feats])
    start = torch.tensor(np.cumsum([0] + [b * s for s in sizes[:-1]]),
                         device=dev)
    hs = torch.tensor([f.shape[2] for f in feats], device=dev)
    ws = torch.tensor([f.shape[3] for f in feats], device=dev)
    area = torch.tensor(sizes, device=dev)
    scale = torch.tensor([1.0 / s for s in strides[:len(feats)]],
                         dtype=torch.float32, device=dev)
    level = _roi_level(boxes)  # (B, R)
    image = torch.arange(b, device=dev)[:, None]
    base = start[level] + image * area[level]
    return roi_align_rows(table, base, hs[level], ws[level], scale[level],
                          boxes, output_size=output_size)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, JAX's stable form."""
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, K) along dim 1 -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


@dataclass
class MaskRCNNTask:
    """Mask R-CNN in the train step's contract::

        loss_fn(model, model_state, batch, generator) -> (loss, (model_state,
        {"rpn_cls", "rpn_box", "cls_loss", "box_loss", "mask_loss"}))

    A batch holds ``image`` (B, S, S, 3), ``boxes`` (B, G, 4) xyxy pixels,
    ``labels`` (B, G) in [0, K - 1) (background not included: shifted by 1
    inside), ``valid`` (B, G) and ``masks`` (B, G, Mg, Mg), per-instance
    binary grids over the whole image, on the model's device.
    ``model_state`` is the dict of BN running statistics (the buffers
    themselves, which a training forward updates)."""

    cfg: MaskRCNNConfig = field(default_factory=MaskRCNNConfig)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        self._anchors = [torch.from_numpy(a) for a in fpn_anchors(self.cfg)]

    def anchors(self, device) -> list[torch.Tensor]:
        if self._anchors[0].device != torch.device(device):
            self._anchors = [a.to(device) for a in self._anchors]
        return self._anchors

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> MaskRCNN:
        """A model with its initialisers drawn on the CPU from ``generator``,
        then placed on ``device``, in training mode."""
        model = MaskRCNN(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        return dict(model.named_buffers())

    def draws(self, generator: torch.Generator, batch: dict) -> dict:
        """The samplers' U(0, 1) draws, on the batch's device, from
        ``generator``: ``rpn_pos``, ``rpn_neg`` (B, anchors) and
        ``roi_pos``, ``roi_neg`` (B, proposals + G). JAX draws them from
        ``split(rng, 2B + 1)``: image i's RPN key is the i-th, its ROI key
        the (B + i)-th, each split once more into (pos, neg)."""
        dev = batch["image"].device
        gen = device_generator(generator, dev)
        b, g = batch["boxes"].shape[:2]
        a = sum(x.shape[0] for x in self._anchors)
        r = self.cfg.rpn_post_nms_top_n + g
        # under a data axis each at the global batch's rows, of which this
        # rank keeps its own
        return {k: draw_rows(lambda rows, n=n: torch.rand(
                    (rows, n), generator=gen, device=dev), b)
                for k, n in (("rpn_pos", a), ("rpn_neg", a),
                             ("roi_pos", r), ("roi_neg", r))}

    # -- proposals (reference rpn/inference.py) ----------------------------

    def proposals(self, logits: list[torch.Tensor],
                  deltas: list[torch.Tensor]):
        """Per image: each level's top ``rpn_pre_nms_top_n``, decoded and
        clipped, then NMS across the levels: logits (B, HWA) and deltas (B,
        HWA, 4) per level -> (boxes (B, post, 4), valid (B, post))."""
        cfg = self.cfg
        anchors = self.anchors(logits[0].device)
        boxes_all, scores_all = [], []
        for lv in range(len(logits)):
            score, idx = top_k(logits[lv], min(cfg.rpn_pre_nms_top_n,
                                               logits[lv].shape[1]))
            # JAX's gather clamps an index past the level's anchors: where
            # the image size is not a multiple of 64, P6 (every second row
            # of P5) has more cells than its anchors (800: 13 x 13 against
            # 12 x 12)
            a = anchors[lv][idx.clamp_max(anchors[lv].shape[0] - 1)]
            boxes = decode_boxes(a, _take(deltas[lv], idx))
            boxes_all.append(boxes.clamp(0.0, cfg.image_size))
            scores_all.append(score)
        boxes = torch.cat(boxes_all, 1)
        scores = torch.cat(scores_all, 1)
        # drop degenerate boxes (reference remove_small_boxes min_size=0)
        ok = ((boxes[..., 2] - boxes[..., 0]) > 1e-3) & \
             ((boxes[..., 3] - boxes[..., 1]) > 1e-3)
        scores = torch.where(ok, scores, -math.inf)
        idx, valid = batched_nms(boxes, scores,
                                 iou_threshold=cfg.rpn_nms_thresh,
                                 max_out=cfg.rpn_post_nms_top_n)
        return _take(boxes, idx.long().clamp_min(0)), valid

    # -- losses ---------------------------------------------------------------

    def _rpn_loss(self, u: dict, logits, deltas, gt_boxes, gt_valid):
        """Per-image RPN losses (B,) (reference ``rpn/loss.py``)."""
        cfg = self.cfg
        anchors = torch.cat(self.anchors(logits.device))
        iou = box_iou(gt_boxes, anchors[None])  # (B, G, A)
        iou = torch.where(gt_valid[..., None], iou, -1.0)
        match = match_proposals(iou, high_threshold=0.7, low_threshold=0.3,
                                allow_low_quality=True)
        n_pos = int(cfg.rpn_batch_per_image * cfg.rpn_pos_fraction)
        pos_idx, pos_ok = _random_subset(u["rpn_pos"], match >= 0, n_pos)
        neg_idx, neg_ok = _random_subset(u["rpn_neg"], match == -1,
                                         cfg.rpn_batch_per_image - n_pos)
        total = (pos_ok.sum(1) + neg_ok.sum(1)).clamp_min(1).to(logits.dtype)
        obj = F.logsigmoid(_take(logits, pos_idx))
        not_obj = F.logsigmoid(-_take(logits, neg_idx))
        cls_loss = (-torch.where(pos_ok, obj, 0.0).sum(1)
                    - torch.where(neg_ok, not_obj, 0.0).sum(1)) / total
        gt = _take(gt_boxes, _take(match, pos_idx).long().clamp_min(0))
        target = encode_boxes(anchors[pos_idx], gt)
        err = torch.where(pos_ok[..., None],
                          _take(deltas, pos_idx) - target, 0.0)
        return cls_loss, _smooth_l1(err, 1.0 / 9.0).sum((1, 2)) / total

    def _sample_rois(self, u: dict, proposals, prop_valid, gt_boxes,
                     gt_labels, gt_valid):
        """Match and subsample the proposals with the gt boxes appended
        (reference ``box_head/loss.py``, ``add_gt_proposals``): (rois (B,
        R, 4), gt index, class targets (-1: dead slot), box targets,
        is_pos, ok), positives in slots ``0..n_pos``."""
        cfg = self.cfg
        proposals = torch.cat([proposals, gt_boxes.float()], 1)
        prop_valid = torch.cat([prop_valid, gt_valid], 1)
        iou = box_iou(gt_boxes, proposals)
        iou = torch.where(gt_valid[..., None], iou, -1.0)
        iou = torch.where(prop_valid[:, None, :], iou, -1.0)
        match = match_proposals(iou, high_threshold=0.5, low_threshold=0.5,
                                allow_low_quality=False)
        n_pos = int(cfg.roi_batch_per_image * cfg.roi_pos_fraction)
        pos_idx, pos_ok = _random_subset(u["roi_pos"], match >= 0, n_pos)
        neg_idx, neg_ok = _random_subset(u["roi_neg"],
                                         (match == -1) & prop_valid,
                                         cfg.roi_batch_per_image - n_pos)
        idx = torch.cat([pos_idx, neg_idx], 1)
        ok = torch.cat([pos_ok, neg_ok], 1)
        is_pos = torch.cat([pos_ok, torch.zeros_like(neg_ok)], 1)
        gt_i = _take(match, idx).long().clamp_min(0)
        rois = _take(proposals, idx)
        cls_t = torch.where(is_pos, _take(gt_labels, gt_i).long() + 1, 0)
        cls_t = torch.where(ok, cls_t, -1)
        box_t = encode_boxes(rois, _take(gt_boxes, gt_i), ROI_BOX_WEIGHTS)
        return rois, gt_i, cls_t, box_t, is_pos, ok

    def mask_targets(self, masks: torch.Tensor, gt_i: torch.Tensor,
                     rois: torch.Tensor) -> torch.Tensor:
        """Each ROI's crop of its matched instance grid: masks (B, G, mg,
        mg), gt_i (B, P), rois (B, P, 4) -> (B, P, 28, 28) in {0, 1}."""
        mg = masks.shape[-1]
        inst = _take(masks, gt_i).float()[..., None]  # (B, P, mg, mg, 1)
        crop = roi_align(inst, rois[:, :, None], output_size=self.cfg
                         .mask_resolution, spatial_scale=mg / self.cfg
                         .image_size)[:, :, 0, ..., 0]
        return (crop >= 0.5).float()

    def loss_fn(self, model: MaskRCNN, model_state, batch: dict,
                generator: torch.Generator):
        """The five losses; the forward's parts run in ``record_function``
        spans named in ``SPANS``, which the profiling reads."""
        cfg = self.cfg
        span = torch.profiler.record_function
        with span("maskrcnn.backbone"):
            feats = model.features(batch["image"])
            logits, deltas = model.rpn(feats)
        u = self.draws(generator, batch)
        gt_boxes, gt_valid = batch["boxes"].float(), batch["valid"]
        with span("maskrcnn.rpn_loss"):
            rpn_cls, rpn_box = self._rpn_loss(u, torch.cat(logits, 1),
                                              torch.cat(deltas, 1), gt_boxes,
                                              gt_valid)
        # the reference detaches the RPN outputs
        with torch.no_grad(), span("maskrcnn.proposals"):
            prop, prop_valid = self.proposals([x.detach() for x in logits],
                                              [x.detach() for x in deltas])
            rois, gt_i, cls_t, box_t, is_pos, ok = self._sample_rois(
                u, prop, prop_valid, gt_boxes, batch["labels"], gt_valid)
        b, r = rois.shape[:2]
        with span("maskrcnn.box_head"):
            pooled = _multilevel_roi_align(feats[:4], rois, 7, cfg.strides)
            cls_logits, box_deltas = model.box_head(pooled.flatten(0, 1))
            cls_logits = cls_logits.reshape(b, r, -1)
            box_deltas = box_deltas.reshape(b, r, cfg.num_classes, 4)
            live = cls_t >= 0
            # summed over the data axis by data_mean
            n_live = live.sum().to(cls_logits.dtype)
            safe_t = cls_t.clamp_min(0)
            logp = F.log_softmax(cls_logits, -1).gather(2, safe_t[..., None])
            cls_loss = data_mean(-torch.where(live, logp[..., 0], 0.0).sum(),
                                 n_live)
            pred_box = box_deltas.gather(
                2, safe_t[..., None, None].expand(b, r, 1, 4))[:, :, 0]
            # zero the error, not the loss, on dead slots
            err = torch.where(is_pos[..., None], pred_box - box_t, 0.0)
            box_loss = data_mean(_smooth_l1(err, 1.0).sum(), n_live)

        # the mask head on the positive slots 0..n_pos
        with span("maskrcnn.mask_head"):
            n_pos = int(cfg.roi_batch_per_image * cfg.roi_pos_fraction)
            m = cfg.mask_resolution
            mrois, mok = rois[:, :n_pos], is_pos[:, :n_pos]
            mcls = safe_t[:, :n_pos].reshape(-1, 1, 1, 1).expand(-1, 1, m, m)
            pooled14 = _multilevel_roi_align(feats[:4], mrois, 14,
                                             cfg.strides)
            mask_logits = model.mask_head(pooled14.flatten(0, 1)).gather(
                1, mcls).reshape(b, n_pos, m, m)
            with torch.no_grad():
                mask_t = self.mask_targets(batch["masks"], gt_i[:, :n_pos],
                                           mrois)
            bce = _sigmoid_bce(mask_logits, mask_t.to(mask_logits.dtype))
            mask_loss = data_mean(
                torch.where(mok[..., None, None], bce, 0.0).sum(),
                mok.sum().to(bce.dtype)) / (m * m)

        metrics = {"rpn_cls": rpn_cls.mean(), "rpn_box": rpn_box.mean(),
                   "cls_loss": cls_loss, "box_loss": box_loss,
                   "mask_loss": mask_loss}
        loss = (metrics["rpn_cls"] + metrics["rpn_box"] + cls_loss + box_loss
                + mask_loss)
        return loss, (model_state, {k: v.detach() for k, v in metrics.items()})

    # -- inference ------------------------------------------------------------

    @torch.no_grad()
    def predict(self, model: MaskRCNN, images: torch.Tensor, *,
                max_out: int = 100, score_threshold: float = 0.05,
                iou_threshold: float = 0.5, with_masks: bool = True):
        """An eval-mode forward (the model's mode is put back), class-aware
        NMS and the masks of the picks: images (B, S, S, 3) -> boxes (B,
        max_out, 4), scores, labels (category ids), valid and, with masks,
        (B, max_out, 28, 28) sigmoid masks."""
        cfg = self.cfg
        training = model.training
        model.eval()
        try:
            feats = model.features(images)
            prop, prop_valid = self.proposals(*model.rpn(feats))
            b, r = prop.shape[:2]
            pooled = _multilevel_roi_align(feats[:4], prop, 7, cfg.strides)
            cls_logits, box_deltas = model.box_head(pooled.flatten(0, 1))
            probs = F.softmax(cls_logits.reshape(b, r, -1), -1)[..., 1:]
            score, label = probs.amax(-1), probs.argmax(-1)  # first maximum
            sel = (label + 1)[..., None, None].expand(b, r, 1, 4)
            deltas = box_deltas.reshape(b, r, cfg.num_classes, 4).gather(
                2, sel)[:, :, 0]
            boxes = decode_boxes(prop, deltas, ROI_BOX_WEIGHTS).clamp(
                0.0, cfg.image_size)
            score = torch.where(prop_valid, score, 0.0)
            # class-aware NMS: classes offset apart never suppress each other
            shifted = boxes + (label * (cfg.image_size + 1))[..., None]
            idx, det_valid = batched_nms(shifted, score,
                                         iou_threshold=iou_threshold,
                                         max_out=max_out,
                                         score_threshold=score_threshold)
            safe = idx.long().clamp_min(0)
            det_boxes, det_label = _take(boxes, safe), _take(label, safe)
            out = (det_boxes, _take(score, safe), det_label, det_valid)
            if with_masks:
                m = cfg.mask_resolution
                pooled14 = _multilevel_roi_align(feats[:4], det_boxes, 14,
                                                 cfg.strides)
                mcls = (det_label + 1).reshape(-1, 1, 1, 1).expand(-1, 1, m, m)
                mask = model.mask_head(pooled14.flatten(0, 1)).gather(1, mcls)
                out = out + (torch.sigmoid(mask).reshape(b, max_out, m, m),)
            return out
        finally:
            model.train(training)
