"""SSD300 training task: the MultiBox loss with hard-negative mining.

Port of ``deeplearningexamples_tpu/models/ssd/task.py`` (reference ``Loss``,
``ssd/model.py:132-196``, and the train pipeline's color twist,
``ssd/coco_pipeline.py:63-93``), in the port's contract::

    loss_fn(model, model_state, batch, generator) -> (loss, (model_state, metrics))

A batch holds ``image`` (B, 300, 300, 3) fp32, ``loc_targets`` (B, 8732, 4)
fp32 and ``cls_targets`` (B, 8732) int32 on the model's device (the
targets encoded on the host by ``encode``). The loss runs in fp32:

- SmoothL1 on the encoded offsets of the positive anchors;
- CE on the classes, with 3:1 hard-negative mining: the negatives ranked by
  their CE with a double argsort that is stable (JAX's ``jnp.argsort`` is;
  ``torch.argsort`` is only with ``stable=True``, and bf16 logits tie
  often), the first ``clip(3 * num_pos, 0, N)`` kept;
- each image's sum divided by its positive count, 0 for an image without
  positives, then a plain mean over the batch.

The color twist's per-image parameters are drawn on the host from the
step's generator: JAX's ``jax.random`` bits cannot be matched, so parity
holds at given parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import data_rows
from .boxes import DefaultBoxes, dboxes300_coco, decode_batch
from .model import SSD300

__all__ = ["SSDTask", "color_twist", "multibox_loss",
           "sample_color_twist_params", "smooth_l1"]


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


# DALI's Hsv operates as a linear transform in YIQ space; BrightnessContrast
# is out = brightness * (center + contrast * (x - center)) with center 128
# on [0,255] inputs (reference ``ssd/coco_pipeline.py:63-69,118-119``).
_RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                     [0.596, -0.274, -0.321],
                     [0.211, -0.523, 0.311]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def color_twist(images: torch.Tensor, hue_deg: torch.Tensor,
                saturation: torch.Tensor, brightness: torch.Tensor,
                contrast: torch.Tensor,
                contrast_center: float = 128.0 / 255.0) -> torch.Tensor:
    """The reference's train-time color jitter on [0, 1] RGB images (B, H,
    W, 3), computed in fp32 and clipped to [0, 1]. Per-image parameters (B,):
    ``hue_deg`` in degrees, ``saturation`` and ``contrast`` in [0.5, 1.5],
    ``brightness`` in [0.875, 1.125] (``coco_pipeline.py:91-93``)."""
    x = images.float()
    rgb2yiq = torch.from_numpy(_RGB2YIQ).to(x.device)
    yiq2rgb = torch.from_numpy(_YIQ2RGB).to(x.device)
    yiq = torch.einsum("bhwc,dc->bhwd", x, rgb2yiq)
    h = torch.deg2rad(hue_deg.float())[:, None, None]
    s = saturation.float()[:, None, None]
    cos_h, sin_h = torch.cos(h), torch.sin(h)
    y = yiq[..., 0]
    i = s * (yiq[..., 1] * cos_h - yiq[..., 2] * sin_h)
    q = s * (yiq[..., 1] * sin_h + yiq[..., 2] * cos_h)
    x = torch.einsum("bhwd,cd->bhwc", torch.stack([y, i, q], -1), yiq2rgb)
    b = brightness.float()[:, None, None, None]
    c = contrast.float()[:, None, None, None]
    x = b * (contrast_center + c * (x - contrast_center))
    return x.clamp(0.0, 1.0).to(images.dtype)


_TWIST_RANGES = {"hue_deg": (-0.5, 0.5), "saturation": (0.5, 1.5),
                 "brightness": (0.875, 1.125), "contrast": (0.5, 1.5)}


def sample_color_twist_params(generator: torch.Generator, batch: int,
                              device: torch.device | str = "cpu"
                              ) -> dict[str, torch.Tensor]:
    """The reference's per-image jitter parameters, uniform over their
    ranges (``coco_pipeline.py:91-93``), drawn on the host from
    ``generator`` (a CPU generator) and copied to ``device`` from pinned
    memory, so the copy does not wait for the steps already queued."""
    off, rows = data_rows(batch)  # this rank's rows of the global draw
    u = torch.rand(len(_TWIST_RANGES), rows, generator=generator)
    u = u[:, off:off + batch].contiguous()
    if torch.device(device).type == "cuda":
        u = u.pin_memory().to(device, non_blocking=True)
    return {name: lo + (hi - lo) * u[k]
            for k, (name, (lo, hi)) in enumerate(_TWIST_RANGES.items())}


def multibox_loss(loc_pred: torch.Tensor, conf_pred: torch.Tensor,
                  loc_target: torch.Tensor, cls_target: torch.Tensor,
                  neg_ratio: int = 3) -> torch.Tensor:
    """loc_pred (B, N, 4), conf_pred (B, N, C), loc_target (B, N, 4),
    cls_target (B, N) int (0 = background) -> the scalar loss, in fp32 (or
    float64 for float64 inputs)."""
    pos = cls_target > 0  # (B, N)
    num_pos = pos.sum(1)  # (B,)

    sl1 = smooth_l1(loc_pred - loc_target).sum(-1)  # (B, N)
    loc_loss = (sl1 * pos).sum(1)  # (B,)

    b, n, c = conf_pred.shape
    logits = conf_pred.to(torch.promote_types(conf_pred.dtype, torch.float32))
    con = F.cross_entropy(logits.reshape(b * n, c),
                          cls_target.reshape(-1).long(),
                          reduction="none").view(b, n)

    # hard negative mining: rank negatives by loss via a stable double argsort
    con_neg = torch.where(pos, 0.0, con.detach())
    order = torch.argsort(-con_neg, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)  # 0 = hardest
    num_neg = torch.clamp(neg_ratio * num_pos, 0, n)[:, None]
    neg = rank < num_neg  # (B, N)

    conf_loss = (con * (pos | neg)).sum(1)  # (B,)

    total = loc_loss + conf_loss
    # reference semantics (``ssd/model.py:190-196``): per-image loss divided
    # by its positive count, no-positive images contribute 0, then a plain
    # mean over the batch dimension (not over valid images only)
    per_image = total / num_pos.float().clamp_min(1e-6)
    return (per_image * (num_pos > 0)).mean()


@dataclass
class SSDTask:
    num_classes: int = 81
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32
    dboxes: DefaultBoxes = field(default_factory=dboxes300_coco)
    color_jitter: bool = True  # the reference train pipeline's color twist

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> nn.Module:
        """An ``SSD300`` with flax's initialisers drawn on the CPU from
        ``generator``, then placed on ``device``, in training mode."""
        model = SSD300(self.num_classes, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        """The BN running statistics, by their ``state_dict`` names."""
        return dict(model.named_buffers())

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """The MultiBox loss of a training forward on the color-twisted
        images."""
        images = batch["image"]
        if self.color_jitter:
            images = color_twist(images, **sample_color_twist_params(
                generator, images.shape[0], images.device))
        loc, conf = model(images.permute(0, 3, 1, 2))
        loss = multibox_loss(loc, conf, batch["loc_targets"],
                             batch["cls_targets"])
        return loss, (model_state, {})

    @torch.no_grad()
    def predict_fn(self, model: nn.Module, model_state,
                   images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """An eval-mode forward on (B, 300, 300, 3) images, decoded on their
        device: (ltrb boxes (B, N, 4), class probabilities (B, N, C)), fp32.
        The model's mode is put back."""
        training = model.training
        model.eval()
        try:
            loc, conf = model(images.permute(0, 3, 1, 2))
        finally:
            model.train(training)
        return decode_batch(self.dboxes, loc), torch.softmax(conf, -1)
