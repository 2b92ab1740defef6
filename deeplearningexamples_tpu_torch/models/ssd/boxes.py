"""Copy of ``deeplearningexamples_tpu/models/ssd/boxes.py``: SSD300's default
boxes, IoU matching and encoding, decoding and per-class NMS.

The reference's box utilities (``PyTorch/Detection/SSD/ssd/utils.py``:
``DefaultBoxes`` :224-280, ``dboxes300_coco`` :282, ``Encoder.encode``,
``decode_batch``, ``decode_single`` :70-222): 8732 anchors over the feature
maps 38/19/10/5/3/1, with the variances scale_xy=0.1 and scale_wh=0.2.

- ``dboxes300_coco``, ``encode`` and ``nms_single`` are the JAX package's
  numpy code. ``encode`` runs on the host in the loader (DALI's
  ``BoxEncoder`` in the reference), so every image has 8732 targets;
  ``nms_single`` runs on the host at evaluation, as the reference's Python
  NMS loop.
- ``decode_batch`` runs in torch on the predictions' device.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DefaultBoxes", "dboxes300_coco", "decode_batch", "encode",
           "nms_single"]


@dataclass(frozen=True)
class DefaultBoxes:
    """Anchor set in both ltrb and xywh forms (numpy, host-side)."""

    ltrb: np.ndarray  # (N, 4) l, t, r, b in [0, 1]
    xywh: np.ndarray  # (N, 4) cx, cy, w, h
    scale_xy: float = 0.1
    scale_wh: float = 0.2

    @property
    def num_boxes(self) -> int:
        return self.ltrb.shape[0]


def dboxes300_coco() -> DefaultBoxes:
    """SSD300 COCO anchors — 8732 boxes (reference ``utils.py:282-292``)."""
    fig_size = 300
    feat_sizes = [38, 19, 10, 5, 3, 1]
    steps = [8, 16, 32, 64, 100, 300]
    scales = [21, 45, 99, 153, 207, 261, 315]
    aspect_ratios = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]

    boxes = []
    for idx, sfeat in enumerate(feat_sizes):
        sk1 = scales[idx] / fig_size
        sk2 = scales[idx + 1] / fig_size
        sk3 = math.sqrt(sk1 * sk2)
        all_sizes = [(sk1, sk1), (sk3, sk3)]
        for alpha in aspect_ratios[idx]:
            w, h = sk1 * math.sqrt(alpha), sk1 / math.sqrt(alpha)
            all_sizes.append((w, h))
            all_sizes.append((h, w))
        fk = fig_size / steps[idx]
        for w, h in all_sizes:
            for i, j in itertools.product(range(sfeat), repeat=2):
                cx, cy = (j + 0.5) / fk, (i + 0.5) / fk
                boxes.append((cx, cy, w, h))

    xywh = np.clip(np.asarray(boxes, np.float32), 0.0, 1.0)
    ltrb = np.empty_like(xywh)
    ltrb[:, 0] = xywh[:, 0] - 0.5 * xywh[:, 2]
    ltrb[:, 1] = xywh[:, 1] - 0.5 * xywh[:, 3]
    ltrb[:, 2] = xywh[:, 0] + 0.5 * xywh[:, 2]
    ltrb[:, 3] = xywh[:, 1] + 0.5 * xywh[:, 3]
    return DefaultBoxes(ltrb=ltrb, xywh=xywh)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (N,4) and (M,4) ltrb boxes (reference ``calc_iou_tensor``)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def encode(
    dboxes: DefaultBoxes,
    gt_boxes: np.ndarray,  # (G, 4) ltrb in [0, 1]
    gt_labels: np.ndarray,  # (G,) int, 0 = background reserved
    criteria: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """IoU-match GT to anchors and produce regression targets + labels.

    Matching rule (reference ``Encoder.encode`` :80-108): each anchor takes
    the best-IoU GT if IoU > criteria; additionally every GT claims its
    best-matching anchor unconditionally. Returns
    ``(loc_targets (N,4) xywh-encoded, labels (N,) int32)``.
    """
    n = dboxes.num_boxes
    loc = np.zeros((n, 4), np.float32)
    labels = np.zeros((n,), np.int64)
    if gt_boxes.shape[0] == 0:
        return loc, labels.astype(np.int32)

    ious = _iou_matrix(gt_boxes.astype(np.float32), dboxes.ltrb)  # (G, N)
    best_gt_per_anchor = ious.argmax(axis=0)
    best_iou_per_anchor = ious.max(axis=0)
    best_anchor_per_gt = ious.argmax(axis=1)

    # every GT owns its best anchor
    best_iou_per_anchor[best_anchor_per_gt] = 2.0
    best_gt_per_anchor[best_anchor_per_gt] = np.arange(gt_boxes.shape[0])

    matched = best_iou_per_anchor > criteria
    labels[matched] = gt_labels[best_gt_per_anchor[matched]]

    # ltrb -> xywh of assigned gt
    g = gt_boxes[best_gt_per_anchor].astype(np.float32)
    gx = 0.5 * (g[:, 0] + g[:, 2])
    gy = 0.5 * (g[:, 1] + g[:, 3])
    gw = g[:, 2] - g[:, 0]
    gh = g[:, 3] - g[:, 1]
    d = dboxes.xywh
    loc_all = np.stack(
        [
            (gx - d[:, 0]) / d[:, 2] / dboxes.scale_xy,
            (gy - d[:, 1]) / d[:, 3] / dboxes.scale_xy,
            np.log(np.maximum(gw, 1e-8) / d[:, 2]) / dboxes.scale_wh,
            np.log(np.maximum(gh, 1e-8) / d[:, 3]) / dboxes.scale_wh,
        ],
        axis=1,
    )
    loc[matched] = loc_all[matched]
    return loc, labels.astype(np.int32)


def decode_batch(dboxes: DefaultBoxes, loc: torch.Tensor) -> torch.Tensor:
    """Predicted offsets (B, N, 4) -> ltrb boxes (B, N, 4), on ``loc``'s
    device and in its dtype, in JAX's order of operations. The anchors'
    columns are contiguous tensors: broadcast as strided column views of the
    (N, 4) array, torch 2.13's CPU kernels gave entries up to 7e-5 off in
    some runs."""
    dx, dy, dw, dh = torch.as_tensor(dboxes.xywh.T.copy(), dtype=loc.dtype,
                                     device=loc.device)
    cx = loc[..., 0] * dboxes.scale_xy * dw + dx
    cy = loc[..., 1] * dboxes.scale_xy * dh + dy
    w = torch.exp(loc[..., 2] * dboxes.scale_wh) * dw
    h = torch.exp(loc[..., 3] * dboxes.scale_wh) * dh
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h],
                       dim=-1)


def nms_single(
    boxes: np.ndarray,  # (N, 4) ltrb
    scores: np.ndarray,  # (N, C) softmax probs incl. background col 0
    criteria: float = 0.5,
    max_output: int = 200,
    max_num: int = 200,
    score_thresh: float = 0.05,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-image class-wise NMS (reference ``decode_single``
    ``utils.py:172-222``). Returns (boxes, labels, scores) sorted by score."""
    out_b, out_l, out_s = [], [], []
    for cls in range(1, scores.shape[1]):
        s = scores[:, cls]
        mask = s > score_thresh
        if not mask.any():
            continue
        b, s = boxes[mask], s[mask]
        order = np.argsort(s)[-max_num:]
        keep = []
        while order.size:
            i = order[-1]
            keep.append(i)
            if order.size == 1:
                break
            rest = order[:-1]
            ious = _iou_matrix(b[i : i + 1], b[rest])[0]
            order = rest[ious < criteria]
        out_b.append(b[keep])
        out_s.append(s[keep])
        out_l.append(np.full(len(keep), cls, np.int32))
    if not out_b:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
                np.zeros((0,), np.float32))
    b = np.concatenate(out_b)
    l = np.concatenate(out_l)
    s = np.concatenate(out_s)
    top = np.argsort(s)[-max_output:][::-1]
    return b[top], l[top], s[top]
