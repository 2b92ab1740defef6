"""Port of ``deeplearningexamples_tpu/ops/detection.py``, the part EfficientDet
calls: pairwise IoU, the proposal matcher and greedy NMS.

``roi_align``, ``encode_boxes`` and ``decode_boxes`` wait for Mask R-CNN.

- ``box_iou``: pairwise IoU of xyxy boxes in fp32, 0 where the union is not
  positive.
- ``match_proposals``: the reference's Matcher (``match_proposals.cu`` /
  ``matcher.py``) with its BELOW_LOW / BETWEEN thresholds and the
  low-quality force-match.
- ``batched_nms``: greedy NMS truncated to ``max_out`` picks, with JAX's
  static output (indices padded with -1, a ``valid`` mask). JAX builds the
  whole N x N IoU and takes a row at each pick; at EfficientDet-D0's 512
  input N is 49,104 anchors, 9.6 GB of fp32 an image. Here only the row of
  each pick is computed, from the same fp32 operations, so the picks are the
  same: ``argmax`` takes the first maximum in both packages. A batch of
  images is suppressed together, one pick of each per step.
"""

from __future__ import annotations

import torch

__all__ = ["BELOW_LOW_THRESHOLD", "BETWEEN_THRESHOLDS", "batched_nms",
           "box_iou", "match_proposals"]

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a (..., N, 4), b (..., M, 4) in xyxy -> (..., N, M)
    fp32."""
    a, b = a.float(), b.float()
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
                iou_threshold: float = 0.5, max_out: int = 100,
                score_threshold: float = -float("inf")
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output size.

    boxes (N, 4) xyxy, scores (N,) -> (indices (max_out,) int32, valid
    (max_out,) bool), or with a leading batch axis on both, each image on
    its own. Pads with -1 indices when fewer than ``max_out`` survive.
    Equivalent to torchvision/caffe2 ``nms`` (reference ``csrc/cuda/nms.cu``)
    truncated to the top ``max_out`` picks.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    boxes = boxes.float()
    b, n = scores.shape
    live = scores > score_threshold
    rows = torch.arange(b, device=boxes.device)
    cols = torch.arange(n, device=boxes.device)
    idx, valid = [], []
    neg = torch.tensor(-float("inf"), device=scores.device, dtype=scores.dtype)
    for _ in range(max_out):
        masked = torch.where(live, scores, neg)
        best = masked.argmax(1)
        ok = masked[rows, best] > -float("inf")
        iou = box_iou(boxes[rows, best][:, None], boxes)[:, 0]  # (B, N)
        live = live & ~(iou > iou_threshold) & (cols[None] != best[:, None])
        idx.append(torch.where(ok, best, -1))
        valid.append(ok)
    idx = torch.stack(idx, 1).to(torch.int32)
    valid = torch.stack(valid, 1)
    return (idx[0], valid[0]) if single else (idx, valid)


def match_proposals(iou: torch.Tensor, *, high_threshold: float = 0.7,
                    low_threshold: float = 0.3,
                    allow_low_quality: bool = True) -> torch.Tensor:
    """Reference Matcher (``match_proposals.cu`` / ``matcher.py``).

    iou (..., G, A): G ground-truth boxes x A anchors. Returns (..., A)
    int32: the matched gt index per anchor (the first of a tie), or
    BELOW_LOW_THRESHOLD (-1) / BETWEEN_THRESHOLDS (-2).
    ``allow_low_quality`` force-matches, for every gt, all anchors tied for
    its best IoU.
    """
    vals, matches = iou.amax(-2), iou.argmax(-2).to(torch.int32)
    out = torch.where(vals < low_threshold, BELOW_LOW_THRESHOLD, matches)
    out = torch.where((vals >= low_threshold) & (vals < high_threshold),
                      BETWEEN_THRESHOLDS, out)
    if allow_low_quality:
        best_per_gt = iou.max(-1, keepdim=True).values  # (..., G, 1)
        forced = ((iou == best_per_gt) & (best_per_gt > 0)).any(-2)
        out = torch.where(forced, matches, out)
    return out.to(torch.int32)
