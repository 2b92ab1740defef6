"""Port of ``deeplearningexamples_tpu/ops/detection.py``: pairwise IoU, the
proposal matcher, greedy NMS, ROIAlign and the Faster R-CNN box coder
(EfficientDet and Mask R-CNN).

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
- ``roi_align``: the reference's ``ROIAlign_cuda.cu`` (``aligned=False``: no
  half-pixel offset; ``sampling_ratio`` 2; ROI sides floored at 1 px; a
  sample counts as outside at ``y < -1`` or ``y > h``, and its coordinates
  clamp to ``[0, h - 1]``), in fp32 whatever the features' dtype. The
  features are read where they lie: a map's row ``(y, x)`` of C channels is
  one row of a (rows, C) table, which is the memory of an NHWC array or of
  an NCHW ``channels_last`` one, so each bilinear corner is one row gather
  (``roi_align_rows`` pools ROIs of different maps of one table at once:
  Mask R-CNN's FPN levels).
- ``encode_boxes`` / ``decode_boxes``: the reference's ``BoxCoder``
  (``modeling/box_coder.py``) with per-coordinate weights.
"""

from __future__ import annotations

import math

import torch

__all__ = ["BELOW_LOW_THRESHOLD", "BETWEEN_THRESHOLDS", "batched_nms",
           "box_iou", "decode_boxes", "encode_boxes", "match_proposals",
           "roi_align", "roi_align_rows"]

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


def _bilinear(table: torch.Tensor, base: torch.Tensor, h: torch.Tensor,
              w: torch.Tensor, y: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """The reference's ``bilinear_interpolate``: table (rows, C); per ROI
    the first row of its map ``base`` and the map's ``h``, ``w`` (int64,
    shaped to broadcast against y and x); y, x fp32 sample coordinates ->
    (*y.shape, C) in fp32 (float64 for a float64 table). A sample outside
    gives 0."""
    acc = torch.promote_types(table.dtype, torch.float32)
    hf, wf = h.to(y.dtype), w.to(y.dtype)
    oob = (y < -1.0) | (y > hf) | (x < -1.0) | (x > wf)
    y = torch.minimum(torch.maximum(y, torch.zeros_like(y)), hf - 1.0)
    x = torch.minimum(torch.maximum(x, torch.zeros_like(x)), wf - 1.0)
    y0, x0 = y.floor().long(), x.floor().long()
    y1, x1 = torch.minimum(y0 + 1, h - 1), torch.minimum(x0 + 1, w - 1)
    ly, lx = y - y0.to(y.dtype), x - x0.to(x.dtype)
    hy, hx = 1.0 - ly, 1.0 - lx

    def at(yy, xx):
        return table[base + yy * w + xx].to(acc)

    val = (at(y0, x0) * (hy * hx)[..., None]
           + at(y0, x1) * (hy * lx)[..., None]
           + at(y1, x0) * (ly * hx)[..., None]
           + at(y1, x1) * (ly * lx)[..., None])
    return torch.where(oob[..., None], 0.0, val)


def roi_align_rows(table: torch.Tensor, base: torch.Tensor, h: torch.Tensor,
                   w: torch.Tensor, scale: torch.Tensor, boxes: torch.Tensor,
                   *, output_size: int = 7, sampling_ratio: int = 2
                   ) -> torch.Tensor:
    """ROIAlign of ROIs that each read their own map of one table.

    table (rows, C): the maps' rows ``(y, x)`` one after another; boxes
    (..., 4) xyxy in image coordinates; per ROI (the leading shape of
    ``boxes``) its map's first row ``base``, ``h`` and ``w`` (int64) and
    the map's ``scale`` (fp32, image -> map) -> (..., n, n, C) fp32 (float64
    for a float64 table), n = ``output_size``. The mean of each bin's
    ``sampling_ratio``^2 samples is summed in row-major order."""
    n, sr = output_size, sampling_ratio
    boxes = boxes.float() * scale[..., None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w = (x2 - x1).clamp_min(1.0) / n
    bin_h = (y2 - y1).clamp_min(1.0) / n
    dev = boxes.device
    iy = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    ph = torch.arange(n, dtype=torch.float32, device=dev)
    grid = ph[:, None] + iy[None, :]  # (n, sr)
    ys = y1[..., None, None] + grid * bin_h[..., None, None]  # (..., n, sr)
    xs = x1[..., None, None] + grid * bin_w[..., None, None]
    yy = ys[..., :, None, :, None]  # (..., n, 1, sr, 1)
    xx = xs[..., None, :, None, :]  # (..., 1, n, 1, sr)
    shape = ys.shape[:-2] + (n, n, sr, sr)
    per_roi = [t[(...,) + (None,) * 4] for t in (base, h, w)]
    vals = _bilinear(table, *per_roi, yy.expand(shape), xx.expand(shape))
    out = vals[..., 0, 0, :]
    for i in range(sr):  # JAX's reduce order: (0, 0), (0, 1), ..., (1, 1)
        for j in range(sr):
            if i or j:
                out = out + vals[..., i, j, :]
    return out / (sr * sr)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, *,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign of one feature level, as JAX's: features (..., H, W, C) and
    boxes (..., R, 4) xyxy in image coordinates, with the same leading
    shape (JAX's is empty) -> (..., R, n, n, C) fp32."""
    *lead, hh, ww, c = features.shape
    maps = math.prod(lead)
    table = features.reshape(maps * hh * ww, c)
    r = boxes.shape[-2]
    dev = boxes.device
    base = (torch.arange(maps, device=dev) * (hh * ww)).reshape(
        *lead, 1).expand(*lead, r)
    h, w = (torch.full(base.shape, n, device=dev) for n in (hh, ww))
    scale = torch.full(base.shape, spatial_scale, dtype=torch.float32,
                       device=dev)
    return roi_align_rows(table, base, h, w, scale, boxes,
                          output_size=output_size,
                          sampling_ratio=sampling_ratio)


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor,
                 weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0,
                                                               1.0)
                 ) -> torch.Tensor:
    """Faster R-CNN box encoding of gt (..., 4) xyxy against anchors (...,
    4): (dx, dy, dw, dh) times ``weights`` (the RPN's 1s, the ROI box
    head's 10, 10, 5, 5). Both sides' widths and heights are floored at
    1e-3, so a dead slot's degenerate box gives no NaN."""
    anchors, gt = anchors.float(), gt.float()
    aw = (anchors[..., 2] - anchors[..., 0]).clamp_min(1e-3)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp_min(1e-3)
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-3)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-3)
    gx = gt[..., 0] + gw / 2
    gy = gt[..., 1] + gh / 2
    wx, wy, ww, wh = weights
    return torch.stack([wx * (gx - ax) / aw, wy * (gy - ay) / ah,
                        ww * torch.log(gw / aw), wh * torch.log(gh / ah)], -1)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0,
                                                               1.0)
                 ) -> torch.Tensor:
    """The inverse of :func:`encode_boxes` (reference ``BoxCoder.decode``),
    dw and dh clamped to log(1000 / 16) as the reference clamps them."""
    anchors, deltas = anchors.float(), deltas.float()
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    wx, wy, ww, wh = weights
    clamp = 4.135  # log(1000/16), reference box_coder.py bbox_xform_clip
    cx = deltas[..., 0] / wx * aw + ax
    cy = deltas[..., 1] / wy * ah + ay
    w = torch.exp((deltas[..., 2] / ww).clamp(-clamp, clamp)) * aw
    h = torch.exp((deltas[..., 3] / wh).clamp(-clamp, clamp)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
