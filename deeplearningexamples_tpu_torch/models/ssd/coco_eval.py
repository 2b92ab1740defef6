"""Copy of ``deeplearningexamples_tpu/models/ssd/coco_eval.py``: COCO-style
box and mask mAP in numpy.

The reference scores with pycocotools' ``COCOeval`` (``ssd/evaluate.py:
96-110``); this is the metric from the COCO definition: per class, greedy
matching of score-ranked detections to ground truth at IoU thresholds
0.50:0.95:0.05, 101-point interpolated precision, averaged over classes and
thresholds (the headline ``AP @ IoU=0.50:0.95``), and the same at 0.50.
``MaskMAP`` scores instance masks the same way (``iouType='segm'``): each
detection's 28 x 28 mask pasted into its box on the ground truth's grid
(``paste_mask``), matched by mask IoU.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np

__all__ = ["CocoMAP", "MaskMAP", "paste_mask"]

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


@dataclass
class CocoMAP:
    """Accumulate per-image detections + GT, then compute mAP."""

    _dets: dict = field(default_factory=lambda: collections.defaultdict(list))
    _gts: dict = field(default_factory=lambda: collections.defaultdict(list))
    _img_count: int = 0

    def add_image(
        self,
        det_boxes: np.ndarray,  # (D, 4) ltrb
        det_labels: np.ndarray,  # (D,)
        det_scores: np.ndarray,  # (D,)
        gt_boxes: np.ndarray,  # (G, 4)
        gt_labels: np.ndarray,  # (G,)
    ) -> None:
        img_id = self._img_count
        self._img_count += 1
        for cls in np.unique(np.concatenate([det_labels, gt_labels])).astype(int):
            d = det_labels == cls
            g = gt_labels == cls
            self._dets[cls].append(
                (img_id, det_boxes[d], det_scores[d])
            )
            self._gts[cls].append((img_id, gt_boxes[g]))

    def _pair_iou(self, det_obj, gt_objs) -> np.ndarray:
        """IoU of one detection vs all gt of the class (box IoU;
        ``MaskMAP`` overrides it with pasted-mask IoU)."""
        return _iou(det_obj[None], gt_objs)[0]

    def compute(self) -> dict:
        ap_per_class = []
        ap50_per_class = []
        for cls in sorted(self._gts):
            gts = {img: boxes for img, boxes in self._gts[cls]}
            n_gt = sum(len(b) for b in gts.values())
            if n_gt == 0:
                continue
            # flatten detections, rank by score
            recs = []
            for img, boxes, scores in self._dets[cls]:
                for b, s in zip(boxes, scores):
                    recs.append((float(s), img, b))
            recs.sort(key=lambda r: -r[0])

            aps = []
            for t_i, thr in enumerate(IOU_THRESHOLDS):
                matched: dict[int, set] = collections.defaultdict(set)
                tp = np.zeros(len(recs))
                fp = np.zeros(len(recs))
                for i, (_s, img, box) in enumerate(recs):
                    gt = gts.get(img, np.zeros((0, 4)))
                    if len(gt) == 0:
                        fp[i] = 1
                        continue
                    ious = self._pair_iou(box, gt)
                    # greedy: best unmatched gt above threshold
                    order = np.argsort(-ious)
                    hit = -1
                    for j in order:
                        if ious[j] < thr:
                            break
                        if j not in matched[img]:
                            hit = j
                            break
                    if hit >= 0:
                        matched[img].add(hit)
                        tp[i] = 1
                    else:
                        fp[i] = 1
                ctp, cfp = np.cumsum(tp), np.cumsum(fp)
                recall = ctp / n_gt
                precision = ctp / np.maximum(ctp + cfp, 1e-12)
                # 101-point interpolation with precision envelope
                prec_env = np.maximum.accumulate(precision[::-1])[::-1]
                interp = np.zeros_like(RECALL_POINTS)
                idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                valid = idx < len(prec_env)
                interp[valid] = prec_env[idx[valid]]
                aps.append(interp.mean())
            ap_per_class.append(np.mean(aps))
            ap50_per_class.append(aps[0])
        if not ap_per_class:
            return {"mAP": 0.0, "mAP50": 0.0}
        return {
            "mAP": float(np.mean(ap_per_class)),
            "mAP50": float(np.mean(ap50_per_class)),
        }


def paste_mask(box: np.ndarray, mask28: np.ndarray, grid: int,
               image_size: float) -> np.ndarray:
    """Paste a (28, 28) box-local mask into a (grid, grid) image canvas
    (the role of pycocotools' RLE paste in ``COCOeval(iouType='segm')``):
    each canvas pixel centre inside the box samples the mask bilinearly,
    thresholded at 0.5."""
    m = np.zeros((grid, grid), bool)
    x1, y1, x2, y2 = np.asarray(box, np.float64) * (grid / image_size)
    w, h = max(x2 - x1, 1e-6), max(y2 - y1, 1e-6)
    js = np.arange(grid) + 0.5
    u = (js - x1) / w  # canvas x -> box fraction
    v = (js - y1) / h
    inside_x = (u >= 0) & (u < 1)
    inside_y = (v >= 0) & (v < 1)
    if not inside_x.any() or not inside_y.any():
        return m
    mu = np.clip(u[inside_x] * mask28.shape[1] - 0.5, 0,
                 mask28.shape[1] - 1)
    mv = np.clip(v[inside_y] * mask28.shape[0] - 0.5, 0,
                 mask28.shape[0] - 1)
    x0 = np.floor(mu).astype(int)
    y0 = np.floor(mv).astype(int)
    x1i = np.minimum(x0 + 1, mask28.shape[1] - 1)
    y1i = np.minimum(y0 + 1, mask28.shape[0] - 1)
    fx, fy = mu - x0, mv - y0
    patch = (
        mask28[np.ix_(y0, x0)] * ((1 - fy)[:, None] * (1 - fx)[None, :])
        + mask28[np.ix_(y0, x1i)] * ((1 - fy)[:, None] * fx[None, :])
        + mask28[np.ix_(y1i, x0)] * (fy[:, None] * (1 - fx)[None, :])
        + mask28[np.ix_(y1i, x1i)] * (fy[:, None] * fx[None, :])
    )
    m[np.ix_(inside_y, inside_x)] = patch >= 0.5
    return m


@dataclass
class MaskMAP(CocoMAP):
    """Instance-segmentation AP (``iouType='segm'``): detections carry
    (box, 28 x 28 mask), ground truth (grid, grid) dense masks; matching IoU
    is computed between pasted binary masks."""

    image_size: float = 1.0  # det boxes' coordinate range

    def add_image_masks(self, det_boxes, det_masks, det_labels, det_scores,
                        gt_masks, gt_labels) -> None:
        grid = gt_masks.shape[-1] if len(gt_masks) else 64
        pasted = np.stack([
            paste_mask(b, m, grid, self.image_size)
            for b, m in zip(det_boxes, det_masks)
        ]) if len(det_boxes) else np.zeros((0, grid, grid), bool)
        img_id = self._img_count
        self._img_count += 1
        gt_masks = np.asarray(gt_masks, bool)
        labels_all = np.concatenate([det_labels, gt_labels])
        for cls in np.unique(labels_all).astype(int):
            d = det_labels == cls
            g = gt_labels == cls
            self._dets[cls].append((img_id, pasted[d], det_scores[d]))
            self._gts[cls].append((img_id, gt_masks[g]))

    def _pair_iou(self, det_obj, gt_objs) -> np.ndarray:
        inter = np.logical_and(det_obj[None], gt_objs).sum(axis=(1, 2))
        union = np.logical_or(det_obj[None], gt_objs).sum(axis=(1, 2))
        return inter / np.maximum(union, 1e-12)
