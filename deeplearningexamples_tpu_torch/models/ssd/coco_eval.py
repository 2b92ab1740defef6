"""Copy of ``deeplearningexamples_tpu/models/ssd/coco_eval.py``
(``CocoMAP``): COCO-style box mAP in numpy.

The reference scores with pycocotools' ``COCOeval`` (``ssd/evaluate.py:
96-110``); this is the metric from the COCO definition: per class, greedy
matching of score-ranked detections to ground truth at IoU thresholds
0.50:0.95:0.05, 101-point interpolated precision, averaged over classes and
thresholds (the headline ``AP @ IoU=0.50:0.95``), and the same at 0.50.
``MaskMAP`` and ``paste_mask`` wait for Mask R-CNN.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np

__all__ = ["CocoMAP"]

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
        """IoU of one detection vs all gt of the class (box IoU; JAX's
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
