"""SSD300 evaluation on COCO-style ground truth.

Port of ``deeplearningexamples_tpu/models/ssd/evaluate.py`` (reference
``ssd/evaluate.py:24-110``): decode and softmax on the model's device in
batches, per-image NMS on the host, and the numpy ``CocoMAP`` scorer. One
process evaluates the whole loader.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn

from ...parallel.mesh import gather_objects
from .boxes import nms_single
from .coco_eval import CocoMAP

__all__ = ["evaluate_ssd"]


@torch.no_grad()
def evaluate_ssd(
    task,
    model: nn.Module,
    val_loader: Iterable,
    score_thresh: float = 0.05,
    nms_criteria: float = 0.5,
    max_output: int = 200,
) -> dict:
    """Detection over a loader of batches with a numpy ``image`` (B, 300,
    300, 3) and host-side ``gt`` entries ``(image_id, boxes, labels)``, on
    the model's device. Returns {"mAP", "mAP50"}. Under a data axis each
    rank detects on its rows and every rank scores all ranks' images."""
    device = next(model.parameters()).device
    scorer = CocoMAP()
    seen = []
    for batch in val_loader:
        images = torch.as_tensor(batch["image"]).to(device)
        boxes, probs = task.predict_fn(model, None, images)
        boxes, probs = boxes.cpu().numpy(), probs.cpu().numpy()
        for i, (_img_id, gt_boxes, gt_labels) in enumerate(batch["gt"]):
            det_b, det_l, det_s = nms_single(
                boxes[i], probs[i], criteria=nms_criteria,
                max_output=max_output, score_thresh=score_thresh,
            )
            seen.append((det_b, det_l, det_s, gt_boxes, gt_labels))
    for part in gather_objects(seen):
        for image in part:
            scorer.add_image(*image)
    return scorer.compute()
