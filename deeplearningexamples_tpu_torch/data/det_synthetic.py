"""Copy of ``deeplearningexamples_tpu/data/det_synthetic.py``: synthetic
detection batches (EfficientDet, Mask R-CNN).

Benchmark-mode stand-in for the COCO pipeline (the reference benchmarks
detection the same way: fixed random batches). Emits the detection batch
contract: ``image`` (B, S, S, 3), ``boxes`` (B, G, 4) xyxy, ``labels``
(B, G), ``valid`` (B, G), and with ``with_masks`` ``masks`` (B, G, Mg, Mg):
each instance's box filled on a dense grid (Mask R-CNN; stands in for COCO's
polygons). The batches are JAX's, bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticDetectionLoader"]


class SyntheticDetectionLoader:
    def __init__(self, batch_size: int, image_size: int, num_classes: int,
                 *, max_gt: int = 16, steps: int = 100, with_masks: bool = False,
                 mask_grid: int = 64, seed: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.max_gt = max_gt
        self.steps = steps
        self.with_masks = with_masks
        self.mask_grid = mask_grid
        self.seed = seed

    def __len__(self):
        return self.steps

    def _make_batch(self, rng):
        bs, s, g = self.batch_size, self.image_size, self.max_gt
        boxes = np.zeros((bs, g, 4), np.float32)
        labels = np.zeros((bs, g), np.int32)
        valid = np.zeros((bs, g), bool)
        for i in range(bs):
            n = int(rng.integers(1, g + 1))
            c = rng.uniform(0.15 * s, 0.85 * s, (n, 2))
            wh = rng.uniform(0.08 * s, 0.5 * s, (n, 2))
            xy1 = np.clip(c - wh / 2, 0, s - 2)
            xy2 = np.clip(c + wh / 2, xy1 + 2, s)
            boxes[i, :n] = np.concatenate([xy1, xy2], axis=1)
            labels[i, :n] = rng.integers(0, self.num_classes, n)
            valid[i, :n] = True
        batch = {
            "image": rng.normal(size=(bs, s, s, 3)).astype(np.float32),
            "boxes": boxes, "labels": labels, "valid": valid,
        }
        if self.with_masks:
            mg = self.mask_grid
            masks = np.zeros((bs, g, mg, mg), np.float32)
            scale = mg / s
            for i in range(bs):
                for j in np.flatnonzero(valid[i]):
                    x1, y1, x2, y2 = (boxes[i, j] * scale).astype(int)
                    masks[i, j, y1:max(y2, y1 + 1), x1:max(x2, x1 + 1)] = 1.0
            batch["masks"] = masks
        return batch

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        batch = self._make_batch(rng)  # one batch, reused (benchmark mode)
        for _ in range(self.steps):
            yield batch
