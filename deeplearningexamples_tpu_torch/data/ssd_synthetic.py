"""Copy of ``deeplearningexamples_tpu/data/ssd_synthetic.py``: synthetic
SSD batches with their targets encoded on the host, numpy only. The same
numpy calls in the same order as the JAX package's loader, so one seed
draws the same batch."""

from __future__ import annotations

import numpy as np

from ..models.ssd.boxes import DefaultBoxes, encode
from .synthetic import _Synthetic

__all__ = ["SyntheticSSDLoader"]


class SyntheticSSDLoader(_Synthetic):
    """NHWC fp32 N(0, 1) images, ``boxes_per_image`` random boxes an image
    with labels in [1, num_classes), encoded against ``dboxes``."""

    def __init__(
        self,
        batch_size: int,
        dboxes: DefaultBoxes,
        image_size: int = 300,
        num_classes: int = 81,
        boxes_per_image: int = 6,
        steps: int = 100,
        seed: int = 0,
    ):
        super().__init__(steps)
        self.batch_size, self.image_size = batch_size, image_size
        self.num_classes, self.boxes_per_image = num_classes, boxes_per_image
        self.dboxes = dboxes
        self.rng = np.random.default_rng(seed)

    def _make(self):
        b = self.batch_size
        images = self.rng.normal(
            size=(b, self.image_size, self.image_size, 3)
        ).astype(np.float32)
        loc_t, cls_t = [], []
        for _ in range(b):
            n = self.boxes_per_image
            lt = self.rng.uniform(0.0, 0.7, (n, 2))
            wh = self.rng.uniform(0.1, 0.3, (n, 2))
            gt = np.concatenate([lt, lt + wh], axis=1).astype(np.float32)
            labels = self.rng.integers(1, self.num_classes, n)
            l, c = encode(self.dboxes, gt, labels)
            loc_t.append(l)
            cls_t.append(c)
        return {
            "image": images,
            "loc_targets": np.stack(loc_t),
            "cls_targets": np.stack(cls_t),
        }
