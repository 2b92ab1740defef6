"""Port of ``deeplearningexamples_tpu/data/coco.py``: the COCO detection
pipelines of SSD300, EfficientDet and Mask R-CNN.

Covers the reference's DALI COCO pipeline (``ssd/coco_pipeline.py:27-160``:
COCO reader → RandomBBoxCrop → decode → flip → resize → normalize →
BoxEncoder) and the torch-path ``SSDCropping`` (``ssd/utils.py:294-386``) +
``COCODetection`` dataset (:462):

- COCO JSON parsing with contiguous label mapping (1..80 + background 0)
- IoU-constrained random crop: sample min-IoU from
  (None, 0.1, 0.3, 0.5, 0.7, 0.9, no-crop), retry geometry, keep boxes whose
  centers fall inside, clip + renormalize — the exact SSD recipe
- decode + crop/resize on the data plane (``native``: the host's C++ plane,
  or nvJPEG and the resample kernel on the card, by ``device``)
- host-side anchor encoding (``models/ssd/boxes.encode``) producing
  static-shape targets
- Mask R-CNN's instance masks (``CocoRawLoader(with_masks=True)``): flip
  only, and each instance's polygons rasterized on a dense grid
  (``rasterize_polygons``: even-odd ray casting in the crop window, with the
  flip)

The draws, and so the batches, are JAX's, bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from ..models.ssd.boxes import DefaultBoxes, dboxes300_coco, encode
from ..native import DataPlane

__all__ = ["CocoDetectionDataset", "ssd_random_crop", "CocoSSDLoader",
           "CocoRawLoader", "rasterize_polygons"]


def ssd_random_crop(
    boxes: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
    max_tries: int = 5,
) -> tuple[tuple[float, float, float, float], np.ndarray, np.ndarray] | None:
    """Sample an SSD crop; returns ((x, y, w, h) fractions, boxes, labels) in
    crop coordinates, or None for "keep original"."""
    options = [None, 0.1, 0.3, 0.5, 0.7, 0.9, -1.0]
    while True:
        min_iou = options[rng.integers(0, len(options))]
        if min_iou is None:
            return None
        for _ in range(max_tries):
            w = rng.uniform(0.3, 1.0)
            h = rng.uniform(0.3, 1.0)
            if not (0.5 <= w / h <= 2.0):
                continue
            x = rng.uniform(0, 1.0 - w)
            y = rng.uniform(0, 1.0 - h)
            if len(boxes) == 0:
                return (x, y, w, h), boxes, labels
            # IoU of crop with each gt box
            lt = np.maximum(boxes[:, :2], [x, y])
            rb = np.minimum(boxes[:, 2:], [x + w, y + h])
            inter = np.clip(rb - lt, 0, None).prod(axis=1)
            area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            union = area_b + w * h - inter
            ious = inter / np.maximum(union, 1e-12)
            if min_iou >= 0 and ious.max(initial=0.0) < min_iou:
                continue
            centers = 0.5 * (boxes[:, :2] + boxes[:, 2:])
            keep = (
                (centers[:, 0] > x) & (centers[:, 0] < x + w)
                & (centers[:, 1] > y) & (centers[:, 1] < y + h)
            )
            if not keep.any():
                continue
            nb = boxes[keep].copy()
            nb[:, 0::2] = (np.clip(nb[:, 0::2], x, x + w) - x) / w
            nb[:, 1::2] = (np.clip(nb[:, 1::2], y, y + h) - y) / h
            return (x, y, w, h), nb, labels[keep]


class CocoDetectionDataset:
    """Parses instances_*.json; yields (image_path, boxes ltrb-frac, labels)."""

    def __init__(self, images_dir: str, annotations_json: str):
        with open(annotations_json) as f:
            doc = json.load(f)
        cats = sorted(c["id"] for c in doc["categories"])
        self.cat_to_label = {c: i + 1 for i, c in enumerate(cats)}  # 0 = bg
        self.label_to_cat = {v: k for k, v in self.cat_to_label.items()}
        images = {im["id"]: im for im in doc["images"]}
        anns: dict[int, list] = {}
        for a in doc.get("annotations", []):
            if a.get("iscrowd"):
                continue
            anns.setdefault(a["image_id"], []).append(a)
        self.samples = []
        self.segmentations: list = []  # per-sample list of per-instance
        # polygon lists in FRACTION coords (Mask R-CNN targets)
        for img_id, im in images.items():
            boxes, labels, segs = [], [], []
            for a in anns.get(img_id, []):
                x, y, w, h = a["bbox"]
                if w <= 0 or h <= 0:
                    continue
                boxes.append([
                    x / im["width"], y / im["height"],
                    (x + w) / im["width"], (y + h) / im["height"],
                ])
                labels.append(self.cat_to_label[a["category_id"]])
                polys = []
                seg = a.get("segmentation")
                if isinstance(seg, list):  # polygon format (no RLE crowds)
                    for p in seg:
                        q = np.asarray(p, np.float64).reshape(-1, 2)
                        q[:, 0] /= im["width"]
                        q[:, 1] /= im["height"]
                        polys.append(q.reshape(-1))
                segs.append(polys)
            self.samples.append(
                (
                    os.path.join(images_dir, im["file_name"]),
                    np.asarray(boxes, np.float32).reshape(-1, 4),
                    np.asarray(labels, np.int64),
                    img_id,
                )
            )
            self.segmentations.append(segs)

    def __len__(self):
        return len(self.samples)


class CocoSSDLoader:
    """Training loader: crop/flip augment + native decode + anchor encode."""

    def __init__(
        self,
        dataset: CocoDetectionDataset,
        batch_size: int,
        dboxes: DefaultBoxes | None = None,
        image_size: int = 300,
        train: bool = True,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        n_threads: int | None = None,
        device: str = "cpu",  # the data plane's: "cpu" or "cuda"
        rows: np.ndarray | None = None,
    ):
        """``rows``: the positions of this rank's rows in each batch (a data
        axis, ``parallel.mesh.batch_positions``): only their files are read
        and only they are yielded (``gt`` too); every row's crop and flip is
        still drawn, so each rank's rows are the one-rank run's."""
        self.rows = rows
        self.plane = DataPlane(n_threads, device)
        self.ds = dataset
        self.samples = dataset.samples[shard[0] :: shard[1]]
        self.batch_size = batch_size
        self.dboxes = dboxes or dboxes300_coco()
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        if self.train:
            return len(self.samples) // self.batch_size
        return -(-len(self.samples) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = (
            rng.permutation(len(self.samples)) if self.train
            else np.arange(len(self.samples))
        )
        bs = self.batch_size
        # train drops the remainder (reference DALI behaviour); eval pads the
        # final batch with repeats so no val image is skipped — only the real
        # rows are listed in ``gt`` for the evaluator
        n_real_total = len(order)
        if not self.train and n_real_total % bs:
            order = np.concatenate(
                [order, np.full(bs - n_real_total % bs, order[-1])]
            )
        keep = np.zeros(bs, bool)
        keep[self.rows if self.rows is not None else slice(None)] = True
        for i in range(0, len(order) - bs + 1, bs):
            n_real = min(bs, n_real_total - i)
            jpegs, crops, flips, loc_t, cls_t, gt_info = [], [], [], [], [], []
            for bi, j in enumerate(order[i : i + bs]):
                path, boxes, labels, img_id = self.samples[j]
                crop = None
                if self.train:
                    result = ssd_random_crop(boxes, labels, rng)
                    if result is not None:
                        crop, boxes, labels = result
                crop = crop or (0.0, 0.0, 1.0, 1.0)
                flip = bool(self.train and rng.random() < 0.5)
                if not keep[bi]:  # another rank's row: its draws only
                    continue
                with open(path, "rb") as f:
                    jpegs.append(f.read())
                if flip and len(boxes):
                    boxes = boxes.copy()
                    boxes[:, [0, 2]] = 1.0 - boxes[:, [2, 0]]
                crops.append(crop)
                flips.append(int(flip))
                l, c = encode(self.dboxes, boxes, labels)
                loc_t.append(l)
                cls_t.append(c)
                if bi < n_real:
                    gt_info.append((img_id, boxes, labels))
            images = self.plane.decode_batch(
                jpegs, np.asarray(crops, np.float32), np.asarray(flips, np.int32),
                self.image_size,
            )
            batch = {
                "image": images,
                "loc_targets": np.stack(loc_t),
                "cls_targets": np.stack(cls_t),
            }
            if not self.train:
                batch["gt"] = gt_info  # host-side, for the mAP evaluator
            yield batch


class CocoRawLoader:
    """COCO loader emitting the raw-box detection contract (EfficientDet /
    Mask R-CNN): ``image`` (B, S, S, 3), ``boxes`` (B, G, 4) xyxy pixels,
    ``labels`` (B, G) 0-based category ids, ``valid`` (B, G).

    Same native decode + SSD-style crop/flip augmentation as
    :class:`CocoSSDLoader`, but targets stay as padded ground-truth boxes —
    anchor matching happens on-device inside the detector's loss
    (reference EfficientDet computes targets in the model too,
    ``effdet/anchors.py AnchorLabeler``)."""

    def __init__(self, dataset: CocoDetectionDataset, batch_size: int,
                 image_size: int = 512, *, max_gt: int = 64,
                 train: bool = True, seed: int = 0,
                 shard: tuple[int, int] = (0, 1),
                 n_threads: int | None = None,
                 with_masks: bool = False, mask_grid: int = 64,
                 device: str = "cpu"):
        self.plane = DataPlane(n_threads, device)
        self.samples = dataset.samples[shard[0]::shard[1]]
        self.segmentations = dataset.segmentations[shard[0]::shard[1]]
        self.batch_size = batch_size
        self.image_size = image_size
        self.max_gt = max_gt
        self.train = train
        self.seed = seed
        self.epoch = 0
        # with_masks: Mask R-CNN mode, flip-only augmentation (the reference
        # Mask R-CNN augments with resize + flip, no SSD crop) and dense
        # per-instance grids rasterized from COCO's polygons
        self.with_masks = with_masks
        self.mask_grid = mask_grid

    def __len__(self):
        if self.train:
            return len(self.samples) // self.batch_size
        return -(-len(self.samples) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = (rng.permutation(len(self.samples)) if self.train
                 else np.arange(len(self.samples)))
        bs, s, g = self.batch_size, self.image_size, self.max_gt
        # eval pads the final batch (train drops it); ``n_valid`` tells the
        # consumer how many rows are real
        n_real_total = len(order)
        if not self.train and n_real_total % bs:
            order = np.concatenate(
                [order, np.full(bs - n_real_total % bs, order[-1])]
            )
        for i in range(0, len(order) - bs + 1, bs):
            n_real = min(bs, n_real_total - i)
            jpegs, crops, flips = [], [], []
            out_boxes = np.zeros((bs, g, 4), np.float32)
            out_labels = np.zeros((bs, g), np.int32)
            out_valid = np.zeros((bs, g), bool)
            mg = self.mask_grid
            out_masks = (np.zeros((bs, g, mg, mg), np.float32)
                         if self.with_masks else None)
            img_ids = []
            for bi, j in enumerate(order[i:i + bs]):
                path, boxes, labels, img_id = self.samples[j]
                with open(path, "rb") as f:
                    jpegs.append(f.read())
                crop = None
                if self.train and not self.with_masks:
                    result = ssd_random_crop(boxes, labels, rng)
                    if result is not None:
                        crop, boxes, labels = result
                crop = crop or (0.0, 0.0, 1.0, 1.0)
                flip = bool(self.train and rng.random() < 0.5)
                if flip and len(boxes):
                    boxes = boxes.copy()
                    boxes[:, [0, 2]] = 1.0 - boxes[:, [2, 0]]
                crops.append(crop)
                flips.append(int(flip))
                n = min(len(boxes), g)
                out_boxes[bi, :n] = boxes[:n] * s  # frac -> pixels
                # cat_to_label is 1-based (0 = background); detection tasks
                # here use 0-based category ids
                out_labels[bi, :n] = labels[:n] - 1
                out_valid[bi, :n] = True
                if self.with_masks:
                    cx, cy, cw, ch = crop
                    window = (cx, cy, cx + cw, cy + ch)
                    for k in range(n):
                        polys = self.segmentations[j][k]
                        if polys:
                            out_masks[bi, k] = rasterize_polygons(
                                polys, mg, window, flip)
                img_ids.append(img_id)
            images = self.plane.decode_batch(
                jpegs, np.asarray(crops, np.float32),
                np.asarray(flips, np.int32), s,
            )
            batch = {
                "image": images, "boxes": out_boxes,
                "labels": out_labels, "valid": out_valid,
            }
            if self.with_masks:
                batch["masks"] = out_masks
            if not self.train:
                batch["image_ids"] = np.asarray(img_ids, np.int64)
                batch["n_valid"] = n_real
            yield batch


def rasterize_polygons(polygons: list, grid: int,
                       window: tuple[float, float, float, float] = (0, 0, 1, 1),
                       flip: bool = False) -> np.ndarray:
    """Dense (grid, grid) binary mask from COCO polygons (fraction coords).

    The reference rasterizes polygons on the device
    (``csrc/cuda/generate_mask_targets.cu``); here an even-odd ray cast over
    the sample grid, evaluated inside the crop ``window`` (x0, y0, x1, y1
    fractions) with an optional horizontal flip, so that the mask sees
    exactly the augmented image the loader emits.
    """
    x0, y0, x1, y1 = window
    js = (np.arange(grid) + 0.5) / grid
    u = x0 + js * (x1 - x0)  # sample x fractions in original image
    v = y0 + js * (y1 - y0)
    if flip:
        u = u[::-1]
    px, py = np.meshgrid(u, v)  # (grid, grid)
    inside = np.zeros((grid, grid), bool)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        xs, ys = pts[:, 0], pts[:, 1]
        xs2, ys2 = np.roll(xs, -1), np.roll(ys, -1)
        crossing = np.zeros((grid, grid), np.int32)
        for ax, ay, bx, by in zip(xs, ys, xs2, ys2):
            if ay == by:
                continue
            cond = (py >= min(ay, by)) & (py < max(ay, by))
            xint = ax + (py - ay) * (bx - ax) / (by - ay)
            crossing += (cond & (px < xint)).astype(np.int32)
        inside ^= (crossing % 2).astype(bool)  # even-odd rule per polygon
    return inside.astype(np.float32)
