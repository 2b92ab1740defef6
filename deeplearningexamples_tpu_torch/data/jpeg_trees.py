"""ImageNet- and COCO-format trees around a handful of JPEGs, for smoke runs
and tests of the real-data readers without the real sets.

``imagenet_tree`` lays out ``train/<class>/*.JPEG`` and ``val/<class>/*.JPEG``
(``data/imagenet.py``'s layout), ``coco_tree`` ``train2017/``, ``val2017/``
and ``annotations/instances_{train,val}2017.json`` with a few boxes on each
image (``data/coco.py``'s). The files are hard links to the given JPEGs
(copies where a link cannot be made), taken in turn.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from pathlib import Path

import numpy as np

__all__ = ["coco_tree", "imagenet_tree", "jpeg_size"]

# COCO category ids the trees use (person, car, dog)
CATEGORIES = (1, 3, 18)


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's SOF marker; ``ValueError`` if there is
    none."""
    i = 2
    while i + 9 <= len(data):
        if data[i] != 0xFF:
            raise ValueError("not a JPEG marker")
        marker = data[i + 1]
        (length,) = struct.unpack(">H", data[i + 2:i + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return w, h
        i += 2 + length
    raise ValueError("no SOF marker")


def _place(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def imagenet_tree(jpegs: list[Path], root: Path, n_classes: int,
                  train_per_class: int, val_per_class: int) -> Path:
    """``root`` with ``n_classes`` class folders in ``train/`` and ``val/``;
    returns ``root``."""
    k = 0
    for split, per in (("train", train_per_class), ("val", val_per_class)):
        for c in range(n_classes):
            for j in range(per):
                _place(jpegs[k % len(jpegs)],
                       root / split / f"n{c:08d}" / f"{split}_{c}_{j}.JPEG")
                k += 1
    return root


def coco_tree(jpegs: list[Path], root: Path, n_train: int, n_val: int,
              seed: int = 0, polygons: bool = False) -> Path:
    """``root`` in COCO's layout with 1-3 boxes (categories ``CATEGORIES``)
    on each readable image; an unreadable JPEG is listed with no boxes.
    With ``polygons`` each box carries a ``segmentation``: the diamond
    through the midpoints of its sides (Mask R-CNN's masks). Returns
    ``root``."""
    rng = np.random.default_rng(seed)
    k = 0
    for split, n in (("train", n_train), ("val", n_val)):
        images, anns = [], []
        for i in range(n):
            src = jpegs[k % len(jpegs)]
            k += 1
            name = f"{i:012d}.jpg"
            _place(src, root / f"{split}2017" / name)
            try:
                w, h = jpeg_size(src.read_bytes())
            except (ValueError, struct.error):
                w = h = 0
            images.append({"id": i + 1, "file_name": name,
                           "width": max(w, 1), "height": max(h, 1)})
            for _ in range(int(rng.integers(1, 4)) if w else 0):
                bw, bh = rng.uniform(0.2, 0.6) * w, rng.uniform(0.2, 0.6) * h
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(rng.choice(CATEGORIES)),
                             "bbox": [x, y, bw, bh], "area": bw * bh,
                             "iscrowd": 0})
                if polygons:
                    anns[-1]["segmentation"] = [[
                        x + bw / 2, y, x + bw, y + bh / 2, x + bw / 2,
                        y + bh, x, y + bh / 2]]
        doc = {"images": images, "annotations": anns,
               "categories": [{"id": c, "name": f"c{c}"} for c in CATEGORIES]}
        ann = root / "annotations" / f"instances_{split}2017.json"
        ann.parent.mkdir(parents=True, exist_ok=True)
        ann.write_text(json.dumps(doc))
    return root
