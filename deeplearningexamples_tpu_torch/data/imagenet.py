"""Port of ``deeplearningexamples_tpu/data/imagenet.py``: the ImageNet input
pipeline (DALI-equivalent).

Mirrors the reference's DALI pipelines (``image_classification/
dataloaders.py``: ``HybridTrainPipe`` :80-154 with RandomResizedCrop
:128-136 + CropMirrorNormalize :138-145; ``HybridValPipe`` :157-205 resize-
shorter-256 + center-crop): the data plane (``native``) decodes, crops,
resizes, flips and normalizes; this module owns dataset listing, sharding,
shuffling and the RRC draws, in JAX's order, so the same files give the same
batches. ``device`` picks the plane: the host's C++ plane (``"cpu"``: numpy
images) or nvJPEG and the resample kernel on the card (``"cuda"``: images on
the card).

Crop geometry is computed in PIXEL space per image (torchvision/DALI
semantics): the aspect ratio of the sampled region is a real pixel aspect,
and the val path crops a square of ``shorter_side * image_size/resize_size``
pixels. JPEG dimensions come from a header parse (``jpeg_info``), cached.

For decode/compute overlap wrap the loader in ``data.prefetch.background``.
``shard`` defaults to ``(0, 1)``: ``torch.distributed`` is not ported.

Layout: standard ``train/<wnid>/*.JPEG`` class folders.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..native import MEAN, STD, DataPlane

__all__ = ["ImageNetLoader", "sample_rrc_pixels", "center_crop_fractions"]

def sample_rrc_pixels(
    rng: np.random.Generator,
    width: int,
    height: int,
    scale=(0.08, 1.0),
    ratio=(3 / 4, 4 / 3),
) -> tuple[float, float, float, float]:
    """RandomResizedCrop in pixel space (torchvision ``get_params``): sample
    target area and log-uniform aspect, accept if it fits; fall back to the
    largest center crop within the ratio bounds. Returns per-axis fractions
    (x, y, w, h) for the data plane."""
    area = width * height
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            x = rng.integers(0, width - w + 1)
            y = rng.integers(0, height - h + 1)
            return (x / width, y / height, w / width, h / height)
    # fallback: clamp aspect, center
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    x, y = (width - w) // 2, (height - h) // 2
    return (x / width, y / height, w / width, h / height)


def center_crop_fractions(
    width: int, height: int, image_size: int, resize_size: int | None = None
) -> tuple[float, float, float, float]:
    """Val geometry: resize-shorter-to-``resize_size`` then center-crop
    ``image_size`` ≡ center-crop a SQUARE of ``shorter * image_size/resize``
    pixels from the original, then resize to ``image_size``."""
    resize_size = resize_size or int(round(image_size * 256 / 224))
    side = min(width, height) * image_size / resize_size
    return (
        (width - side) / 2 / width,
        (height - side) / 2 / height,
        side / width,
        side / height,
    )


class ImageNetLoader:
    """Iterates {"image": (B, S, S, 3) f32, "label": (B,) i32} batches: the
    label numpy, the image numpy on the host plane, on the card on the
    card's."""

    def __init__(
        self,
        data_dir: str,
        split: str,
        batch_size: int,
        image_size: int = 224,
        seed: int = 0,
        drop_last: bool | None = None,  # default: True for train, False val
        n_threads: int | None = None,
        shard: tuple[int, int] = (0, 1),  # (index, count)
        device: str = "cpu",  # the data plane's: "cpu" or "cuda"
        rows: np.ndarray | None = None,
    ):
        """``rows``: the positions of this rank's rows in each batch (a data
        axis, ``parallel.mesh.batch_positions``): only their files are
        decoded and only they are yielded; the other rows' crops and flips
        are still drawn, from the dimensions in their files' headers (read
        once a file), so each rank's rows are the one-rank run's."""
        self.rows = rows
        self.plane = DataPlane(n_threads, device)
        self.batch_size = batch_size
        self.image_size = image_size
        self.split = split
        self.seed = seed
        self.epoch = 0

        root = os.path.join(data_dir, split)
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith((".jpeg", ".jpg")):
                    samples.append((os.path.join(cdir, f), self.class_to_idx[c]))
        idx, count = shard
        self.samples = samples[idx::count]
        self.drop_last = drop_last if drop_last is not None else (split == "train")
        self._dims: dict[int, tuple[int, int]] = {}  # sample idx -> (w, h)

    def __len__(self) -> int:
        n = len(self.samples) // self.batch_size
        return n if self.drop_last else -(-len(self.samples) // self.batch_size)

    def _dims_of(self, i: int, data: bytes) -> tuple[int, int]:
        wh = self._dims.get(i)
        if wh is None:
            try:
                wh = self.plane.jpeg_info(data)
            except ValueError:
                wh = (self.image_size, self.image_size)  # corrupt: zero-fill later
            self._dims[i] = wh
        return wh

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = rng.permutation(len(self.samples)) if self.split == "train" else (
            np.arange(len(self.samples))
        )
        bs = self.batch_size
        if not self.drop_last and len(order) % bs:
            # pad the final batch by wrapping (DALI pad_last_batch role);
            # keeps eval shapes static, duplicates < bs samples
            pad = bs - len(order) % bs
            order = np.concatenate([order, order[:pad]])
        keep = np.zeros(bs, bool)
        keep[self.rows if self.rows is not None else slice(None)] = True
        for start in range(0, len(order) - bs + 1, bs):
            batch_idx = order[start : start + bs]
            jpegs, labels, crops = [], [], []
            for k, i in enumerate(batch_idx):
                path, label = self.samples[i]
                data = b""
                if keep[k] or int(i) not in self._dims:
                    with open(path, "rb") as f:
                        data = f.read()
                if keep[k]:
                    jpegs.append(data)
                    labels.append(label)
                w, h = self._dims_of(int(i), data)
                if self.split == "train":
                    crops.append(sample_rrc_pixels(rng, w, h))
                else:
                    crops.append(center_crop_fractions(w, h, self.image_size))
            flips = (
                (rng.random(bs) < 0.5).astype(np.int32)
                if self.split == "train"
                else np.zeros(bs, np.int32)
            )
            images = self.plane.decode_batch(
                jpegs, np.asarray(crops, np.float32)[keep], flips[keep],
                self.image_size, MEAN, STD,
            )
            yield {"image": images, "label": np.asarray(labels, np.int32)}
