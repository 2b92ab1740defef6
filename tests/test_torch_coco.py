"""Port parity: the COCO readers against the JAX package, and the real-data
paths of ``ssd300`` and ``resnet50`` through the port's CLI.

The port's ``data/coco.py`` is JAX's with the port's data plane: on a COCO
tree of the JPEG fixtures (``tests/data/jpeg``, the cut one in the val
split, zero-filled with a warning) the dataset, the SSD crop under the same
generator, and every batch of ``CocoSSDLoader`` (image, ``loc_targets``,
``cls_targets``, ``gt``) and ``CocoRawLoader`` (image, boxes, labels,
valid, ``n_valid``) are equal to JAX's, train and eval, over two epochs.
The host plane is JAX's plane bit for bit (``tests/test_torch_dataplane.py``),
so the images are held to equality too. The CLI runs two steps of each command at a small size on the
CPU and logs ``mAP`` and ``top1``.
"""

import dataclasses
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest

from deeplearningexamples_tpu.data import coco as jax_coco
from deeplearningexamples_tpu.models.ssd.boxes import (
    dboxes300_coco as jax_dboxes,
)
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.data import coco
from deeplearningexamples_tpu_torch.data.jpeg_trees import coco_tree, imagenet_tree
from deeplearningexamples_tpu_torch.models.convnets import ARCHS
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.ops import resample
from torch_threads import torch_one_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


@pytest.fixture(autouse=True, scope="module")
def toolchain():
    missing = [what for what, ok in (
        ("g++", shutil.which("g++")),
        ("jpeglib.h", any(Path(d, "jpeglib.h").exists()
                          for d in ("/usr/include", "/usr/local/include"))))
        if not ok]
    if missing:
        pytest.skip(f"the host data plane needs {' and '.join(missing)}, "
                    "which this host lacks")


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    jpegs = sorted(FIXTURES.glob("*.jpg"))
    return coco_tree(jpegs, tmp_path_factory.mktemp("coco"), 10, 5, seed=1)


def _datasets(tree, split):
    args = (str(tree / f"{split}2017"),
            str(tree / "annotations" / f"instances_{split}2017.json"))
    return coco.CocoDetectionDataset(*args), jax_coco.CocoDetectionDataset(*args)


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_equals_jax(tree, split):
    ours, theirs = _datasets(tree, split)
    assert len(ours) == len(theirs) == (10 if split == "train" else 5)
    assert ours.cat_to_label == theirs.cat_to_label == {1: 1, 3: 2, 18: 3}
    for a, b in zip(ours.samples, theirs.samples):
        assert a[0] == b[0] and a[3] == b[3]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert json.loads(json.dumps(ours.segmentations, default=list)) == \
        json.loads(json.dumps(theirs.segmentations, default=list))


def test_ssd_random_crop_equals_jax():
    rng = np.random.default_rng(0)
    for trial in range(40):
        n = trial % 4  # no boxes at all in every fourth
        lt = rng.uniform(0, 0.6, (n, 2))
        boxes = np.concatenate([lt, lt + rng.uniform(0.05, 0.4, (n, 2))],
                               1).astype(np.float32)
        labels = rng.integers(1, 81, n)
        a, b = np.random.default_rng(trial), np.random.default_rng(trial)
        got = coco.ssd_random_crop(boxes, labels, a)
        want = jax_coco.ssd_random_crop(boxes, labels, b)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        assert a.random() == b.random()  # the same draws were taken


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "gt":
                assert len(g[k]) == len(w[k])
                for x, y in zip(g[k], w[k]):
                    assert x[0] == y[0]
                    np.testing.assert_array_equal(x[1], y[1])
                    np.testing.assert_array_equal(x[2], y[2])
            else:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ssd_loader_equals_jax(tree, train):
    ours_ds, theirs_ds = _datasets(tree, "train" if train else "val")
    ours = coco.CocoSSDLoader(ours_ds, 4, train=train, seed=2, n_threads=2)
    theirs = jax_coco.CocoSSDLoader(theirs_ds, 4, jax_dboxes(), train=train,
                                    seed=2, n_threads=2)
    assert len(ours) == len(theirs) == (2 if train else 2)
    for _ in range(2):  # epochs 0 and 1
        got, want = list(ours), list(theirs)
        _equal_batches(got, want)
    assert got[0]["image"].shape == (4, 300, 300, 3)
    if not train:  # 5 val images: the second batch has one real row
        assert [len(b["gt"]) for b in got] == [4, 1]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_raw_loader_equals_jax(tree, train):
    ours_ds, theirs_ds = _datasets(tree, "train" if train else "val")
    ours = coco.CocoRawLoader(ours_ds, 3, 64, max_gt=8, train=train, seed=5,
                              n_threads=2)
    theirs = jax_coco.CocoRawLoader(theirs_ds, 3, 64, max_gt=8, train=train,
                                    seed=5, n_threads=2)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        _equal_batches(got, want)
    assert got[0]["boxes"].shape == (3, 8, 4)
    if not train:
        assert [b["n_valid"] for b in got] == [3, 2]


def test_mask_rcnn_mode_is_refused(tree):
    """Mask R-CNN's mode is ported: on annotations without polygons its
    masks are empty and every other key is JAX's
    (``tests/test_torch_maskrcnn.py`` holds it on polygons)."""
    ours_ds, theirs_ds = _datasets(tree, "val")
    ours = coco.CocoRawLoader(ours_ds, 2, 64, with_masks=True, train=False)
    theirs = jax_coco.CocoRawLoader(theirs_ds, 2, 64, with_masks=True,
                                    train=False)
    got, want = list(ours), list(theirs)
    _equal_batches(got, want)
    assert all(b["masks"].shape == (2, 64, 64, 64) and not b["masks"].any()
               for b in got)


def _raport(path: Path) -> list[dict]:
    return [json.loads(line[len("DLLL "):])["data"]
            for line in path.read_text().splitlines()
            if line.startswith("DLLL ") and '"data"' in line]


def test_cli_ssd300_on_coco_logs_map(tree, tmp_path):
    """Two training steps (10 images at B=5) at full width, then the eval
    epoch's COCO mAP on val2017, watched as the best checkpoint's
    metric."""
    before = (fa.launches, resample.launches)
    state, best = cli(["ssd300", "--data-backend", "coco", "--data-dir",
                       str(tree), "--batch-size", "5", "--device", "cpu",
                       "--workspace", str(tmp_path)])
    assert (fa.launches, resample.launches) == before
    assert state.step == 2
    rows = _raport(tmp_path / "ssd300_raport.json")
    losses = [r["train.loss"] for r in rows if "train.loss" in r]
    val = [r for r in rows if "val.mAP" in r]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert len(val) == 1 and 0.0 <= val[0]["val.mAP"] <= 1.0
    assert best == val[0]["val.mAP"]


def test_cli_resnet50_on_imagenet_logs_top1(tmp_path, monkeypatch):
    """ResNet-50 at widths 8 on class folders of the fixtures: two steps
    (8 training files at B=4) and the val pass (3 files, one padded batch)
    through ``background``."""
    monkeypatch.setitem(ARCHS, "resnet50", dataclasses.replace(
        ARCHS["resnet50"], layers=(1, 1, 1, 1), widths=(8, 8, 8, 8)))
    jpegs = sorted(FIXTURES.glob("*.jpg"))[:-1]
    root = imagenet_tree(jpegs, tmp_path / "imagenet", 2, 4, 1)
    (root / "val" / "n00000001" / "extra.JPEG").write_bytes(jpegs[0].read_bytes())
    state, best = cli(["resnet50", "--data-backend", "imagenet", "--data-dir",
                       str(root), "--batch-size", "4", "--device", "cpu",
                       "--workspace", str(tmp_path / "ws")])
    assert state.step == 2
    rows = _raport(tmp_path / "ws" / "resnet50_raport.json")
    losses = [r["train.loss"] for r in rows if "train.loss" in r]
    val = [r for r in rows if "val.top1" in r]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert len(val) == 1 and best == val[0]["val.top1"]
    assert {"val.top5", "val.val_loss"} <= set(val[0])
