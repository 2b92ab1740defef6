"""Port parity: the data plane, the ImageNet reader and ``background``
against the JAX package.

The port's host plane is a copy of JAX's C++ plane built with the same g++
flags against the same libjpeg: on the same JPEGs (written here with PIL)
``jpeg_info`` and ``decode_batch`` are equal to JAX's bit for bit, and so
are ``ImageNetLoader``'s batches over two epochs, train and val, the padded
last batch included.

The card's plane (nvJPEG, then ``ops/resample``'s kernel) cannot run here.
Its plain resample is held to the host plane's own ``resample_normalize``
on decoded images within 3e-5 (the host's g++ ``-O3 -march=native``
contracts products and sums into FMAs; with ``-ffp-contract=off`` the two
are equal), and at d > 1 to the host resample of the block means. The whole
card path is emulated with PIL's full-size decode in place of nvJPEG's and
held to JAX's plane on the fixtures in ``tests/data/jpeg`` within 4 pixel
levels at most and 1.5 on average (libjpeg's ``JDCT_ISLOW`` and fancy
upsampling against ``JDCT_IFAST``, and the block mean against libjpeg's
scaled IDCT: 3.14 and 1.02 measured).

Every case skips where ``g++`` or ``jpeglib.h`` is absent, and says so.
"""

import io
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.data.imagenet import ImageNetLoader as JaxLoader
from deeplearningexamples_tpu.native import DataPlane as JaxPlane
from deeplearningexamples_tpu_torch.data.imagenet import (
    ImageNetLoader,
    center_crop_fractions,
    sample_rrc_pixels,
)
from deeplearningexamples_tpu_torch.data.jpeg_trees import imagenet_tree
from deeplearningexamples_tpu_torch.data.prefetch import background
from deeplearningexamples_tpu_torch.native import (
    MEAN,
    STD,
    DataPlane,
    pack_batch,
    resample_host,
)
from deeplearningexamples_tpu_torch.ops.resample import (
    resample_normalize,
    resample_normalize_reference,
)
from torch_threads import torch_one_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
HOST_TOL = 3e-5  # the host plane's FMA contractions, normalized units
EMU_TOL = (4.0, 1.5)  # PIL's decode against IFAST: (max, mean) pixel levels


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


def _jpeg(rng, w, h, mode="RGB", progressive=False) -> bytes:
    from PIL import Image

    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    img = np.clip(img.astype(int) // 2 + np.linspace(0, 120, w)[None, :, None],
                  0, 255).astype(np.uint8)
    pil = Image.fromarray(img if mode == "RGB" else img[..., 0], mode)
    buf = io.BytesIO()
    pil.save(buf, "JPEG", quality=85, progressive=progressive)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jpegs():
    rng = np.random.default_rng(0)
    return [_jpeg(rng, 64, 48), _jpeg(rng, 48, 80), _jpeg(rng, 300, 200),
            _jpeg(rng, 90, 90, "L"), _jpeg(rng, 120, 70, progressive=True),
            _jpeg(rng, 257, 131)]


def test_jpeg_info_equals_jax(jpegs):
    ours, theirs = DataPlane(2), JaxPlane(2)
    assert [ours.jpeg_info(j) for j in jpegs] == \
        [theirs.jpeg_info(j) for j in jpegs]
    with pytest.raises(ValueError):
        ours.jpeg_info(b"not a jpeg")


@pytest.mark.parametrize("norm", ["imagenet", "unit"])
@pytest.mark.parametrize("out_size", [24, 224])
def test_decode_batch_equals_jax(jpegs, norm, out_size):
    """Crops from the whole image to a small off-centre window (libjpeg's
    1/2, 1/4 and 1/8 decodes at out_size 24), flips, both mean/std."""
    rng = np.random.default_rng(1)
    n = len(jpegs)
    crops = np.stack([rng.uniform(0, 0.3, n), rng.uniform(0, 0.3, n),
                      rng.uniform(0.2, 0.7, n), rng.uniform(0.2, 0.7, n)], 1)
    crops[0] = (0, 0, 1, 1)
    flips = rng.integers(0, 2, n)
    mean, std = (MEAN, STD) if norm == "imagenet" else ((0, 0, 0), (1, 1, 1))
    got = DataPlane(3).decode_batch(jpegs, crops, flips, out_size, mean, std)
    want = JaxPlane(3).decode_batch(jpegs, crops, flips, out_size, mean, std)
    assert got.dtype == np.float32 and got.shape == (n, out_size, out_size, 3)
    np.testing.assert_array_equal(got, want)


def test_corrupt_file_is_zero_filled_with_a_warning(jpegs):
    batch = [jpegs[0], b"\xff\xd8\xff not a jpeg", jpegs[1][:100]]
    crops = np.tile(np.float32([0, 0, 1, 1]), (3, 1))
    with pytest.warns(UserWarning, match="2 images failed to decode"):
        got = DataPlane(2).decode_batch(batch, crops, np.zeros(3), 16)
    assert not got[1:].any() and got[0].any()


def _tree(tmp_path_factory, seed):
    rng = np.random.default_rng(seed)
    root = tmp_path_factory.mktemp("jpegs")
    files = []
    for i, (w, h) in enumerate([(64, 48), (48, 64), (100, 70), (70, 100),
                                (90, 90)]):
        f = root / f"{i}.jpg"
        f.write_bytes(_jpeg(rng, w, h))
        files.append(f)
    # 3 classes x 5 train files, 3 x 3 val files: a val batch of 4 pads
    return imagenet_tree(files, root / "imagenet", 3, 5, 3)


@pytest.mark.parametrize("split", ["train", "val"])
def test_imagenet_loader_equals_jax(tmp_path_factory, split):
    """Epochs 0 and 1: the same labels and images, batch for batch, the
    val epoch's last batch padded by wrapping round."""
    root = str(_tree(tmp_path_factory, 2))
    ours = ImageNetLoader(root, split, 4, image_size=32, seed=3, n_threads=2)
    theirs = JaxLoader(root, split, 4, image_size=32, seed=3, n_threads=2,
                       shard=(0, 1))
    assert len(ours) == len(theirs) == (3 if split == "train" else 3)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["label"], w["label"])
            np.testing.assert_array_equal(g["image"], w["image"])
    if split == "val":  # 9 files: the last batch is files 8, 0, 1, 2
        assert list(got[-1]["label"]) == [2, 0, 0, 0]


def test_crop_geometry_equals_jax():
    from deeplearningexamples_tpu.data import imagenet as jax_imagenet

    for w, h in [(500, 375), (375, 500), (64, 640), (640, 64), (100, 100)]:
        a, b = np.random.default_rng(w), np.random.default_rng(w)
        for _ in range(20):
            assert sample_rrc_pixels(a, w, h) == \
                jax_imagenet.sample_rrc_pixels(b, w, h)
        assert center_crop_fractions(w, h, 224) == \
            jax_imagenet.center_crop_fractions(w, h, 224)


def test_background_keeps_order_and_reraises():
    assert list(background(iter(range(50)), depth=2)) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for x in background(failing()):
            got.append(x)
    assert got == [1, 2]


def _packed(images):
    infos = [(im.shape[1], im.shape[0], im.shape[2]) for im in images]
    return infos, torch.from_numpy(np.concatenate([im.ravel() for im in images]))


def test_plain_resample_equals_the_host_resample():
    """d = 1: the plain version against the host plane's resample on the
    same decoded image; d = 2 and 4: against the host resample of the block
    means, each rounded to the nearest byte."""
    rng = np.random.default_rng(4)
    worst = 0.0
    for t in range(12):
        h, w = rng.integers(9, 90, 2)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        crop = np.float32([rng.uniform(0, .3), rng.uniform(0, .3),
                           rng.uniform(.3, .7), rng.uniform(.3, .7)])
        d, s, flip = (1, 2, 4)[t % 3], int(rng.integers(4, 40)), t % 2
        sh, sw = -(-h // d), -(-w // d)
        pad = np.zeros((sh * d, sw * d, 3), np.int64)
        pad[:h, :w] = img
        cnt = np.zeros((sh * d, sw * d), np.int64)
        cnt[:h, :w] = 1
        sums = pad.reshape(sh, d, sw, d, 3).sum((1, 3))
        cnt = cnt.reshape(sh, d, sw, d).sum((1, 3))[..., None]
        means = ((sums + cnt // 2) // cnt).astype(np.uint8)
        want = resample_host(means, crop, bool(flip), s)
        got = resample_normalize(
            torch.from_numpy(img.ravel()), torch.zeros(1, dtype=torch.int64),
            torch.tensor([[w, h, 3, d]], dtype=torch.int32),
            torch.from_numpy(crop[None]), torch.tensor([flip], dtype=torch.int32),
            s, MEAN, STD)[0]
        worst = max(worst, float(np.abs(got.numpy() - want).max()))
    assert worst <= HOST_TOL


def test_plain_resample_replicates_gray_and_zero_fills():
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (20, 30, 1), dtype=np.uint8)
    rgb = np.repeat(gray, 3, axis=2)
    infos, src = _packed([gray, rgb])
    dims, offsets, _ = pack_batch(infos + [None], np.tile(
        np.float32([0, 0, 1, 1]), (3, 1)), 16)
    out = resample_normalize_reference(
        src, torch.from_numpy(offsets), torch.from_numpy(dims),
        torch.tile(torch.tensor([0.0, 0.0, 1.0, 1.0]), (3, 1)),
        torch.zeros(3, dtype=torch.int32), 16, MEAN, STD)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    assert not out[2].any()


def test_card_path_emulated_with_pil_is_near_jax_on_the_fixtures():
    """The card plane's bookkeeping (``pack_batch``: each image's 1/d, the
    packed layout) and the plain resample, on PIL's full-size decode of the
    fixtures, against ``expected.npz`` (JAX's plane), in pixel levels."""
    from PIL import Image

    e = np.load(FIXTURES / "expected.npz")
    s = int(e["out_size"])
    infos, images = [], []
    for name in e["names"]:
        try:
            im = Image.open(FIXTURES / f"{name}.jpg")
            im.load()
        except OSError:
            infos.append(None)
            continue
        a = np.asarray(im)
        a = a[..., None] if a.ndim == 2 else a
        infos.append((a.shape[1], a.shape[0], a.shape[2]))
        images.append(a)
    dims, offsets, total = pack_batch(infos, e["crops"], s)
    src = torch.from_numpy(np.concatenate([a.ravel() for a in images]))
    assert src.numel() == total
    assert sorted(set(dims[:, 3])) == [0, 1, 2, 4]  # the 1/d seen, 0: unread
    out = resample_normalize(src, torch.from_numpy(offsets),
                             torch.from_numpy(dims),
                             torch.from_numpy(e["crops"]),
                             torch.from_numpy(e["flips"]), s, MEAN, STD)
    levels = np.abs(out.numpy() - e["images"]) * np.float32(STD) * 255
    assert levels.max() <= EMU_TOL[0] and levels.mean() <= EMU_TOL[1]
    assert list(e["failed"]) == [d[0] == 0 for d in dims]


def test_fixtures_decode_on_the_host_plane_as_expected_npz():
    e = np.load(FIXTURES / "expected.npz")
    blobs = [(FIXTURES / f"{n}.jpg").read_bytes() for n in e["names"]]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = DataPlane(2).decode_batch(blobs, e["crops"], e["flips"],
                                        int(e["out_size"]))
    np.testing.assert_array_equal(got, e["images"])
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20
