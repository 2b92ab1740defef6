"""Write the JPEG fixtures of the data plane's tests and of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python -m scripts.make_jpeg_fixtures [--out tests/data/jpeg]

Needs PIL (to encode) and the JAX package's data plane
(``deeplearningexamples_tpu.native``, which builds its libjpeg library with
``make`` at first use). Writes 14 JPEGs of smooth synthetic content (color
gradients, low-frequency waves, soft blobs; sizes from 64 x 48 to 500 x 375,
both orientations, one grayscale, one progressive, one cut inside its header
so that no decoder can read it) and ``expected.npz``: JAX's
``DataPlane.decode_batch`` of all of them at fixed crops and flips and
``OUT_SIZE`` (``images`` (N, OUT_SIZE, OUT_SIZE, 3) fp32, ``crops``,
``flips``, ``names``, ``failed``). The card's decode is held against it
without JAX on the card's machine.
"""

from __future__ import annotations

import argparse
import io
from pathlib import Path

import numpy as np

OUT_SIZE = 48
# (name, width, height, mode, progressive)
IMAGES = [
    ("landscape_64x48", 64, 48, "RGB", False),
    ("portrait_48x64", 48, 64, "RGB", False),
    ("square_100", 100, 100, "RGB", False),
    ("landscape_160x120", 160, 120, "RGB", False),
    ("portrait_120x160", 120, 160, "RGB", False),
    ("landscape_200x150", 200, 150, "RGB", False),
    ("portrait_150x200", 150, 200, "RGB", False),
    ("landscape_256x192", 256, 192, "RGB", False),
    ("gray_120x90", 120, 90, "L", False),
    ("progressive_180x120", 180, 120, "RGB", True),
    ("landscape_500x375", 500, 375, "RGB", False),
    ("portrait_375x500", 375, 500, "RGB", False),
    ("odd_77x53", 77, 53, "RGB", False),
]
TRUNCATED = "truncated_96x96"  # the first 150 bytes of a 96 x 96 image


def smooth_image(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients, two waves and three soft blobs a channel,
    no sharp edges (libjpeg and nvJPEG differ most at edges)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = x / max(w - 1, 1), y / max(h - 1, 1)
    img = np.empty((h, w, 3))
    for c in range(3):
        a = rng.uniform(-1, 1, 2)
        f = rng.uniform(0.5, 2.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        ch = 0.5 + 0.25 * (a[0] * u + a[1] * v)
        ch += 0.15 * np.sin(2 * np.pi * f[0] * u + ph[0]) * np.cos(
            2 * np.pi * f[1] * v + ph[1])
        for _ in range(3):
            cx, cy = rng.uniform(0, 1, 2)
            r = rng.uniform(0.1, 0.3)
            ch += rng.uniform(-0.2, 0.2) * np.exp(
                -((u - cx) ** 2 + (v - cy) ** 2) / (2 * r * r))
        img[..., c] = ch
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def encode(img: np.ndarray, mode: str, progressive: bool) -> bytes:
    from PIL import Image

    pil = Image.fromarray(img if mode == "RGB" else img[..., 0], mode)
    buf = io.BytesIO()
    pil.save(buf, "JPEG", quality=90, progressive=progressive)
    return buf.getvalue()


def crops_and_flips(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed crops (x, y, w, h fractions): the whole image, centre crops and
    off-centre rectangles in turn; every other image flipped."""
    table = [(0.0, 0.0, 1.0, 1.0), (0.125, 0.125, 0.75, 0.75),
             (0.3, 0.1, 0.6, 0.45), (0.05, 0.4, 0.5, 0.55),
             (0.2, 0.2, 0.35, 0.6)]
    crops = np.asarray([table[i % len(table)] for i in range(n)], np.float32)
    flips = (np.arange(n) % 2).astype(np.int32)
    return crops, flips


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/data/jpeg")
    args = ap.parse_args()
    from deeplearningexamples_tpu.native import DataPlane

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    names, blobs = [], []
    for i, (name, w, h, mode, progressive) in enumerate(IMAGES):
        data = encode(smooth_image(w, h, i), mode, progressive)
        names.append(name)
        blobs.append(data)
    names.append(TRUNCATED)
    blobs.append(encode(smooth_image(96, 96, 99), "RGB", False)[:150])
    for name, data in zip(names, blobs):
        (out / f"{name}.jpg").write_bytes(data)
    crops, flips = crops_and_flips(len(blobs))
    plane = DataPlane(2)
    images = plane.decode_batch(blobs, crops, flips, OUT_SIZE)
    failed = np.asarray([not np.any(im) for im in images])
    np.savez_compressed(out / "expected.npz", images=images, crops=crops,
                        flips=flips, names=np.asarray(names), failed=failed,
                        out_size=OUT_SIZE)
    total = sum(p.stat().st_size for p in out.iterdir())
    print(f"{len(blobs)} JPEGs and expected.npz in {out}: {total} bytes; "
          f"failed: {[n for n, f in zip(names, failed) if f]}")


if __name__ == "__main__":
    main()
