"""Port of ``deeplearningexamples_tpu/native/__init__.py``: the data plane,
batch JPEG decode + crop + resize + flip + normalize.

``DataPlane(n_threads, device)`` keeps JAX's API (``jpeg_info``,
``decode_batch(jpegs, crops, flips, out_size, mean, std)``) on two designs:

- ``device="cpu"``: the port's copy of JAX's C++ plane
  (``native/dataplane.cc``: libjpeg with ``JDCT_IFAST`` and the DCT-domain
  1/2^k downscale, the fused resample, a pthread pool), built with g++ at
  first use into ``_build/`` by ``ops/_build.build_host``. ``decode_batch``
  returns a numpy array. JAX's own ``libdlxdata.so`` is never loaded.
- ``device="cuda"``: for a host without libjpeg (the H100 machine the port is
  measured on has none, only the CUDA toolkit's nvJPEG). nvJPEG decodes each
  image whole on the card (``csrc/nvjpeg_decode.cu``, ``n_threads`` host
  threads), and the resample kernel (``ops/resample.resample_normalize``)
  crops, resizes, flips and normalizes the batch in one launch, with the host
  plane's geometry; libjpeg's scaled decode is stood in by a block mean.
  ``decode_batch`` returns a tensor on the card.

Both zero-fill an image that fails to decode and warn (``UserWarning``), as
JAX's does. A missing compiler, header or library raises an error that names
it; there is no quiet fallback, and no PIL path. Nothing is built or loaded
when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = ["DataPlane", "MEAN", "STD", "pack_batch", "resample_host",
           "scale_denom"]

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

_SRC = Path(__file__).resolve().parent / "dataplane.cc"
_lock = threading.Lock()
_lib = None


def _load_host() -> ctypes.CDLL:
    """The host plane's library, built on the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..ops._build import build_host

        lib = ctypes.CDLL(str(build_host(_SRC, ("-ljpeg", "-lpthread"))))
        lib.dlx_jpeg_info.restype = ctypes.c_int
        lib.dlx_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.dlx_pool_create.restype = ctypes.c_void_p
        lib.dlx_pool_create.argtypes = [ctypes.c_int]
        lib.dlx_pool_destroy.restype = None
        lib.dlx_pool_destroy.argtypes = [ctypes.c_void_p]
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.dlx_pool_decode_batch.restype = ctypes.c_int
        lib.dlx_pool_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), f32, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, f32, f32, f32,
        ]
        lib.dlx_resample_normalize.restype = None
        lib.dlx_resample_normalize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, *[ctypes.c_float] * 4,
            ctypes.c_int, ctypes.c_int, f32, f32, f32,
        ]
        _lib = lib
        return lib


def scale_denom(width: int, height: int, crop_w: float, crop_h: float,
                out_size: int) -> int:
    """The 1/d at which the host plane has libjpeg decode an image
    (``dataplane.cc`` ``dlx_decode_rrc`` and ``decode_jpeg``): the largest
    power of two up to 8 that leaves it at least ``out_size / crop`` on both
    axes, computed in fp32 as there."""
    f32 = np.float32
    min_w = min(int(f32(out_size) / max(f32(crop_w), f32(1e-6))), 1 << 14)
    min_h = min(int(f32(out_size) / max(f32(crop_h), f32(1e-6))), 1 << 14)
    d = 1
    if min_w > 0 and min_h > 0:
        while d < 8 and width // (d * 2) >= min_w and height // (d * 2) >= min_h:
            d *= 2
    return d


def resample_host(image: np.ndarray, crop, flip: bool, out_size: int,
                  mean=MEAN, std=STD) -> np.ndarray:
    """The host plane's ``resample_normalize`` alone, on a decoded (H, W, 3)
    uint8 image: (out_size, out_size, 3) fp32."""
    lib = _load_host()
    image = np.ascontiguousarray(image, np.uint8)
    h, w, _ = image.shape
    out = np.empty((out_size, out_size, 3), np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.dlx_resample_normalize(image.ctypes.data, w, h, *map(float, crop),
                               out_size, int(flip), mean.ctypes.data_as(f32),
                               std.ctypes.data_as(f32), out.ctypes.data_as(f32))
    return out


def pack_batch(infos: list, crops: np.ndarray, out_size: int
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """The card plane's layout of a batch: from each image's ``(w, h, c)``
    (None where the header does not parse) and crop, ``dims`` (N, 4) int32
    ``w, h, c, d`` (all 0 for an image that cannot be read; ``d`` by
    ``scale_denom``), the byte ``offsets`` (N,) int64 of each decoded image
    in the packed buffer, and the buffer's size."""
    n = len(infos)
    dims = np.zeros((n, 4), np.int32)
    for i, got in enumerate(infos):
        if got is not None:
            w, h, c = got
            dims[i] = (w, h, c, scale_denom(w, h, crops[i, 2], crops[i, 3],
                                            out_size))
    sizes = dims[:, 0].astype(np.int64) * dims[:, 1] * dims[:, 2]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return dims, offsets, int(sizes.sum())


class _HostPlane:
    def __init__(self, n_threads: int):
        self.lib = _load_host()
        self.pool = self.lib.dlx_pool_create(n_threads)

    def close(self) -> None:
        if self.pool:
            self.lib.dlx_pool_destroy(self.pool)
            self.pool = None

    def jpeg_info(self, data: bytes) -> tuple[int, int]:
        w, h = ctypes.c_int(), ctypes.c_int()
        if self.lib.dlx_jpeg_info(data, len(data), ctypes.byref(w),
                                  ctypes.byref(h)) != 0:
            raise ValueError("not a decodable JPEG")
        return w.value, h.value

    def decode_batch(self, jpegs, crops, flips, out_size, mean, std):
        n = len(jpegs)
        out = np.empty((n, out_size, out_size, 3), np.float32)
        f32 = ctypes.POINTER(ctypes.c_float)
        mean = np.asarray(mean, np.float32)
        std = np.asarray(std, np.float32)
        failures = self.lib.dlx_pool_decode_batch(
            self.pool, n, (ctypes.c_char_p * n)(*jpegs),
            (ctypes.c_size_t * n)(*[len(j) for j in jpegs]),
            crops.ctypes.data_as(f32),
            flips.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), out_size,
            mean.ctypes.data_as(f32), std.ctypes.data_as(f32),
            out.ctypes.data_as(f32))
        return out, failures


class _CardPlane:
    """nvJPEG on the card, then the resample kernel, on a stream of the
    plane's own. A call returns once its work there has run:
    it never waits for the caller's queued work (a training step on the
    default stream, when a producer thread calls it), and its tensors are
    ready for any stream."""

    def __init__(self, n_threads: int):
        import torch

        from ..ops._build import load

        lib = load("dataplane")
        lib.dlx_nvjpeg_create.restype = ctypes.c_void_p
        lib.dlx_nvjpeg_create.argtypes = [ctypes.c_int]
        lib.dlx_nvjpeg_destroy.restype = None
        lib.dlx_nvjpeg_destroy.argtypes = [ctypes.c_void_p]
        i32 = ctypes.POINTER(ctypes.c_int)
        lib.dlx_nvjpeg_info.restype = ctypes.c_int
        lib.dlx_nvjpeg_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_size_t, i32, i32, i32]
        lib.dlx_nvjpeg_decode_batch.restype = ctypes.c_int
        lib.dlx_nvjpeg_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        self.lib = lib
        self.stream = torch.cuda.Stream()
        self.pool = lib.dlx_nvjpeg_create(n_threads)
        if not self.pool:
            raise RuntimeError("nvJPEG could not create its decoder "
                               "(nvjpegCreateSimple)")

    def close(self) -> None:
        if self.pool:
            self.lib.dlx_nvjpeg_destroy(self.pool)
            self.pool = None

    def info(self, data: bytes) -> tuple[int, int, int] | None:
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if self.lib.dlx_nvjpeg_info(self.pool, data, len(data), ctypes.byref(w),
                                    ctypes.byref(h), ctypes.byref(c)) != 0:
            return None
        return w.value, h.value, c.value

    def jpeg_info(self, data: bytes) -> tuple[int, int]:
        got = self.info(data)
        if got is None:
            raise ValueError("not a decodable JPEG")
        return got[:2]

    def _own_stream(self, work):
        """``work()``'s tensors, made on the plane's stream and waited for;
        each marked as used by the caller's stream, so that its memory is
        not handed out again while the caller's queued work may read it."""
        import torch

        caller = torch.cuda.current_stream()
        with torch.cuda.stream(self.stream):
            outs = work()
        self.stream.synchronize()
        for t in outs:
            if isinstance(t, torch.Tensor):
                t.record_stream(caller)
        return outs

    def _decode(self, jpegs, crops, out_size):
        import torch

        n = len(jpegs)
        dims, offsets, total = pack_batch([self.info(j) for j in jpegs], crops,
                                          out_size)
        src = torch.empty(max(total, 1), dtype=torch.uint8, device="cuda")
        failed = np.zeros(n, np.int32)
        whc = np.ascontiguousarray(dims[:, :3])
        rc = self.lib.dlx_nvjpeg_decode_batch(
            self.pool, n, (ctypes.c_char_p * n)(*jpegs),
            (ctypes.c_size_t * n)(*[len(j) for j in jpegs]), whc.ctypes.data,
            src.data_ptr(), offsets.ctypes.data, failed.ctypes.data)
        if rc < 0:
            raise RuntimeError("nvJPEG batch decode: no current CUDA device")
        dims[failed.astype(bool), 0] = 0
        return (src, torch.from_numpy(offsets).cuda(),
                torch.from_numpy(dims).cuda(), int(failed.sum()))

    def decode(self, jpegs, crops, out_size):
        """nvJPEG's decode of a batch into one packed buffer on the card:
        (src uint8, offsets (N,) int64, dims (N, 4) int32, failures) as
        ``ops.resample.resample_normalize`` takes them; an image that
        fails has its width set to 0."""
        return self._own_stream(lambda: self._decode(jpegs, crops, out_size))

    def decode_batch(self, jpegs, crops, flips, out_size, mean, std):
        import torch

        from ..ops.resample import resample_normalize

        def work():
            src, offsets, dims, failures = self._decode(jpegs, crops, out_size)
            out = resample_normalize(src, offsets, dims,
                                     torch.from_numpy(crops).cuda(),
                                     torch.from_numpy(flips).cuda(), out_size,
                                     mean, std)
            return out, failures

        return self._own_stream(work)


class DataPlane:
    """Batch JPEG decode + crop + resize + flip + normalize, on the host's
    C++ plane (``device="cpu"``) or on the card (``device="cuda"``)."""

    def __init__(self, n_threads: int | None = None, device: str = "cpu"):
        n = n_threads or max(os.cpu_count() or 1, 1)
        kind = device.split(":")[0]
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"no data plane for device {device!r}")
        self.device = kind
        self._impl = _HostPlane(n) if kind == "cpu" else _CardPlane(n)

    def __del__(self):
        impl = getattr(self, "_impl", None)
        if impl is not None:
            impl.close()

    def jpeg_info(self, data: bytes) -> tuple[int, int]:
        """(width, height) from the header; ``ValueError`` if it does not
        parse."""
        return self._impl.jpeg_info(data)

    def decode_batch(self, jpegs: list[bytes], crops: np.ndarray,
                     flips: np.ndarray, out_size: int, mean=MEAN, std=STD):
        """(N, out_size, out_size, 3) fp32 NHWC: each image cropped at
        ``crops`` (N, 4) fractions x, y, w, h, resized bilinearly, flipped
        where ``flips`` (N,) is 1 and normalized by ``mean``/``std``; numpy
        on the host plane, a CUDA tensor on the card's."""
        crops = np.ascontiguousarray(crops, np.float32).reshape(len(jpegs), 4)
        flips = np.ascontiguousarray(flips, np.int32).reshape(len(jpegs))
        out, failures = self._impl.decode_batch(list(jpegs), crops, flips,
                                                out_size, mean, std)
        if failures:
            warnings.warn(f"{failures} images failed to decode (zero-filled)")
        return out
