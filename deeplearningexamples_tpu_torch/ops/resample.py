"""Crop + bilinear resize + flip + normalize of a batch of decoded images:
the CUDA kernel of the card's data plane, and its plain version.

The host data plane (``native/dataplane.cc``, a copy of
``deeplearningexamples_tpu/native/dataplane.cc``) fuses this step with
libjpeg's decode. On a host without libjpeg, nvJPEG decodes on the card and
``resample_normalize`` finishes the batch there: on CUDA tensors it launches
the hand-written kernel in ``csrc/resample_normalize.cu`` (one launch a
batch), or raises; on CPU tensors it runs ``resample_normalize_reference``,
the plain PyTorch version and the kernel's oracle. Both round every fp32
operation as the host plane's code does, so the kernel and the plain version
give the same bits, and on an image libjpeg decoded at full size (d = 1) the
host plane's own ``resample_normalize`` up to its compiler's contractions.

The batch is packed: image i is ``src[offsets[i]:]``, ``h`` rows of ``w``
pixels of ``c`` bytes (3: RGB; 1: grayscale, replicated), listed in ``dims``
(N, 4) int32 as ``w, h, c, d``. ``d`` is the 1/d at which libjpeg would have
decoded it (``native.scale_denom``): the image is then read as its
ceil(w / d) x ceil(h / d) block means, each rounded to the nearest byte. An
image with ``w`` 0 is written as zeros.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

__all__ = ["launches", "resample_normalize", "resample_normalize_reference"]

# Kernel launches since the count was last set to 0. Only the CUDA launches
# add to it.
launches = 0
_count_lock = threading.Lock()
_kernel_fn = None


def _f32(x: float, device) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``: CUDA's division by a host scalar
    multiplies by its reciprocal, which is not the host plane's
    division."""
    return torch.tensor(np.float32(x), device=device)


def _block_means(img: torch.Tensor, d: int) -> torch.Tensor:
    """(h, w, c) uint8 -> (ceil(h / d), ceil(w / d), c) int32 block means
    rounded to the nearest (half up), the edge blocks over the pixels they
    hold."""
    h, w, c = img.shape
    sh, sw = -(-h // d), -(-w // d)
    pad = torch.zeros(sh * d, sw * d, c, dtype=torch.int32, device=img.device)
    pad[:h, :w] = img.to(torch.int32)
    sums = pad.view(sh, d, sw, d, c).sum((1, 3))
    ones = torch.zeros(sh * d, sw * d, dtype=torch.int32, device=img.device)
    ones[:h, :w] = 1
    cnt = ones.view(sh, d, sw, d).sum((1, 3))[..., None]
    return torch.div(sums + cnt // 2, cnt, rounding_mode="floor")


def _one(img: torch.Tensor, crop: torch.Tensor, flip: bool, out_size: int,
         mean: torch.Tensor, inv_std: torch.Tensor) -> torch.Tensor:
    """One image: (h, w, c) uint8 or int32 -> (S, S, 3) fp32."""
    h, w, _ = img.shape
    cx, cy = crop[0] * float(w), crop[1] * float(h)
    sx = crop[2] * float(w) / _f32(out_size, img.device)
    sy = crop[3] * float(h) / _f32(out_size, img.device)
    o = torch.arange(out_size, dtype=torch.float32, device=img.device)
    fy = (cy + (o + 0.5) * sy - 0.5).clamp(0.0, float(h - 1))
    fx = (cx + (o + 0.5) * sx - 0.5).clamp(0.0, float(w - 1))
    y0, x0 = fy.long(), fx.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy, wx = (fy - y0.float())[:, None, None], (fx - x0.float())[None, :, None]
    p = img.float().expand(h, w, 3)
    p00, p01 = p[y0][:, x0], p[y0][:, x1]
    p10, p11 = p[y1][:, x0], p[y1][:, x1]
    top = p00 + (p01 - p00) * wx
    bot = p10 + (p11 - p10) * wx
    v = (top + (bot - top) * wy) * _f32(np.float32(1) / np.float32(255),
                                        img.device)
    out = (v - mean) * inv_std
    return out.flip(1) if flip else out


def resample_normalize_reference(src, offsets, dims, crops, flips,
                                 out_size: int, mean, std) -> torch.Tensor:
    """The plain PyTorch version, on the tensors' device: (N, S, S, 3)
    fp32."""
    n = dims.shape[0]
    out = torch.zeros(n, out_size, out_size, 3, device=src.device)
    mean = torch.tensor(np.asarray(mean, np.float32), device=src.device)
    inv_std = torch.tensor(np.float32(1) / np.asarray(std, np.float32),
                           device=src.device)
    dims, offsets, crops = dims.cpu().tolist(), offsets.cpu().tolist(), \
        crops.float().cpu()
    flips = flips.cpu().tolist()
    for i, (w, h, c, d) in enumerate(dims):
        if w == 0:
            continue
        img = src[offsets[i]:offsets[i] + w * h * c].view(h, w, c)
        if d > 1:
            img = _block_means(img, d)
        crop = crops[i].to(src.device)
        out[i] = _one(img, crop, bool(flips[i]), out_size, mean, inv_std)
    return out


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from ._build import load

        fn = load("dataplane").dlx_resample_normalize
        # src, offsets, dims, crops, flips, out, n, out_size, mean x3, std x3,
        # stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _check(src, offsets, dims, crops, flips) -> None:
    n = dims.shape[0]
    want = {"src": (src, torch.uint8), "offsets": (offsets, torch.int64),
            "dims": (dims, torch.int32), "crops": (crops, torch.float32),
            "flips": (flips, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype or t.device != src.device:
            raise ValueError(f"{name}: want {dtype} on {src.device}, got "
                             f"{t.dtype} on {t.device}")
    if dims.shape != (n, 4) or crops.shape != (n, 4) or offsets.shape != (n,) \
            or flips.shape != (n,):
        raise ValueError(f"shapes: dims {tuple(dims.shape)}, crops "
                         f"{tuple(crops.shape)}, offsets {tuple(offsets.shape)},"
                         f" flips {tuple(flips.shape)}")
    d, off = dims.cpu().long(), offsets.cpu()
    live = d[:, 0] > 0  # the others are written as zeros
    d, off = d[live], off[live]
    ends = off + d[:, 0] * d[:, 1] * d[:, 2]
    if len(d) and (int(off.min()) < 0 or int(ends.max()) > src.numel()
              or not set(d[:, 2].tolist()) <= {1, 3}
              or not set(d[:, 3].tolist()) <= {1, 2, 4, 8}):
        raise ValueError("an image lies outside src, or has channels other "
                         "than 1 or 3, or a 1/d other than 1, 2, 4, 8")


def resample_normalize(src: torch.Tensor, offsets: torch.Tensor,
                       dims: torch.Tensor, crops: torch.Tensor,
                       flips: torch.Tensor, out_size: int, mean, std
                       ) -> torch.Tensor:
    """(N, out_size, out_size, 3) fp32 NHWC from the packed batch ``src``
    (uint8), ``offsets`` (N,) int64, ``dims`` (N, 4) int32, ``crops`` (N, 4)
    fp32 fractions x, y, w, h, ``flips`` (N,) int32. The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    global launches
    _check(src, offsets, dims, crops, flips)
    if src.device.type == "cpu":
        return resample_normalize_reference(src, offsets, dims, crops, flips,
                                            out_size, mean, std)
    if src.device.type != "cuda":
        raise ValueError(f"no resample for device {src.device}")
    n = dims.shape[0]
    out = torch.empty(n, out_size, out_size, 3, device=src.device)
    tensors = [t.contiguous() for t in (src, offsets, dims, crops, flips)]
    with torch.cuda.device(src.device):
        err = _kernel()(*(t.data_ptr() for t in tensors), out.data_ptr(), n,
                        out_size, *map(float, np.float32(mean)),
                        *map(float, np.float32(std)),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"resample_normalize kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        launches += 1
    return out
