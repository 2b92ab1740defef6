"""Fused multi-head attention, forward and backward: CUDA kernels and their
plain versions.

Port of ``deeplearningexamples_tpu/ops/flash_attention.py``. On CUDA tensors
``flash_attention`` launches the hand-written Hopper kernels (the forward in
``csrc/flash_fwd.cu``, which replaces the TPU kernels ``_fwd_bshd``, ``_fwd``
and ``_fwd_kblk``; the backward's two kernels in ``csrc/flash_bwd.cu``, which
replace ``_bwd_bshd``, ``_bwd`` and ``_bwd_kblk``) or raises; on CPU tensors
it runs ``mha_reference`` and ``mha_backward_reference``, the plain PyTorch
versions of the same functions, which are also the kernels' oracles. A
``torch.autograd.Function`` joins the two, as ``_flash``'s custom VJP does in
JAX: the forward saves q, k, v, the key mask, the seed, out and lse, and the
backward recomputes the probabilities from lse.

Semantics follow the JAX kernels exactly: scale, then mask to ``NEG_INF``
(-1e30, so a row with every key masked averages V uniformly); causal masking
compares global row and column; probability dropout multiplies the numerator
only, by a stateless hash of (row, col, seed, b*H + h); P is rounded to the
input dtype before the PV product and divided by the row sum at the end.

The backward follows the TPU kernels' rounding: P times the keep mask is
rounded to dO's dtype before the dV product, dS to q's dtype before the dQ and
dK products, dQ is written in q's dtype, and dK and dV are summed in fp32 and
cast once. P is ``exp(s - lse)``, so a row whose every key is masked (lse is
-1e30 in fp32) has P = 1 on every key, as in JAX.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

__all__ = [
    "NEG_INF",
    "dropout_scale",
    "flash_attention",
    "flash_attention_with_lse",
    "launches",
    "launches_bwd_dkv",
    "launches_bwd_dq",
    "mha_backward_reference",
    "mha_reference",
]

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the count was last set to 0 (by a caller that wants
# to show a run went through the kernel). Only the CUDA launch adds to it:
# ``launches`` counts the forward kernel, the other two the backward's.
launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
_count_lock = threading.Lock()

# ---------------------------------------------------------------------------
# The dropout hash (JAX ``_dropout_scale``)
# ---------------------------------------------------------------------------
#
# JAX computes it in int32 with wraparound. Here every value is an int64
# tensor holding 32 bits, and each product is split so that no intermediate
# passes 2**49: nothing relies on integer overflow.

_M32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and int ``c`` < 2**32."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _dropout_hash(row, col, seed, salt) -> torch.Tensor:
    """31-bit hash of int64 tensors (or ints) row, col, seed, salt; any int
    is taken mod 2**32, so negative seeds and salts mean their int32 bits."""
    row, col, seed, salt = (torch.as_tensor(x, dtype=torch.int64) & _M32
                            for x in (row, col, seed, salt))
    h = (_mul32(row, _C1) + _mul32(col, _C2) + seed + _mul32(salt, _C3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, _C2)
    h = h ^ (h >> 13)
    h = _mul32(h, _C3)
    h = h ^ (h >> 16)
    return h & 0x7FFFFFFF


def dropout_scale(row, col, seed, salt, rate: float) -> torch.Tensor:
    """keep / (1 - rate) in fp32, keep iff hash >= int(rate * 2**31): the
    JAX ``_dropout_scale`` bit for bit."""
    keep = _dropout_hash(row, col, seed, salt) >= int(rate * 2147483648.0)
    # fp32 1 / fp32(1 - rate), as JAX divides the fp32 keep mask
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        1.0 - rate, dtype=torch.float32)
    return keep.to(torch.float32) * inv.to(keep.device)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def mha_reference(q, k, v, key_mask=None, causal=False, sm_scale=None, *,
                  layout="bhsd", dropout_rate=0.0, dropout_seed=0):
    """Plain PyTorch attention with the kernel's semantics. Returns ``(out,
    lse)``: out in the input layout and dtype, lse (B, H, Sq) fp32."""
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(rows < cols, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        salt = (torch.arange(b, device=q.device)[:, None] * h
                + torch.arange(h, device=q.device)[None, :])[:, :, None, None]
        p = p * dropout_scale(rows, cols, dropout_seed, salt, dropout_rate)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (o / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    if layout == "bshd":
        out = out.transpose(1, 2)
    return out.contiguous(), lse


def mha_backward_reference(q, k, v, key_mask, out, lse, dout, causal=False,
                           sm_scale=None, *, layout="bhsd", dropout_rate=0.0,
                           dropout_seed=0):
    """Plain PyTorch backward with the kernels' arithmetic (JAX
    ``_bwd_kernel_bshd``). ``lse`` is the forward's (B, H, Sq) fp32; the rest
    are in ``layout``. Returns ``(dq, dk, dv)`` in the inputs' layout and
    dtypes."""
    if layout == "bshd":
        q, k, v, out, dout = (t.transpose(1, 2) for t in (q, k, v, out, dout))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(rows < cols, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    p_used = p
    if dropout_rate > 0.0:
        salt = (torch.arange(b, device=q.device)[:, None] * h
                + torch.arange(h, device=q.device)[None, :])[:, :, None, None]
        drop = dropout_scale(rows, cols, dropout_seed, salt, dropout_rate)
        p_used = p * drop
        dp = dp * drop
    dv = torch.einsum("bhqk,bhqd->bhkd", p_used.to(dout.dtype).float(),
                      dout.float())
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype)
    dv = dv.to(v.dtype)
    if layout == "bshd":
        dq, dk, dv = (t.transpose(1, 2) for t in (dq, dk, dv))
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_kernel_fns: dict = {}

# dlx_flash_fwd: q, k, v, mask, out, lse, strides (4 x 4), B, H, Sq, Sk, D,
# is_bf16, scale, causal, dropout, threshold, 1 - rate, seed, stream.
# dlx_flash_bwd_dq / _dkv: q, k, v, out, dout, lse, mask, dq, dk, dv, delta,
# strides (8 x 4), then the same scalars and the stream.
_ARGTYPES = {
    "dlx_flash_fwd": [ctypes.c_void_p] * 6,
    "dlx_flash_bwd_dq": [ctypes.c_void_p] * 11,
    "dlx_flash_bwd_dkv": [ctypes.c_void_p] * 11,
}
_SCALARS = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
               ctypes.c_float, ctypes.c_uint, ctypes.c_void_p])


def _kernel(name: str = "dlx_flash_fwd"):
    if name not in _kernel_fns:
        from ._build import load

        fn = getattr(load(), name)
        fn.argtypes = _ARGTYPES[name] + _SCALARS
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return _kernel_fns[name]


def _bshd_strides(t: torch.Tensor, layout: str) -> tuple[int, int, int, int]:
    """Element strides of t in (batch, seq, head, dim) order."""
    s = t.stride()
    return s if layout == "bshd" else (s[0], s[2], s[1], s[3])


def _check(q, k, v, key_mask, layout, rate):
    """Validate what the kernels take; returns (b, h, sq, sk, d, int32 mask
    or None)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"q, k, v must share a dtype in {SUPPORTED_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    if layout == "bshd":
        b, sq, h, d = q.shape
        sk = k.shape[1]
        kv_shape = (b, sk, h, d)
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        kv_shape = (b, h, sk, d)
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"k and v must have shape {kv_shape}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if min(b, h, sq, sk) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    mask = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, sk):
            raise ValueError(f"key_mask must be ({b}, {sk}), got "
                             f"{tuple(key_mask.shape)}")
        mask = key_mask.to(device=q.device, dtype=torch.int32).contiguous()
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return b, h, sq, sk, d, mask


def _scalars(b, h, sq, sk, d, q, scale, causal, rate, seed):
    return (b, h, sq, sk, d, int(q.dtype == torch.bfloat16), scale,
            int(causal), int(rate > 0.0), int(rate * 2147483648.0), 1.0 - rate,
            int(seed) & 0xFFFFFFFF)


def _flash_cuda(q, k, v, key_mask, causal, scale, layout, rate, seed):
    global launches
    b, h, sq, sk, d, mask = _check(q, k, v, key_mask, layout, rate)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 16)(
        *(s for t in (q, k, v, out) for s in _bshd_strides(t, layout)))
    fn = _kernel("dlx_flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), strides,
                 *_scalars(b, h, sq, sk, d, q, scale, causal, rate, seed),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out, lse


def _bwd_buffers(q, k, v, key_mask, out, lse, dout, causal, scale, layout,
                 rate, seed):
    """Validate, allocate dq, dk, dv and delta, and build the arguments both
    backward kernels take (all but the stream)."""
    b, h, sq, sk, d, mask = _check(q, k, v, key_mask, layout, rate)
    if dout.dtype != q.dtype or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"dout must be {q.dtype} {tuple(q.shape)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 ({b}, {h}, {sq})")
    if any(t.device != q.device for t in (out, lse, dout)):
        raise ValueError("out, lse and dout must be on q's device")
    dout = dout if dout.stride(-1) == 1 else dout.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 32)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv)
          for s in _bshd_strides(t, layout)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            None if mask is None else mask.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), strides,
            *_scalars(b, h, sq, sk, d, q, scale, causal, rate, seed))
    # the tensors behind the pointers live as long as the arguments
    return (dq, dk, dv), args, (mask, dout, lse, delta)


def _flash_bwd_cuda(q, k, v, key_mask, out, lse, dout, causal, scale, layout,
                    rate, seed):
    """Launches the dq kernel (which also writes delta = rowsum(dO * O)),
    then the dk/dv kernel, on the current stream."""
    global launches_bwd_dq, launches_bwd_dkv
    grads, args, _keep = _bwd_buffers(q, k, v, key_mask, out, lse, dout,
                                      causal, scale, layout, rate, seed)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("dlx_flash_bwd_dq")(*args, stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
        with _count_lock:
            launches_bwd_dq += 1
        err = _kernel("dlx_flash_bwd_dkv")(*args, stream)
        if err != 0:
            raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
        with _count_lock:
            launches_bwd_dkv += 1
    return grads


def _device_kind(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    return q.device.type


class _FlashAttention(torch.autograd.Function):
    """JAX ``_flash``'s custom VJP: the kernels (CUDA) or the plain versions
    (CPU) forward and backward, with the probabilities recomputed from lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale, layout, rate, seed):
        if _device_kind(q) == "cuda":
            out, lse = _flash_cuda(q, k, v, key_mask, causal, scale, layout,
                                   rate, seed)
        else:
            out, lse = mha_reference(q, k, v, key_mask, causal, scale,
                                     layout=layout, dropout_rate=rate,
                                     dropout_seed=seed)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.args = (causal, scale, layout, rate, seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        causal, scale, layout, rate, seed = ctx.args
        if _device_kind(q) == "cuda":
            grads = _flash_bwd_cuda(q, k, v, key_mask, out, lse, dout, causal,
                                    scale, layout, rate, seed)
        else:
            grads = mha_backward_reference(q, k, v, key_mask, out, lse, dout,
                                           causal, scale, layout=layout,
                                           dropout_rate=rate,
                                           dropout_seed=seed)
        return (*grads, None, None, None, None, None, None)


# ---------------------------------------------------------------------------
# Public API (the JAX signature)
# ---------------------------------------------------------------------------


def flash_attention_with_lse(q, k, v, key_mask=None, *, causal=False,
                             sm_scale=None, layout="bhsd", dropout_rate=0.0,
                             dropout_seed=0):
    """``flash_attention`` that also returns the logsumexp, (B, H, Sq) fp32.
    Differentiable in q, k and v."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown layout {layout!r}")
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    return _FlashAttention.apply(q, k, v, key_mask, causal, scale, layout,
                                 float(dropout_rate), int(dropout_seed))


def flash_attention(q, k, v, key_mask=None, *, causal=False, sm_scale=None,
                    layout="bhsd", dropout_rate=0.0, dropout_seed=0):
    """Fused MHA. key_mask: (batch, seq_k) with 1 = attend.

    ``layout="bhsd"``: q, k, v are (batch, heads, seq, head_dim);
    ``layout="bshd"``: (batch, seq, heads, head_dim), read in place by the
    kernel. The output has the input's layout and dtype. ``dropout_rate`` > 0
    drops attention probabilities by the stateless hash seeded by the int32
    ``dropout_seed``."""
    return flash_attention_with_lse(
        q, k, v, key_mask, causal=causal, sm_scale=sm_scale, layout=layout,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)[0]
