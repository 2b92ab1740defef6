"""Int8 quantization: per-channel weights, fake-quant for QAT, stochastic
per-tensor activations (the CUDA kernel K5) and the int8 GEMM.

Port of ``deeplearningexamples_tpu/ops/quantization.py``:

- ``quantize_per_channel``, ``dequantize``, ``fake_quantize`` and
  ``fake_quantize_per_tensor`` as in JAX. ``torch.round``, like
  ``jnp.round``, rounds half to even. The clip is
  ``torch.minimum(torch.maximum(x, lo), hi)``: at a value equal to a bound
  its gradient is 0.5, as ``jnp.clip``'s is, where ``torch.clamp``'s is 1.
- ``quantize_activations(x, seed)``: scale = max(absmax, 1e-8) / 127 in fp32,
  then q = clip(floor(x / scale + u), -127, 127) with u uniform in [0, 1) on
  the 2^-23 grid. On CUDA tensors it launches ``csrc/quantize.cu``, which
  replaces the TPU kernel ``_quant_kernel``, or raises; on CPU tensors it runs
  ``quantize_activations_reference``, the plain version. Both draw u from
  one Philox4x32-10 keyed on the seed and counted by the element's index
  (``philox_uniform``), so on the card they agree bit for bit. Neither gives
  the TPU's hardware bits or ``jax.random``'s (JAX's CPU path); the tests
  hold ``stochastic_round`` to JAX given JAX's uniforms, and the draws to
  its statistics.
- ``int8_matmul``: s8 x s8 -> s32 by ``torch._int_mm`` (``lax.dot_general``
  outside any Pallas kernel in JAX), rescaled as ``acc * x_scale * w_scale``.

Scalar divisions divide by a 0-d tensor: PyTorch's CUDA division by a
Python number multiplies by its reciprocal, which can differ from JAX's
quotient in the last bit.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["dequantize", "fake_quantize", "fake_quantize_per_tensor",
           "int8_matmul", "launches", "philox_uniform", "quantize_activations",
           "quantize_activations_reference", "quantize_per_channel",
           "stochastic_round"]

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the count was last set to 0. Only the CUDA launch
# adds to it.
launches = 0
_count_lock = threading.Lock()


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division on every device."""
    return a / a.new_full((), b)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``, gradient 0.5 at a tie with a bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


class _SteRound(torch.autograd.Function):
    """Round half to even; straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quantize(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """QAT fake-quant, per-channel symmetric int8 over ``axis``: forward
    through the int8 grid, backward straight through the round; the scale
    is detached."""
    axis = axis % w.dim()
    reduce = [i for i in range(w.dim()) if i != axis]
    w32 = w.float()
    absmax = w32.abs().amax(dim=reduce, keepdim=True)
    scale = _div(absmax.clamp_min(1e-8), 127.0).detach()
    q = _clip(_SteRound.apply(w32 / scale), -127.0, 127.0)
    return (q * scale).to(w.dtype)


def fake_quantize_per_tensor(x: torch.Tensor) -> torch.Tensor:
    """QAT fake-quant for activations: dynamic per-tensor symmetric int8."""
    x32 = x.float()
    scale = _div(x32.abs().amax().clamp_min(1e-8), 127.0).detach()
    q = _clip(_SteRound.apply(x32 / scale), -127.0, 127.0)
    return (q * scale).to(x.dtype)


def quantize_per_channel(w: torch.Tensor, axis: int = 1):
    """Symmetric int8 over all dims but ``axis`` (the output channel):
    ``(w_int8, scale)`` with w ~= w_int8 * scale, the scale fp32 and
    keeping ``w``'s dims."""
    reduce = [i for i in range(w.dim()) if i != axis % w.dim()]
    absmax = w.abs().amax(dim=reduce, keepdim=True)
    scale = _div(absmax.clamp_min(1e-8), 127.0)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 torch arithmetic (the kernel's plain version)
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Random123's round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # and key increments
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32 bits of the 64-bit product of the constant ``a`` and
    ``b`` (int64 holding values in [0, 2^32)), with no int64 overflow."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32_10(counter: tuple[torch.Tensor, ...], key: tuple[int, int]):
    """Philox4x32-10 on int64 tensors holding uint32 words: four (n,)
    counter words and a key of two uint32 -> four (n,) output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _U32, key[1] & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform(seed: int, n: int, device="cpu") -> torch.Tensor:
    """(n,) fp32 in [0, 1) on the 2^-23 grid: element i is
    (word >> 9) * 2^-23, the word i % 4 of Philox at counter i // 4 keyed
    on the 64-bit seed. The kernel draws the same numbers."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32_10((groups & _U32, groups >> 32, zero, zero),
                          (seed & _U32, (seed >> 32) & _U32))
    bits = torch.stack(words, 1).view(-1)[:n]
    return (bits >> 9).float() * (1.0 / 8388608.0)


def stochastic_round(x: torch.Tensor, scale: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """clip(floor(x / scale + u), -127, 127) as int8, in fp32: JAX's
    rounding, given the uniforms."""
    return torch.floor(x.float() / scale + u).clamp(-127, 127).to(torch.int8)


def _scale(x: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127, fp32, 0-d on x's device."""
    return _div(x.abs().amax().float().clamp_min(1e-8), 127.0)


def quantize_activations_reference(x: torch.Tensor, seed: int = 0):
    """The plain version of ``quantize_activations``, on x's device."""
    scale = _scale(x)
    u = philox_uniform(seed, x.numel(), x.device).view(x.shape)
    return stochastic_round(x, scale, u), scale


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from ._build import load

        fn = load().dlx_quantize_int8
        # x, scale, q, n, is_bf16, seed, stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_ulonglong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _quantize_cuda(x: torch.Tensor, scale: torch.Tensor, seed: int) -> torch.Tensor:
    global launches
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), scale.data_ptr(), q.data_ptr(), x.numel(),
                        int(x.dtype == torch.bfloat16), seed & (2**64 - 1),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_activations kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return q


def quantize_activations(x: torch.Tensor, seed: int = 0):
    """Dynamic per-tensor int8 with stochastic rounding: x (fp32 or bf16,
    contiguous) -> (x_int8 of x's shape, fp32 0-d scale). The kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if x.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {SUPPORTED_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cuda":
        scale = _scale(x)
        return _quantize_cuda(x, scale, int(seed)), scale
    if x.device.type == "cpu":
        return quantize_activations_reference(x, int(seed))
    raise ValueError(f"no activation quantization for device {x.device}")


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """Dynamic-activation-quant int8 GEMM: x (M, K) float, w_q (K, N) int8,
    w_scale (1, N) fp32 -> (M, N) fp32. On the card ``torch._int_mm`` needs
    M > 16 and K, N multiples of 8; other shapes raise."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x (M, K) and w_q (K, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    if w_q.dtype != torch.int8:
        raise ValueError(f"w_q must be int8, got {w_q.dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    if x.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"the card's int8 GEMM needs M > 16 and K, N multiples "
                         f"of 8, got M={m} K={k} N={n}")
    x_q, x_scale = quantize_activations(x, seed)
    acc = torch._int_mm(x_q, w_q)
    return acc.float() * x_scale * w_scale
