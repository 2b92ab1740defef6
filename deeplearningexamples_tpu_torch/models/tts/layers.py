"""The layers Tacotron2 and WaveGlow build from, with flax's semantics and
the reference's ``state_dict`` names.

Parameters are fp32; a layer casts its weight (and bias) to its compute
``dtype`` at each call, as flax's ``nn.Dense`` and ``nn.Conv`` do, so the
gradient of a weight used at every frame is summed in fp32.
Convolutions run NCW (the reference's layout); flax's ``SAME`` padding of
an odd kernel is ``(k - 1) // 2 * dilation`` on each side.

- ``Conv1d``: ``nn.Conv`` over (B, C, T) with flax's padding (``"SAME"``,
  which under a stride or an even kernel pads one more on the right,
  ``"VALID"``, or symmetric), flax's lecun-normal kernel (truncated at two
  standard deviations) and zero bias. FastPitch, HiFi-GAN, Jasper and
  wav2vec2 build from it.
- ``LinearNorm`` and ``ConvNorm``: the reference's wrappers (``linear_layer``,
  ``conv``), with the same initialisers.
- ``LSTMCell``: ``nn.LSTMCell``'s names and gate rows ``[i, f, g, o]``, with
  flax ``OptimizedLSTMCell``'s one bias: ``bias_hh`` is trained, ``bias_ih``
  is a buffer (zeros, or a reference checkpoint's value, added and never
  trained), so an optimizer steps the gate bias once, as in JAX. Input
  kernels lecun normal, hidden kernels orthogonal per gate.
- ``LSTMLayer``: the same one-bias parameters for a whole ``nn.LSTM`` layer,
  under its names (``weight_ih_l0`` ..., ``_l0_reverse``), for the layers
  that run a sequence in one ``torch.lstm`` call (Tacotron2's ``BiLSTM``,
  GNMT's ``LSTM``).
- ``BatchNorm1d``: ``BatchNorm2d`` of the ConvNets over (B, C, T): flax's
  momentum 0.9 and biased running variance, eps 1e-5, the statistics over
  every position.
- ``Dropout``: ``x / (1 - p)`` where kept, the keep mask drawn from a
  generator on the tensor's device; ``always`` keeps it on outside training
  too (the reference's quirks, which JAX keeps). Under a data axis the mask
  is drawn at the global batch's rows and this rank keeps its own, so each
  row takes the mask the one-rank run draws for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import draw_seed
from ...parallel.mesh import draw_rows
from ..convnets.layers import _TRUNC_STD, BatchNorm2d

__all__ = ["BatchNorm1d", "Conv1d", "ConvNorm", "Dropout", "LSTMCell", "LSTMLayer",
           "LinearNorm",
           "acc_dtype", "device_generator", "lecun_normal_",
           "orthogonal_", "same_pads"]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the parts JAX runs in fp32 whatever the compute dtype:
    fp32, or float64 in a float64 model."""
    return torch.promote_types(dtype, torch.float32)


def device_generator(generator: torch.Generator | None,
                     device) -> torch.Generator | None:
    """A generator on ``device`` seeded from ``generator`` (a CPU generator),
    for the dropout masks of one forward; None stays None (the device's
    default generator)."""
    if generator is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(generator))
    return g


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    w.copy_(t)


@torch.no_grad()
def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """An orthogonal square matrix from the QR of a normal draw."""
    q, r = torch.linalg.qr(torch.randn(w.shape, generator=generator,
                                       dtype=torch.float64))
    w.copy_(q * torch.sign(torch.diagonal(r))[None, :])


class LinearNorm(nn.Module):
    """The reference's ``LinearNorm``: ``nn.Dense`` in ``dtype``."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_layer = nn.Linear(cin, cout, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lin = self.linear_layer
        b = lin.bias
        return F.linear(x.to(self.dtype), lin.weight.to(self.dtype),
                        None if b is None else b.to(self.dtype))

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.linear_layer.weight, self.linear_layer.in_features,
                      generator)
        if self.linear_layer.bias is not None:
            with torch.no_grad():
                self.linear_layer.bias.zero_()


def same_pads(n: int, k: int, stride: int = 1,
              dilation: int = 1) -> tuple[int, int]:
    """flax's ``"SAME"`` padding of a length-``n`` axis, (left, right): the
    output has ``ceil(n / stride)`` steps and the right side takes the odd
    one."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Conv1d):
    """flax ``nn.Conv`` over (B, C, T) in ``dtype``: an fp32 (out, in /
    groups, k) weight cast at each call. ``padding`` is ``"SAME"`` (from the
    input's length), ``"VALID"`` or an int for both sides."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, padding: str | int = "SAME",
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel_size, stride=stride,
                         dilation=dilation, groups=groups, bias=bias)
        self.dtype, self.pad = dtype, padding

    def pads(self, n: int) -> tuple[int, int]:
        if self.pad == "SAME":
            return same_pads(n, self.kernel_size[0], self.stride[0],
                             self.dilation[0])
        p = 0 if self.pad == "VALID" else self.pad
        return p, p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.pads(x.shape[-1])
        x = x.to(self.dtype)
        if lo != hi:
            x, lo = F.pad(x, (lo, hi)), 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv1d(x, self.weight.to(self.dtype), bias, self.stride,
                        lo, self.dilation, self.groups)

    def init_(self, generator: torch.Generator) -> None:
        _, cin_g, k = self.weight.shape
        lecun_normal_(self.weight, cin_g * k, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class ConvNorm(nn.Module):
    """The reference's ``ConvNorm``: a 1-D ``nn.Conv`` in ``dtype`` with
    flax's ``SAME`` padding of an odd kernel."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 dilation: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv1d(cin, cout, kernel_size, dilation=dilation,
                           padding=(kernel_size - 1) // 2 * dilation,
                           bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)

    def init_(self, generator: torch.Generator) -> None:
        self.conv.init_(generator)


class LSTMCell(nn.Module):
    """``(h, c) = cell(x, (h, c))`` in ``dtype`` (see the module's
    docstring)."""

    def __init__(self, cin: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.hidden = dtype, hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, cin))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        self.register_buffer("bias_ih", torch.zeros(4 * hidden))

    def forward(self, x: torch.Tensor, hc: tuple[torch.Tensor, torch.Tensor]):
        ws = [t.to(self.dtype) for t in (self.weight_ih, self.weight_hh,
                                         self.bias_ih, self.bias_hh)]
        return torch.lstm_cell(x.to(self.dtype), hc, *ws)

    def init_(self, generator: torch.Generator) -> None:
        init_lstm_(self.weight_ih, self.weight_hh, self.bias_hh, self.bias_ih,
                   generator)


class LSTMLayer(nn.Module):
    """One ``nn.LSTM`` layer's parameters, one direction per suffix of
    ``suffixes`` (``_l0``, ``_l0_reverse``), with ``LSTMCell``'s one bias:
    ``bias_hh{s}`` trained, ``bias_ih{s}`` a buffer. Subclasses run it."""

    def __init__(self, cin: int, hidden: int, dtype: torch.dtype,
                 suffixes: tuple[str, ...]):
        super().__init__()
        self.dtype, self.hidden, self.suffixes = dtype, hidden, suffixes
        for s in suffixes:
            self.register_parameter(f"weight_ih{s}",
                                    nn.Parameter(torch.empty(4 * hidden, cin)))
            self.register_parameter(f"weight_hh{s}",
                                    nn.Parameter(torch.empty(4 * hidden, hidden)))
            self.register_buffer(f"bias_ih{s}", torch.zeros(4 * hidden))
            self.register_parameter(f"bias_hh{s}",
                                    nn.Parameter(torch.zeros(4 * hidden)))

    def weights(self, suffix: str) -> list[torch.Tensor]:
        """One direction's weights in ``dtype``, in ``torch.lstm``'s order
        (``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``)."""
        return [getattr(self, f"{n}{suffix}").to(self.dtype)
                for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]


@torch.no_grad()
def init_lstm_(w_ih, w_hh, b_hh, b_ih, generator: torch.Generator) -> None:
    """flax ``OptimizedLSTMCell``'s initialisers per gate: the input kernel
    lecun normal, the hidden kernel orthogonal, the bias 0."""
    h = w_hh.shape[1]
    for g in range(4):
        lecun_normal_(w_ih[g * h:(g + 1) * h], w_ih.shape[1], generator)
        orthogonal_(w_hh[g * h:(g + 1) * h], generator)
    b_hh.zero_()
    b_ih.zero_()


class BatchNorm1d(BatchNorm2d):
    """``BatchNorm2d`` of the ConvNets: ``aten.native_batch_norm`` serves
    (B, C, T) as it serves (B, C, H, W). ``deterministic`` normalises with
    the running statistics whatever the module's mode (flax's
    ``use_running_average``)."""

    def forward(self, x: torch.Tensor, deterministic: bool = False) -> torch.Tensor:
        if deterministic and self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        return super().forward(x)


class Dropout(nn.Module):
    """Dropout at rate ``p`` (see the module's docstring)."""

    def __init__(self, p: float, always: bool = False):
        super().__init__()
        self.p, self.always = p, always

    def forward(self, x: torch.Tensor, generator: torch.Generator | None,
                deterministic: bool = False) -> torch.Tensor:
        if self.p == 0 or (deterministic and not self.always):
            return x
        keep = 1.0 - self.p
        # the global batch's mask, of which this rank keeps its rows
        mask = draw_rows(lambda rows: x.new_empty((rows, *x.shape[1:]))
                         .bernoulli_(keep, generator=generator), x.shape[0])
        return x * mask.div_(keep)
