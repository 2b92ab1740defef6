"""QAT convolution for the ConvNets family.

Port of ``deeplearningexamples_tpu/models/convnets/quant.py`` (``QATConv``;
reference ``image_classification/quantization.py``): per-output-channel
symmetric int8 fake-quant of the kernel and dynamic per-tensor int8
fake-quant of the input, both with a straight-through round
(``ops/quantization.py``). The kernel is quantized in fp32 over its output
channel (axis 0 of OIHW, where JAX's HWIO has it last) and then cast to the
compute dtype, as in JAX. Its parameter is a plain ``Conv2d``'s ``weight``,
so an fp32 checkpoint loads into a QAT model as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.quantization import fake_quantize, fake_quantize_per_tensor
from .layers import Conv2d

__all__ = ["QATConv"]


class QATConv(Conv2d):
    """``Conv2d`` with int8 fake-quant on the kernel and the input."""

    def kernel(self) -> torch.Tensor:
        return fake_quantize(self.weight, axis=0).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(fake_quantize_per_tensor(x).to(self.dtype),
                        self.kernel(), None, self.stride, self.padding, 1,
                        self.groups)
