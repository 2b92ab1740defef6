"""The ConvNets family: ResNet v1.5, ResNeXt, SE-ResNeXt and EfficientNet.

Port of ``deeplearningexamples_tpu/models/convnets/__init__.py``. GPUNet is
not ported yet."""

from __future__ import annotations

import torch
from torch import nn

from .efficientnet import EFFNET_ARCHS, EffNetArch, EfficientNet
from .resnet import ARCHS, ResNet, ResNetArch
from .task import ClassificationTask

# the JAX package's GPUNet archs, which ``build_model`` refuses by name
GPUNET_ARCHS = ("gpunet-0", "gpunet-1", "gpunet-2")


def build_model(arch: str, num_classes: int = 1000,
                dtype: torch.dtype = torch.bfloat16,
                quantized: bool = False) -> nn.Module:
    """The model of ``arch`` (``ARCHS`` or ``EFFNET_ARCHS``), its weights
    not yet drawn; ``quantized`` puts QAT fake-quant on every convolution,
    with the same parameters."""
    if arch in ARCHS:
        return ResNet(ARCHS[arch], num_classes, dtype, quantized=quantized)
    if arch in EFFNET_ARCHS:
        return EfficientNet(EFFNET_ARCHS[arch], num_classes, dtype,
                            quantized=quantized)
    if arch in GPUNET_ARCHS:
        raise NotImplementedError(f"{arch}: GPUNet is not ported to the "
                                  "PyTorch package yet (see ROADMAP.md)")
    raise KeyError(f"unknown arch {arch!r}; available: "
                   f"{sorted(ARCHS) + sorted(EFFNET_ARCHS)}")

__all__ = ["ARCHS", "ClassificationTask", "EFFNET_ARCHS", "EffNetArch",
           "EfficientNet", "GPUNET_ARCHS", "ResNet", "ResNetArch",
           "build_model"]
