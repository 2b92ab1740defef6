"""The ConvNets family: ResNet v1.5, ResNeXt, SE-ResNeXt, EfficientNet and
GPUNet.

Port of ``deeplearningexamples_tpu/models/convnets/__init__.py``."""

from __future__ import annotations

import torch
from torch import nn

from .efficientnet import EFFNET_ARCHS, EffNetArch, EfficientNet
from .gpunet import GPUNET_ARCHS, GPUNet, GPUNetArch
from .resnet import ARCHS, ResNet, ResNetArch
from .task import ClassificationTask


def build_model(arch: str, num_classes: int = 1000,
                dtype: torch.dtype = torch.bfloat16,
                quantized: bool = False) -> nn.Module:
    """The model of ``arch`` (``ARCHS``, ``EFFNET_ARCHS`` or
    ``GPUNET_ARCHS``), its weights
    not yet drawn; ``quantized`` puts QAT fake-quant on every convolution,
    with the same parameters."""
    if arch in ARCHS:
        return ResNet(ARCHS[arch], num_classes, dtype, quantized=quantized)
    if arch in EFFNET_ARCHS:
        return EfficientNet(EFFNET_ARCHS[arch], num_classes, dtype,
                            quantized=quantized)
    if arch in GPUNET_ARCHS:
        return GPUNet(GPUNET_ARCHS[arch], num_classes, dtype,
                      quantized=quantized)
    raise KeyError(f"unknown arch {arch!r}; available: "
                   f"{sorted([*ARCHS, *EFFNET_ARCHS, *GPUNET_ARCHS])}")

__all__ = ["ARCHS", "ClassificationTask", "EFFNET_ARCHS", "EffNetArch",
           "EfficientNet", "GPUNET_ARCHS", "GPUNet", "GPUNetArch", "ResNet",
           "ResNetArch", "build_model"]
