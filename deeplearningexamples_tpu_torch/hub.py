"""Model zoo entry points (the TorchHub API of the reference's
``hubconf.py:1-34``).

Port of ``deeplearningexamples_tpu/hub.py``: the same names
(``list_models()`` returns JAX's list), each building the port's
``nn.Module`` through its family's task where it has one, its weights drawn
from a seeded ``torch.Generator`` on the CPU and placed on ``device``. A
module carries its weights, so ``create`` and ``load`` return the module
(JAX's return ``(model, variables)``); ``load`` returns it in eval mode.

``load(name, pretrained=...)`` reads three kinds of ``pretrained``:

- ``None``: the seeded weights;
- a ``.pt``, ``.pth`` or ``.pth.tar`` file: a reference checkpoint, for the
  six names of JAX's ``_TORCH_CONVERTERS`` (resnet50, bert, gpunet-0/1/2,
  fastpitch, hifigan, tft). The port keeps the reference's ``state_dict``
  names, so a converter strips the ``module.`` prefix (and a ``model`` or
  ``state_dict`` wrapper), drops torch BN's ``num_batches_tracked``
  counters, which the port does not keep, and loads strictly. BERT pads
  the word table to ``padded_vocab`` (``utils/torch_import.load_bert_encoder``);
  GPUNet renames the reference's ``network.{child}.{...}`` children, matched
  by position against the arch's layer list as JAX's ``convert_gpunet``
  does (``_GPUNET_PARTS``);
- a directory: a model repository (``serving/export.py``), loaded strictly.

Any other name with a file raises ``NotImplementedError``, as in JAX.

    >>> from deeplearningexamples_tpu_torch import hub
    >>> model = hub.load("resnet50", pretrained="/path/to/model.pth.tar")
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch
from torch import nn

__all__ = ["list_models", "create", "load"]

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def create(name: str, seed: int = 0, device: torch.device | str = "cuda",
           **kwargs) -> nn.Module:
    """The module of ``name`` with weights drawn from ``seed`` (JAX's
    initialisers), on ``device``; ``kwargs`` are the entry's (``dtype``,
    ``num_classes``, ``cfg``, ``size`` ...)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    return _REGISTRY[name](torch.Generator().manual_seed(seed), device,
                           **kwargs)


def load(name: str, pretrained: str | None = None, seed: int = 0,
         device: torch.device | str = "cuda", **kwargs) -> nn.Module:
    """The module of ``name`` in eval mode, with the weights of
    ``pretrained`` (a reference checkpoint file or a model repository
    directory) or, without one, those of ``seed``."""
    model = create(name, seed=seed, device=device, **kwargs)
    if pretrained is not None:
        if pretrained.endswith((".pt", ".pth", ".pth.tar")):
            conv = _TORCH_CONVERTERS.get(name)
            if conv is None:
                raise NotImplementedError(f"no torch converter for {name}")
            conv(model, pretrained)
        else:
            from .serving.export import load_model_repository

            repo, model_name = os.path.split(pretrained.rstrip("/"))
            load_model_repository(repo, model_name, model)
    return model.eval()


# -- entries -----------------------------------------------------------------


def _convnet_entry(arch: str):
    def entry(generator, device, num_classes: int = 1000,
              dtype=torch.bfloat16):
        from .models.convnets import ClassificationTask

        return ClassificationTask(arch, dtype, num_classes=num_classes).init(
            generator, device)

    return entry


for _arch in ("resnet50", "resnext101-32x4d", "se-resnext101-32x4d",
              "efficientnet-b0", "efficientnet-b4",
              "efficientnet-widese-b0", "efficientnet-widese-b4",
              "gpunet-0", "gpunet-1", "gpunet-2"):
    _REGISTRY[_arch] = _convnet_entry(_arch)


def _ssd_entry(generator, device, num_classes: int = 81, dtype=torch.bfloat16):
    from .models.ssd import SSDTask

    return SSDTask(num_classes, dtype).init(generator, device)


def _bert_entry(generator, device, size: str = "large", dtype=torch.bfloat16):
    """The encoder (embeddings, layers, pooler), as JAX's ``BertModel``."""
    from .models.bert import BERT_CONFIGS, BertModel
    from .models.bert.task import init_bert_weights_

    cfg = BERT_CONFIGS[size]
    model = BertModel(cfg, dtype)
    with torch.no_grad():
        init_bert_weights_(model, generator, cfg.initializer_range)
    return model.to(device)


def _tacotron2_entry(generator, device, dtype=torch.bfloat16):
    from .models.tts import Tacotron2Task

    return Tacotron2Task(dtype=dtype).init(generator, device)


def _waveglow_entry(generator, device, dtype=torch.bfloat16):
    from .models.tts import WaveGlowTask

    return WaveGlowTask(dtype=dtype).init(generator, device)


def _dlrm_entry(generator, device, categorical_cardinalities=None,
                dtype=torch.bfloat16):
    from .models.dlrm import DlrmConfig, DlrmTask

    cards = tuple(categorical_cardinalities or [100_000] * 26)
    return DlrmTask(DlrmConfig(categorical_cardinalities=cards),
                    dtype).init(generator, device)


def _transformer_entry(generator, device, dtype=torch.bfloat16):
    from .models.translation.transformer import TransformerTask

    return TransformerTask(dtype=dtype).init(generator, device)


def _ncf_entry(generator, device, cfg=None, dtype=torch.bfloat16):
    from .models.ncf import NcfConfig, NcfTask

    return NcfTask(cfg or NcfConfig(), dtype).init(generator, device)


def _efficientdet_entry(generator, device, dtype=torch.bfloat16):
    from .models.efficientdet import EfficientDetConfig, EfficientDetTask

    return EfficientDetTask(EfficientDetConfig(), dtype).init(generator,
                                                              device)


def _maskrcnn_entry(generator, device, dtype=torch.bfloat16):
    from .models.maskrcnn import MaskRCNNConfig, MaskRCNNTask

    return MaskRCNNTask(MaskRCNNConfig(image_size=256), dtype).init(
        generator, device)


def _moflow_entry(generator, device, dtype=torch.float32):
    from .models.moflow import ZINC250K_CONFIG, MoFlowTask

    return MoFlowTask(ZINC250K_CONFIG).init(generator, device)


def _se3_entry(generator, device, dtype=torch.float32):
    from .models.se3_transformer import SE3Config, SE3RegressionTask

    return SE3RegressionTask(SE3Config()).init(generator, device)


def _fastpitch_entry(generator, device, cfg=None, dtype=torch.bfloat16):
    """Reference ``hubconf.py:29`` (``nvidia_fastpitch``)."""
    from .models.tts import FastPitchConfig, FastPitchTask

    return FastPitchTask(cfg or FastPitchConfig(), dtype).init(generator,
                                                               device)


def _hifigan_entry(generator, device, cfg=None, dtype=torch.bfloat16):
    """Reference ``hubconf.py:31`` (``nvidia_hifigan``): the generator alone;
    an inference deployment ships no discriminators."""
    from .models.tts import HiFiGanConfig, HiFiGanGenerator
    from .models.tts.hifigan import _init_

    gen = HiFiGanGenerator(cfg or HiFiGanConfig(), dtype)
    _init_(gen, generator)
    return gen.to(device)


def _tft_entry(generator, device, cfg=None, dtype=torch.float32):
    """Reference ``hubconf.py:34`` (``nvidia_tft``)."""
    from .models.tft import TFTConfig, TFTTask

    return TFTTask(cfg or TFTConfig(), dtype).init(generator, device)


_REGISTRY.update(
    ssd300=_ssd_entry, bert=_bert_entry, tacotron2=_tacotron2_entry,
    waveglow=_waveglow_entry, dlrm=_dlrm_entry,
    transformer=_transformer_entry, ncf=_ncf_entry,
    efficientdet=_efficientdet_entry, maskrcnn=_maskrcnn_entry,
    moflow=_moflow_entry, se3_transformer=_se3_entry,
    fastpitch=_fastpitch_entry, hifigan=_hifigan_entry, tft=_tft_entry,
)


# -- torch converters --------------------------------------------------------


def reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint: a plain ``state_dict`` or one
    under ``"state_dict"`` or ``"model"``, DDP's ``module.`` prefix
    stripped, BN's update counters dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k.removeprefix("module."): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)
            and not k.endswith("num_batches_tracked")}


def _strict(model: nn.Module, path: str) -> None:
    model.load_state_dict(reference_state_dict(path), strict=True)


def _convert_bert(model: nn.Module, path: str) -> None:
    from .utils.torch_import import load_bert_encoder

    load_bert_encoder(model, path)


# the reference GPUNet's sub-module names -> the port's, by the kind of the
# child (its layer's kind; "head" the prologue, "tail" the epilogue); the SE
# pair's 1x1 convolutions become the port's Dense pair
_GPUNET_PARTS = {
    "head": {"net.0": "conv", "net.1": "bn"},
    "conv": {"conv": "conv", "bn1": "bn"},
    "fused_irb": {"conv_exp": "exp", "bn1": "bn1", "se.conv_reduce":
                  "se.squeeze", "se.conv_expand": "se.expand",
                  "conv_pwl": "proj", "bn2": "bn2"},
    "irb": {"conv_pw": "pw", "bn1": "bn1", "conv_dw": "dw", "bn2": "bn2",
            "se.conv_reduce": "se.squeeze", "se.conv_expand": "se.expand",
            "conv_pwl": "pwl", "bn3": "bn3"},
    "tail": {"net.0": "head.conv", "net.1": "head.bn", "net.6": "fc"},
}


def gpunet_from_reference(sd: dict[str, torch.Tensor],
                          arch) -> dict[str, torch.Tensor]:
    """A reference GPUNet ``state_dict`` (one ``nn.Sequential`` whose
    children's names embed stage strings; the order is the architecture)
    -> the port's ``GPUNet`` names."""
    children: dict[str, dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        child, sub = k.removeprefix("network.").split(".", 1)
        children.setdefault(child, {})[sub] = v
    order = list(children.values())
    if len(order) != len(arch.layers) + 2:
        raise ValueError(f"GPUNet child count {len(order)} != "
                         f"{len(arch.layers)} layers + head + tail")
    kinds = ["head", *(layer.kind for layer in arch.layers), "tail"]
    dests = ["stem", *(f"layers.{i}" for i in range(len(arch.layers))), ""]
    out = {}
    for csd, kind, dest in zip(order, kinds, dests):
        for sub, v in csd.items():
            mod, leaf = sub.rsplit(".", 1)
            part = _GPUNET_PARTS[kind][mod]
            if part.startswith("se.") and v.dim() == 4 and leaf == "weight":
                v = v[:, :, 0, 0]  # a 1x1 convolution as a Dense weight
            name = f"{part}.{leaf}"
            out[f"{dest}.{name}" if dest else name] = v
    return out


def _gpunet_converter(arch_name: str):
    def conv(model: nn.Module, path: str) -> None:
        from .models.convnets import GPUNET_ARCHS

        model.load_state_dict(gpunet_from_reference(
            reference_state_dict(path), GPUNET_ARCHS[arch_name]), strict=True)

    return conv


_TORCH_CONVERTERS: dict[str, Callable[[nn.Module, str], Any]] = {
    "resnet50": _strict,
    "bert": _convert_bert,
    **{a: _gpunet_converter(a) for a in ("gpunet-0", "gpunet-1", "gpunet-2")},
    "fastpitch": _strict,
    "hifigan": _strict,
    "tft": _strict,
}
