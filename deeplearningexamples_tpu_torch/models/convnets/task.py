"""ConvNets training task: an image model in the train step's contract.

Port of ``deeplearningexamples_tpu/models/convnets/task.py``
(``ClassificationTask``; reference ``image_classification/training.py``
and the loss choice of ``main.py:453-457``). The port's contract is::

    loss_fn(model, model_state, batch, generator) -> (loss, (model_state, metrics))

``model_state`` is the dict of the model's BN running statistics (the
buffers themselves): a training forward updates them in place, and
``CheckpointManager`` saves and restores them with the state. A batch holds
``image`` (B, H, W, 3) fp32 and ``label`` (B,) int32 on the model's device;
the model sees ``image.permute(0, 3, 1, 2)``, whose memory is
``channels_last``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...core import losses
from .efficientnet import EfficientNet
from .gpunet import GPUNet

__all__ = ["ClassificationTask"]


@dataclass
class ClassificationTask:
    arch: str
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32
    quantized: bool = False
    label_smoothing: float = 0.0
    mixup_alpha: float = 0.0
    num_classes: int = 1000

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> nn.Module:
        """A model with flax's initialisers drawn on the CPU from
        ``generator``, then placed on ``device``, in training mode."""
        from . import build_model

        model = build_model(self.arch, self.num_classes, self.dtype,
                            self.quantized)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        """The BN running statistics, by their ``state_dict`` names."""
        return dict(model.named_buffers())

    @staticmethod
    def _forward(model: nn.Module, images: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        if isinstance(model, (EfficientNet, GPUNet)):
            return model(x, generator)
        return model(x)

    def _criterion(self, logits, labels):
        if self.label_smoothing > 0:
            return losses.smoothed_cross_entropy(logits, labels,
                                                 self.label_smoothing)
        return losses.cross_entropy(logits, labels)

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """The (smoothed) CE of a training forward; under mixup, labels
        become one-hot and the mixed soft labels take the same loss."""
        images, labels = batch["image"], batch["label"]
        if self.mixup_alpha > 0:
            if labels.dim() == 1:
                labels = F.one_hot(labels.long(), self.num_classes).float()
            images, labels = losses.mixup(generator, self.mixup_alpha,
                                          images, labels)
        logits = self._forward(model, images, generator)
        return self._criterion(logits, labels), (model_state, {})

    @torch.no_grad()
    def metric_fn(self, model: nn.Module, model_state, batch: dict) -> dict:
        """top1, top5 and ``val_loss`` (plain CE) of an eval-mode forward
        (the running statistics, no dropout); the model's mode is put
        back."""
        training = model.training
        model.eval()
        try:
            logits = self._forward(model, batch["image"])
        finally:
            model.train(training)
        metrics = losses.top_k_accuracy(logits, batch["label"])
        metrics["val_loss"] = losses.cross_entropy(logits, batch["label"])
        return metrics
