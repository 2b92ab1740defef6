"""TTS training tasks: Tacotron2 and WaveGlow in the port's contract::

    loss_fn(model, model_state, batch, generator) -> (loss, (model_state, metrics))

Port of ``deeplearningexamples_tpu/models/tts/task.py`` (reference
``Tacotron2/train.py:345-566``; losses ``Tacotron2Loss``,
``tacotron2/loss_function.py:30-45``, and ``WaveGlowLoss``,
``waveglow/loss_function.py:30-48``). A Tacotron2 batch holds ``text`` (B,
L) int32, ``text_lengths`` (B,), ``mel`` (B, T, n_mel) fp32 and
``mel_lengths`` (B,); a WaveGlow batch ``audio`` (B, S) and ``mel`` (B,
T_mel, n_mel), on the model's device. The step's generator seeds the
dropout masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .tacotron2 import Tacotron2, Tacotron2Config, tacotron2_loss
from .waveglow import WaveGlow, WaveGlowConfig, waveglow_loss

__all__ = ["Tacotron2Task", "WaveGlowTask"]


@dataclass
class Tacotron2Task:
    cfg: Tacotron2Config = Tacotron2Config()
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Tacotron2:
        """A ``Tacotron2`` with flax's initialisers drawn on the CPU from
        ``generator``, then placed on ``device``, in training mode."""
        model = Tacotron2(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        """The BN running statistics, by their ``state_dict`` names."""
        return {n: b for n, b in model.named_buffers() if ".running_" in n}

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """The teacher-forced loss; the gate target is 1 at and after frame
        ``mel_length - 1``."""
        mel, mel_post, gates, _ = model(batch["text"], batch["text_lengths"],
                                        batch["mel"], batch["mel_lengths"],
                                        generator)
        t = batch["mel"].shape[1]
        gate_target = (torch.arange(t, device=gates.device)[None, :]
                       >= (batch["mel_lengths"][:, None] - 1)).to(gates.dtype)
        target = batch["mel"].to(mel.dtype)
        return tacotron2_loss(mel, mel_post, gates, target, gate_target), \
            (model_state, {})

    @staticmethod
    def infer_fn(model: Tacotron2, text, text_lengths, max_steps=None,
                 generator: torch.Generator | None = None):
        """(mel_post, lengths, alignments) of ``Tacotron2.infer``."""
        return model.infer(text, text_lengths, max_steps, generator)


@dataclass
class WaveGlowTask:
    cfg: WaveGlowConfig = WaveGlowConfig()
    dtype: torch.dtype = torch.bfloat16
    sigma: float = 1.0

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> WaveGlow:
        model = WaveGlow(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict:
        return {}

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        z, log_s, log_det = model(batch["audio"], batch["mel"])
        return waveglow_loss(z, log_s, log_det, self.sigma), (model_state, {})

    @staticmethod
    def infer_fn(model: WaveGlow, mel, sigma: float = 0.9,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return model.infer(mel, sigma, generator)
