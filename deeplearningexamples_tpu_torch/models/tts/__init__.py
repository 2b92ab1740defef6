"""Tacotron2 + WaveGlow: text and audio frontends, the two models, their
tasks and the text-to-wav pipeline.

Port of ``deeplearningexamples_tpu/models/tts/__init__.py``, with the same
names but HiFi-GAN's and FastPitch's (not ported yet)."""

from .audio import MelConfig, mel_filterbank, mel_spectrogram
from .inference import Denoiser, TTSPipeline, prepare_input_sequence
from .tacotron2 import Tacotron2, Tacotron2Config, tacotron2_loss
from .task import Tacotron2Task, WaveGlowTask
from .text import N_SYMBOLS, sequence_to_text, symbols, text_to_sequence
from .waveglow import WaveGlow, WaveGlowConfig, waveglow_loss

__all__ = ["Denoiser", "MelConfig", "N_SYMBOLS", "TTSPipeline", "Tacotron2",
           "Tacotron2Config", "Tacotron2Task", "WaveGlow", "WaveGlowConfig",
           "WaveGlowTask", "mel_filterbank", "mel_spectrogram",
           "prepare_input_sequence", "sequence_to_text", "symbols",
           "tacotron2_loss", "text_to_sequence", "waveglow_loss"]
