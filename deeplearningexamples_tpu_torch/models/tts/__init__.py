"""The TTS models: Tacotron2 + WaveGlow, FastPitch + HiFi-GAN, their text
and audio frontends, tasks and the text-to-wav pipeline.

Port of ``deeplearningexamples_tpu/models/tts/__init__.py``, with the same
names."""

from .audio import MelConfig, mel_filterbank, mel_spectrogram
from .fastpitch import (FastPitch, FastPitchConfig, FastPitchTask,
                        average_over_durations, length_regulate)
from .hifigan import HiFiGanConfig, HiFiGanGenerator, HiFiGanTask
from .inference import Denoiser, TTSPipeline, prepare_input_sequence
from .tacotron2 import Tacotron2, Tacotron2Config, tacotron2_loss
from .task import Tacotron2Task, WaveGlowTask
from .text import N_SYMBOLS, sequence_to_text, symbols, text_to_sequence
from .waveglow import WaveGlow, WaveGlowConfig, waveglow_loss

__all__ = ["Denoiser", "FastPitch", "FastPitchConfig", "FastPitchTask",
           "HiFiGanConfig", "HiFiGanGenerator", "HiFiGanTask", "MelConfig",
           "N_SYMBOLS", "TTSPipeline", "Tacotron2", "Tacotron2Config",
           "Tacotron2Task", "WaveGlow", "WaveGlowConfig", "WaveGlowTask",
           "average_over_durations", "length_regulate", "mel_filterbank",
           "mel_spectrogram", "prepare_input_sequence", "sequence_to_text",
           "symbols", "tacotron2_loss", "text_to_sequence", "waveglow_loss"]
