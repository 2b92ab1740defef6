"""TTS inference pipeline: text -> Tacotron2 mel -> WaveGlow -> denoise -> wav.

Port of ``deeplearningexamples_tpu/models/tts/inference.py`` (the
reference's ``inference.py:192-279``: batching text into padded sequences,
mel generation, vocoding) and the ``Denoiser`` (``waveglow/denoiser.py``):
WaveGlow's bias, the audio it emits for a zero mel, is estimated once, and
its STFT magnitude is subtracted from synthesized audio (spectral
subtraction, original phase kept). Both models run on their device; the
STFT and the subtraction stay numpy on the host, as in JAX.
``prepare_input_sequence`` and ``Denoiser`` are copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .audio import MelConfig, stft_magnitude
from .text import text_to_sequence

__all__ = ["prepare_input_sequence", "Denoiser", "TTSPipeline"]


def prepare_input_sequence(
    texts: Sequence[str], pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """texts -> (ids (B, L) sorted by decreasing length, lengths (B,)).
    Matches reference ``prepare_input_sequence`` (:141-174) incl. sorting."""
    seqs = [np.asarray(text_to_sequence(t), np.int32) for t in texts]
    order = np.argsort([-len(s) for s in seqs])
    seqs = [seqs[i] for i in order]
    max_len = pad_to or max(len(s) for s in seqs)
    out = np.zeros((len(seqs), max_len), np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s[:max_len]
        lens[i] = min(len(s), max_len)
    return out, lens


class Denoiser:
    """Spectral subtraction of WaveGlow's zero-mel bias."""

    def __init__(self, waveglow_infer: Callable, n_mel: int = 80,
                 mel_cfg: MelConfig | None = None, bias_frames: int = 88):
        self.cfg = mel_cfg or MelConfig()
        zero_mel = np.zeros((1, bias_frames, n_mel), np.float32)
        bias_audio = np.asarray(waveglow_infer(zero_mel, 0.0))[0]
        self.bias_mag = stft_magnitude(bias_audio, self.cfg).mean(
            axis=0, keepdims=True
        )  # (1, bins)

    def __call__(self, audio: np.ndarray, strength: float = 0.1) -> np.ndarray:
        """audio (T,) -> denoised (T,)."""
        cfg = self.cfg
        pad = cfg.n_fft // 2
        x = np.pad(audio.astype(np.float64), pad, mode="reflect")
        win = np.hanning(cfg.win_length + 1)[:-1]
        n_frames = 1 + (len(x) - cfg.n_fft) // cfg.hop_length
        idx = (np.arange(cfg.n_fft)[None, :]
               + cfg.hop_length * np.arange(n_frames)[:, None])
        frames = x[idx] * win[None, :]
        spec = np.fft.rfft(frames, n=cfg.n_fft, axis=1)
        mag = np.abs(spec)
        phase = spec / np.maximum(mag, 1e-12)
        mag = np.maximum(mag - strength * self.bias_mag, 0.0)
        frames = np.fft.irfft(mag * phase, n=cfg.n_fft, axis=1) * win[None, :]
        out = np.zeros(len(x))
        wsum = np.zeros(len(x))
        for t in range(n_frames):
            s = t * cfg.hop_length
            out[s : s + cfg.n_fft] += frames[t]
            wsum[s : s + cfg.n_fft] += win**2
        out = out / np.maximum(wsum, 1e-9)
        return out[pad : pad + len(audio)].astype(np.float32)


@dataclass
class TTSPipeline:
    """End-to-end synthesis with a trained Tacotron2 and WaveGlow (each
    task beside its model). ``generator`` (a CPU generator, or None for the
    default one) seeds the dropout masks and draws WaveGlow's noise."""

    tacotron2_task: Any
    tacotron2: torch.nn.Module
    waveglow_task: Any
    waveglow: torch.nn.Module
    max_decoder_steps: int = 800
    sigma: float = 0.9
    denoiser_strength: float = 0.01
    hop_length: int = 256
    generator: torch.Generator | None = None

    def __post_init__(self):
        self._denoiser = Denoiser(
            self._vocode, n_mel=self.tacotron2_task.cfg.n_mel_channels,
        ) if self.denoiser_strength > 0 else None

    def _vocode(self, mel, sigma: float) -> np.ndarray:
        """WaveGlow's audio for a mel (B, T_mel, n_mel) on the host or the
        model's device, as a host array."""
        dev = next(self.waveglow.parameters()).device
        mel = torch.as_tensor(mel).to(dev)
        return self.waveglow_task.infer_fn(self.waveglow, mel, sigma,
                                           self.generator).cpu().numpy()

    def __call__(self, texts: Sequence[str]) -> tuple[list[np.ndarray], np.ndarray]:
        """Returns (wavs, mel lengths), sorted by decreasing text length as
        ``prepare_input_sequence`` orders them."""
        ids, lens = prepare_input_sequence(texts)
        dev = next(self.tacotron2.parameters()).device
        mel, mel_lens, _ = self.tacotron2_task.infer_fn(
            self.tacotron2, torch.from_numpy(ids).to(dev),
            torch.from_numpy(lens).to(dev), self.max_decoder_steps,
            self.generator)
        audio = self._vocode(mel, self.sigma)
        mel_lens = mel_lens.cpu().numpy()
        wavs = []
        for i in range(audio.shape[0]):
            n = int(mel_lens[i]) * self.hop_length
            w = audio[i, :n]
            if self._denoiser is not None:
                w = self._denoiser(w, self.denoiser_strength)
            wavs.append(w)
        return wavs, mel_lens
