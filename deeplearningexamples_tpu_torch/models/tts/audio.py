"""Copy of ``deeplearningexamples_tpu/models/tts/audio.py``: the TTS audio
frontend (STFT, mel filterbank, dynamic-range compression), numpy only.

Re-implements the reference's featurization stack
(``PyTorch/SpeechSynthesis/Tacotron2/tacotron2_common/stft.py:42-142`` conv-
implemented STFT, ``layers.py:68-112`` ``TacotronSTFT.mel_spectrogram`` with
librosa's slaney mel filterbank, ``audio_processing.py:105-120``
dynamic-range compression) in pure numpy — no librosa dependency; the
slaney-normalized filterbank is computed from first principles with the same
parameters (sr 22050, n_fft 1024, hop 256, win 1024, 80 mels, 0-8kHz).

Runs host-side in the data pipeline (the reference computes mels on CPU per
sample in ``TextMelLoader``, ``tacotron2/data_function.py:35-87``) and in
the WaveGlow denoiser.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MelConfig", "mel_filterbank", "stft_magnitude", "mel_spectrogram",
           "dynamic_range_compression", "dynamic_range_decompression", "griffin_lim"]


@dataclass(frozen=True)
class MelConfig:
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0


def _hz_to_mel(f):
    """Slaney scale (librosa default, htk=False): linear < 1kHz, log above."""
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel
    )
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular filters with slaney normalization."""
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0, cfg.sampling_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(cfg.fmin), _hz_to_mel(cfg.fmax), cfg.n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((cfg.n_mels, n_bins))
    for i in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def stft_magnitude(audio: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """(frames, n_fft//2+1) magnitude STFT, hann window, reflect-padded center
    frames — matches the reference conv-STFT output layout."""
    pad = cfg.n_fft // 2
    x = np.pad(audio.astype(np.float64), pad, mode="reflect")
    win = np.hanning(cfg.win_length + 1)[:-1]
    if cfg.win_length < cfg.n_fft:
        win = np.pad(win, (cfg.n_fft - cfg.win_length) // 2)
    n_frames = 1 + (len(x) - cfg.n_fft) // cfg.hop_length
    idx = (
        np.arange(cfg.n_fft)[None, :]
        + cfg.hop_length * np.arange(n_frames)[:, None]
    )
    frames = x[idx] * win[None, :]
    spec = np.fft.rfft(frames, n=cfg.n_fft, axis=1)
    return np.abs(spec).astype(np.float32)


def dynamic_range_compression(x, clip_val: float = 1e-5, C: float = 1.0):
    return np.log(np.clip(x, clip_val, None) * C)


def dynamic_range_decompression(x, C: float = 1.0):
    return np.exp(x) / C


def mel_spectrogram(audio: np.ndarray, cfg: MelConfig | None = None) -> np.ndarray:
    """(n_mels, frames) log-mel — the reference's training target
    (``TacotronSTFT.mel_spectrogram``)."""
    cfg = cfg or MelConfig()
    mag = stft_magnitude(audio, cfg)  # (T, bins)
    mel = mag @ mel_filterbank(cfg).T  # (T, n_mels)
    return dynamic_range_compression(mel).T.astype(np.float32)


def griffin_lim(mag: np.ndarray, cfg: MelConfig, n_iters: int = 30) -> np.ndarray:
    """Phase reconstruction (reference ``audio_processing.py:86-103``)."""
    angles = np.exp(2j * np.pi * np.random.default_rng(0).random(mag.shape))
    win = np.hanning(cfg.win_length + 1)[:-1]

    def istft(spec):
        frames = np.fft.irfft(spec, n=cfg.n_fft, axis=1) * win[None, :]
        out = np.zeros(cfg.hop_length * (spec.shape[0] - 1) + cfg.n_fft)
        wsum = np.zeros_like(out)
        for t in range(spec.shape[0]):
            s = t * cfg.hop_length
            out[s : s + cfg.n_fft] += frames[t]
            wsum[s : s + cfg.n_fft] += win**2
        return out / np.maximum(wsum, 1e-10)

    x = istft(mag * angles)
    for _ in range(n_iters):
        spec = stft_magnitude(x, cfg)
        spec = spec[: mag.shape[0]]
        phase = np.fft.rfft(
            np.pad(x, cfg.n_fft // 2, mode="reflect")[
                (np.arange(cfg.n_fft)[None, :] + cfg.hop_length * np.arange(spec.shape[0])[:, None])
            ] * win[None, :], n=cfg.n_fft, axis=1,
        )
        phase = phase / np.maximum(np.abs(phase), 1e-10)
        x = istft(mag[: phase.shape[0]] * phase)
    return x.astype(np.float32)
