"""Copy of ``deeplearningexamples_tpu/data/tts_synthetic.py``: synthetic TTS
batches for Tacotron2 and WaveGlow, numpy only. The same numpy calls in
the same order as the JAX package's loaders, so one seed draws the same
batch."""
from __future__ import annotations

import numpy as np

from .synthetic import _Synthetic

__all__ = ["SyntheticTacotronLoader", "SyntheticWaveGlowLoader"]


class SyntheticTacotronLoader(_Synthetic):
    def __init__(
        self,
        batch_size: int,
        max_text_len: int = 128,
        max_mel_len: int = 600,
        n_mels: int = 80,
        n_symbols: int = 148,
        steps: int = 100,
        seed: int = 0,
    ):
        super().__init__(steps)
        self.batch_size = batch_size
        self.max_text_len, self.max_mel_len = max_text_len, max_mel_len
        self.n_mels, self.n_symbols = n_mels, n_symbols
        self.rng = np.random.default_rng(seed)

    def _make(self):
        b = self.batch_size
        text_lens = self.rng.integers(self.max_text_len // 2, self.max_text_len, b)
        mel_lens = self.rng.integers(self.max_mel_len // 2, self.max_mel_len, b)
        text = self.rng.integers(1, self.n_symbols, (b, self.max_text_len))
        for i, l in enumerate(text_lens):
            text[i, l:] = 0
        mel = self.rng.normal(size=(b, self.max_mel_len, self.n_mels))
        return {
            "text": text.astype(np.int32),
            "text_lengths": text_lens.astype(np.int32),
            "mel": mel.astype(np.float32),
            "mel_lengths": mel_lens.astype(np.int32),
        }


class SyntheticWaveGlowLoader(_Synthetic):
    def __init__(
        self,
        batch_size: int,
        segment_length: int = 8000,
        hop_length: int = 256,
        n_mels: int = 80,
        steps: int = 100,
        seed: int = 0,
    ):
        super().__init__(steps)
        self.batch_size = batch_size
        self.segment_length, self.hop_length, self.n_mels = (
            segment_length, hop_length, n_mels,
        )
        self.rng = np.random.default_rng(seed)

    def _make(self):
        b = self.batch_size
        t_mel = self.segment_length // self.hop_length + 1
        return {
            "audio": (self.rng.normal(size=(b, self.segment_length)) * 0.1).astype(
                np.float32
            ),
            "mel": self.rng.normal(size=(b, t_mel, self.n_mels)).astype(np.float32),
        }
