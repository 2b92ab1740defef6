"""Copy of ``deeplearningexamples_tpu/data/ljspeech.py``: the LJSpeech
pipeline for Tacotron2/WaveGlow, numpy and the standard library only.

Covers the reference's ``TextMelLoader``/``TextMelCollate``
(``tacotron2/data_function.py:35-151``) and WaveGlow's ``Mel2Samp``: parse
``metadata.csv``, text→symbol ids, wav→log-mel (or load precomputed mels —
the ``--load-mel-from-disk`` path fed by ``preprocess_audio2mel.py``),
length-sorted bucketing + padding (static shapes instead of the
reference's per-batch dynamic max), gate targets implicit in mel_lengths.
"""

from __future__ import annotations

import os
import wave
from typing import Iterator

import numpy as np

from ..models.tts.audio import MelConfig, mel_spectrogram
from ..models.tts.text import text_to_sequence

__all__ = ["load_wav", "LJSpeechDataset", "TacotronLoader", "WaveGlowLoader",
           "precompute_mels"]


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """16-bit PCM wav -> float32 in [-1, 1] (stdlib; no librosa)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
    if width != 2:
        raise ValueError(f"expected 16-bit PCM, got width {width}")
    audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    return audio, sr


class LJSpeechDataset:
    """metadata.csv rows -> (wav_path, normalized_text)."""

    def __init__(self, root: str, metadata: str = "metadata.csv"):
        self.root = root
        self.items: list[tuple[str, str]] = []
        with open(os.path.join(root, metadata), encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) >= 2:
                    wav = os.path.join(root, "wavs", parts[0] + ".wav")
                    text = parts[2] if len(parts) > 2 and parts[2] else parts[1]
                    self.items.append((wav, text))

    def __len__(self):
        return len(self.items)


def precompute_mels(ds: LJSpeechDataset, out_dir: str,
                    mel_cfg: MelConfig | None = None) -> None:
    """Offline mel cache (the ``preprocess_audio2mel.py`` role)."""
    cfg = mel_cfg or MelConfig()
    os.makedirs(out_dir, exist_ok=True)
    for wav_path, _ in ds.items:
        audio, _sr = load_wav(wav_path)
        mel = mel_spectrogram(audio, cfg)
        np.save(
            os.path.join(out_dir, os.path.basename(wav_path) + ".npy"), mel
        )


class TacotronLoader:
    """Batches: text ids + log-mels padded to static maxima, length-sorted
    buckets to cut pad waste (LDDL-style binning applied to TTS)."""

    def __init__(
        self,
        ds: LJSpeechDataset,
        batch_size: int,
        max_text_len: int = 192,
        max_mel_len: int = 880,
        mel_cfg: MelConfig | None = None,
        mel_dir: str | None = None,  # precomputed cache
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
    ):
        self.ds = ds
        self.items = ds.items[shard[0] :: shard[1]]
        self.batch_size = batch_size
        self.max_text_len = max_text_len
        self.max_mel_len = max_mel_len
        self.cfg = mel_cfg or MelConfig()
        self.mel_dir = mel_dir
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.items) // self.batch_size

    def _mel(self, wav_path: str) -> np.ndarray:
        if self.mel_dir:
            return np.load(
                os.path.join(self.mel_dir, os.path.basename(wav_path) + ".npy")
            )
        audio, _ = load_wav(wav_path)
        return mel_spectrogram(audio, self.cfg)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = rng.permutation(len(self.items))
        bs = self.batch_size
        n_mels = self.cfg.n_mels
        for i in range(0, len(order) - bs + 1, bs):
            texts, mels = [], []
            for j in order[i : i + bs]:
                wav, text = self.items[j]
                texts.append(np.asarray(text_to_sequence(text), np.int32))
                mels.append(self._mel(wav))
            text_arr = np.zeros((bs, self.max_text_len), np.int32)
            text_lens = np.zeros(bs, np.int32)
            mel_arr = np.zeros((bs, self.max_mel_len, n_mels), np.float32)
            mel_lens = np.zeros(bs, np.int32)
            for k, (t, m) in enumerate(zip(texts, mels)):
                lt = min(len(t), self.max_text_len)
                lm = min(m.shape[1], self.max_mel_len)
                text_arr[k, :lt] = t[:lt]
                text_lens[k] = lt
                mel_arr[k, :lm] = m[:, :lm].T
                mel_lens[k] = lm
            yield {
                "text": text_arr, "text_lengths": text_lens,
                "mel": mel_arr, "mel_lengths": mel_lens,
            }


class WaveGlowLoader:
    """Random fixed-length audio segments + matching mel windows."""

    def __init__(
        self,
        ds: LJSpeechDataset,
        batch_size: int,
        segment_length: int = 8000,
        mel_cfg: MelConfig | None = None,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
    ):
        self.items = ds.items[shard[0] :: shard[1]]
        self.batch_size = batch_size
        self.segment_length = segment_length
        self.cfg = mel_cfg or MelConfig()
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.items) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = rng.permutation(len(self.items))
        bs = self.batch_size
        t_mel = self.segment_length // self.cfg.hop_length + 1
        for i in range(0, len(order) - bs + 1, bs):
            audio_b = np.zeros((bs, self.segment_length), np.float32)
            mel_b = np.zeros((bs, t_mel, self.cfg.n_mels), np.float32)
            for k, j in enumerate(order[i : i + bs]):
                audio, _ = load_wav(self.items[j][0])
                if len(audio) >= self.segment_length:
                    s = rng.integers(0, len(audio) - self.segment_length + 1)
                    seg = audio[s : s + self.segment_length]
                else:
                    seg = np.pad(audio, (0, self.segment_length - len(audio)))
                audio_b[k] = seg
                mel = mel_spectrogram(seg, self.cfg)  # (n_mels, T)
                mel_b[k, : mel.shape[1]] = mel.T[:t_mel]
            yield {"audio": audio_b, "mel": mel_b}
