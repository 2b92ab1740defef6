"""Copy of ``deeplearningexamples_tpu/serving/streaming_asr.py``: streaming
ASR sessions over a CTC model (the Kaldi serving recipe), numpy only.

The reference ships a Triton C++ backend wrapping Kaldi's online decoder
(``Kaldi/SpeechRecognition/kaldi-asr-backend/triton-kaldi-backend.cc`` +
``kaldi-asr-client``): clients stream audio chunks for a correlation id,
the server keeps per-stream decoder state, and partial transcripts flow
back until ``end_of_sequence``. This module reproduces that serving
surface over the port's CTC models:

- :class:`StreamingAsrSession`: per-stream state: the audio so far, the
  mel frames that are final, and the running CTC collapse state (the last
  token), so partials are prefixes of the final transcript;
- :class:`StreamingAsrServer`: correlation id -> session, with
  ``process_chunk(corr_id, audio, last=False)``, the Triton sequence
  batcher's contract.

Three behaviours carry the exactness: a mel frame is final only once
``t * hop + n_fft / 2 <= len(audio)`` (reflect-padded centring), so the
chunked features equal the full utterance's; decoding waits until chunk +
context frames of right context are banked (SAME-padded convolutions see
the future too), so a window's kept band sees only real features; and every
window is padded with zeros on the right to one frame budget, ``2 * context
+ chunk``, so the model sees one shape. Jasper and QuartzNet are
convolutional with a finite receptive field, so the kept band's log-probs
equal a full-utterance forward's wherever the context covers it; only the
flush's last frames differ a little (BN's shift in the zero-padded tail).
``infer_fn`` maps (1, T, n_mels) fp32 to (1, T / stride, V) numpy
log-probs, computed wherever the model lives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..models.tts.audio import MelConfig, mel_spectrogram

__all__ = ["StreamingAsrSession", "StreamingAsrServer"]


@dataclass
class StreamingAsrSession:
    infer_fn: Callable[[np.ndarray], np.ndarray]  # (1,T,M)->(1,T',V) logp
    mel_cfg: MelConfig
    chunk_frames: int  # frames evaluated per step (static shape)
    context_frames: int  # left context >= model receptive field
    time_stride: int = 1  # model's cumulative time downsampling (Jasper: 2)
    blank: int = 0
    _audio: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    _mel_buf: np.ndarray | None = None
    _emitted: int = 0  # mel frames already decoded
    _prev_tok: int = -1
    tokens: list = field(default_factory=list)

    def _append_audio(self, audio: np.ndarray, flush: bool) -> None:
        """Recompute the mel up to the last FINAL frame: with reflect-pad
        centering, frame t only stops depending on future audio once
        ``t*hop + n_fft/2 <= len(audio)`` — earlier frames are bit-stable,
        so chunked features match the full-utterance features exactly.
        (Recompute-from-start keeps this module simple; an incremental
        STFT is a drop-in replacement behind the same interface.)"""
        cfg = self.mel_cfg
        self._audio = np.concatenate([self._audio,
                                      audio.astype(np.float32)])
        pad = cfg.n_fft // 2
        if len(self._audio) <= cfg.n_fft:
            return
        total = 1 + (len(self._audio) + 2 * pad - cfg.n_fft) \
            // cfg.hop_length
        safe = total if flush else max(
            0, (len(self._audio) - pad) // cfg.hop_length + 1)
        have = 0 if self._mel_buf is None else self._mel_buf.shape[0]
        if safe > have:
            mel = mel_spectrogram(self._audio, cfg).T  # (T, M)
            self._mel_buf = mel[:safe]

    def _decode_ready(self, flush: bool) -> None:
        while self._mel_buf is not None:
            avail = self._mel_buf.shape[0] - self._emitted
            # SAME-padded convs need RIGHT context too: without flush, wait
            # until chunk + context frames are banked so the emitted band's
            # receptive field sees only real features
            need = 1 if flush else self.chunk_frames + self.context_frames
            if avail < need:
                break
            s = self.time_stride
            take = min(self.chunk_frames, avail)
            if take % s and not (flush and take == avail):
                take -= take % s
            if take <= 0:
                break
            start = max(self._emitted - self.context_frames, 0)
            ctx = self._emitted - start
            end = min(self._emitted + take + self.context_frames,
                      self._mel_buf.shape[0])
            window = self._mel_buf[start:end]
            # pad to the static frame budget (zeros right — identical to
            # the full-utterance conv's own SAME padding at the tail)
            total = 2 * self.context_frames + self.chunk_frames
            pad = total - window.shape[0]
            if pad > 0:
                window = np.pad(window, ((0, pad), (0, 0)))
            logp = self.infer_fn(window[None])[0]  # (T/stride, V)
            logp = logp[ctx // s:-(-(ctx + take) // s)]
            for t in np.argmax(logp, axis=-1):
                if t != self._prev_tok and t != self.blank:
                    self.tokens.append(int(t))
                self._prev_tok = int(t)
            self._emitted += take

    def push(self, audio: np.ndarray, last: bool = False) -> list:
        """Feed a chunk; returns the transcript-so-far (token ids)."""
        self._append_audio(audio, flush=last)
        self._decode_ready(flush=last)
        return list(self.tokens)


class StreamingAsrServer:
    """Correlation-id session registry (the Triton sequence-batcher
    contract: START on first chunk, END via ``last=True``)."""

    def __init__(self, infer_fn, mel_cfg: MelConfig | None = None,
                 chunk_frames: int = 64, context_frames: int = 64,
                 time_stride: int = 1, blank: int = 0):
        self.infer_fn = infer_fn
        self.mel_cfg = mel_cfg or MelConfig()
        self.chunk_frames = chunk_frames
        self.context_frames = context_frames
        self.time_stride = time_stride
        self.blank = blank
        self._sessions: dict[Any, StreamingAsrSession] = {}

    def process_chunk(self, corr_id, audio: np.ndarray,
                      last: bool = False) -> dict:
        sess = self._sessions.get(corr_id)
        if sess is None:
            sess = StreamingAsrSession(
                self.infer_fn, self.mel_cfg, self.chunk_frames,
                self.context_frames, self.time_stride, self.blank,
            )
            self._sessions[corr_id] = sess
        tokens = sess.push(audio, last=last)
        if last:
            del self._sessions[corr_id]
        return {"transcript": tokens, "final": last}

    @property
    def active_streams(self) -> int:
        return len(self._sessions)
