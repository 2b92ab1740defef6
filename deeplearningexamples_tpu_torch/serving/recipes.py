"""Serving recipes: endpoint builders that wrap a model's batched inference
in a ``ContinuousBatcher`` and return a ready ``ModelEndpoint``.

Port of the speech recipes of ``deeplearningexamples_tpu/serving/recipes.py``:

- ``fastpitch_hifigan_endpoint``: padded symbol ids -> the waveform, through
  ``FastPitch.infer`` (at a fixed ``max_mel_len``) and the HiFi-GAN
  generator, with ``audio_len = mel_len x hop`` for the client to trim;
- ``jasper_offline_endpoint``: padded mel features and their valid count ->
  greedy-CTC token ids. The features' padded tail is zeroed, the model runs
  on its device, frames past the valid count are set to blank, and the
  collapse runs on the host (the reference's client-side decoder).

The models run on the device their parameters are on, under
``torch.no_grad()``, in the training modules' eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from .batcher import ContinuousBatcher
from .server import ModelEndpoint

__all__ = ["fastpitch_hifigan_endpoint", "jasper_offline_endpoint"]


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def jasper_offline_endpoint(task, model, *, name: str = "jasper",
                            max_frames: int = 512, max_tokens: int = 128,
                            batch_buckets=(1, 2, 4, 8)) -> ModelEndpoint:
    """Inputs ``feats`` (max_frames, n_mels) fp32 and ``feat_len`` (1,)
    int32; outputs ``tokens`` (max_tokens,) int32, -1 past the end, and
    ``n_tokens`` (1,)."""
    from ..models.asr import greedy_ctc_decode

    stride = int(np.prod([b.stride for b in task.cfg.blocks]))
    model.eval()
    dev = _device(model)

    def fn(batch):
        feats = np.asarray(batch["feats"])
        flen = np.asarray(batch["feat_len"])[:, 0]
        # zero the padded tail: the convolutions reach across the boundary
        t_in = np.arange(feats.shape[1])
        feats = np.where((t_in < flen[:, None])[:, :, None], feats, 0.0)
        with torch.no_grad():
            logp = model(torch.from_numpy(feats.astype(np.float32)).to(dev))
        logp = logp.cpu().numpy()
        n_valid = (flen + stride - 1) // stride
        t_idx = np.arange(logp.shape[1])[None, :]
        blank_only = np.full_like(logp, -1e9)
        blank_only[:, :, 0] = 0.0
        logp = np.where((t_idx < n_valid[:, None])[:, :, None], logp,
                        blank_only)
        tokens = np.full((logp.shape[0], max_tokens), -1, np.int32)
        n_tokens = np.zeros((logp.shape[0], 1), np.int32)
        for i, toks in enumerate(greedy_ctc_decode(logp)):
            toks = toks[:max_tokens]
            tokens[i, :len(toks)] = toks
            n_tokens[i, 0] = len(toks)
        return {"tokens": tokens, "n_tokens": n_tokens}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"feats": ((max_frames, task.cfg.n_mels), "float32"),
                    "feat_len": ((1,), "int32")},
        output_names=("tokens", "n_tokens"))


def fastpitch_hifigan_endpoint(fp_task, fastpitch, hifi_task, generator, *,
                               name: str = "fastpitch_tts",
                               max_text_len: int = 128,
                               max_mel_len: int = 832, pace: float = 1.0,
                               batch_buckets=(1, 2, 4)) -> ModelEndpoint:
    """Input ``text`` (max_text_len,) int32 symbol ids, 0-padded; outputs
    ``audio`` (max_mel_len x hop,) fp32, ``audio_len`` and ``mel_len``."""
    hop = hifi_task.cfg.hop_length
    if fp_task.cfg.n_mels != hifi_task.cfg.n_mels:
        raise ValueError(
            f"FastPitch n_mels {fp_task.cfg.n_mels} != HiFiGAN n_mels "
            f"{hifi_task.cfg.n_mels}")
    up = int(np.prod(hifi_task.cfg.upsample_rates))
    if up != hop:
        raise ValueError(
            f"HiFiGAN upsample_rates product {up} != hop_length {hop}; "
            "audio_len (= mel frames x hop) would mis-state the waveform")
    fastpitch.eval()
    generator.eval()
    dev = _device(fastpitch)

    def fn(batch):
        text = torch.from_numpy(np.asarray(batch["text"], np.int32)).to(dev)
        with torch.no_grad():
            mel, mel_len = fastpitch.infer(text, pace=pace,
                                           max_mel_len=max_mel_len)
            audio = generator(mel).float()
        return {"audio": audio, "audio_len": mel_len * hop,
                "mel_len": mel_len}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"text": ((max_text_len,), "int32")},
        output_names=("audio", "audio_len", "mel_len"))
