"""Serving recipes: endpoint builders that wrap a model's batched inference
in a ``ContinuousBatcher`` and return a ready ``ModelEndpoint``.

Port of ``deeplearningexamples_tpu/serving/recipes.py``, all eleven recipes
(the reference's per-family ``triton/`` deployments and inference scripts).
Each keeps JAX's wire contract letter for letter: the endpoint ``name``, the
``input_spec`` names, per-request shapes and dtype strings, the
``output_names`` and the default ``batch_buckets``, ``max_out``,
``beam_size`` and ``gen_len``. A client written for the JAX server works
against this one unchanged; images arrive NHWC fp32, as there.

- ``efficientdet_endpoint``, ``maskrcnn_endpoint``: image -> detections
  (and 28 x 28 mask grids), through the task's ``predict``;
- ``bart_endpoint``: padded source ids -> the best beam of the KV-cached
  beam search (K1 runs in the encoder and the cross-attention at Sq = 1);
- ``gnmt_endpoint``: padded source ids -> the best beam of the full-prefix
  beam search (the LSTM decoder is causal, so re-decoding is exact);
- ``tft_endpoint``: observed + known windows -> per-quantile forecasts;
- ``transformer_xl_generate_endpoint``: a ``seg_len`` context -> ``gen_len``
  greedy tokens, each step re-running the whole window with no memory;
- ``unet_endpoint``: a channels-last patch -> per-voxel labels and fp32
  probabilities, 2-D or 3-D;
- ``ncf_endpoint``: a user and candidate items -> scores and the ranking
  (a stable sort, so ties rank as in JAX);
- ``fastpitch_hifigan_endpoint``: padded symbol ids -> the waveform, through
  ``FastPitch.infer`` (at a fixed ``max_mel_len``) and the HiFi-GAN
  generator, with ``audio_len = mel_len x hop`` for the client to trim;
- ``jasper_offline_endpoint``: padded mel features and their valid count ->
  greedy-CTC token ids. The features' padded tail is zeroed, the model runs
  on its device, frames past the valid count are set to blank, and the
  collapse runs on the host (the reference's client-side decoder);
- ``quartznet_streaming_server``: a ``StreamingAsrServer`` (the Kaldi
  recipe) whose ``infer_fn`` runs the CTC model on its device.

The models run on the device their parameters are on, under
``torch.no_grad()``, in eval mode. Integer outputs are int32 and the loops
of the searches run on the host with every tensor on the device, as
``models/translation/beam_search.py`` sets out.
"""

from __future__ import annotations

import numpy as np
import torch

from .batcher import ContinuousBatcher
from .server import ModelEndpoint

__all__ = [
    "efficientdet_endpoint",
    "maskrcnn_endpoint",
    "bart_endpoint",
    "tft_endpoint",
    "quartznet_streaming_server",
    "jasper_offline_endpoint",
    "gnmt_endpoint",
    "transformer_xl_generate_endpoint",
    "unet_endpoint",
    "ncf_endpoint",
    "fastpitch_hifigan_endpoint",
]


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    """A batched numpy input as a tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)


def efficientdet_endpoint(task, model, *, name: str = "efficientdet",
                          batch_buckets=(1, 2, 4, 8), max_out: int = 100,
                          score_threshold: float = 0.05) -> ModelEndpoint:
    """Input ``image`` (S, S, 3) fp32; outputs ``boxes`` (max_out, 4),
    ``scores``, ``labels`` (int32) and ``valid`` (bool), each image's picks
    first (reference EfficientDet ``validate.py``)."""
    s = task.cfg.image_size
    model.eval()
    dev = _device(model)

    def fn(batch):
        boxes, scores, labels, valid = task.predict(
            model, _tensor(batch["image"], dev, torch.float32),
            max_out=max_out, score_threshold=score_threshold)
        return {"boxes": boxes, "scores": scores,
                "labels": labels.to(torch.int32), "valid": valid}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"image": ((s, s, 3), "float32")},
        output_names=("boxes", "scores", "labels", "valid"))


def maskrcnn_endpoint(task, model, *, name: str = "maskrcnn",
                      batch_buckets=(1, 2, 4), max_out: int = 50,
                      score_threshold: float = 0.05) -> ModelEndpoint:
    """Input ``image`` (S, S, 3) fp32; outputs the detections as
    ``efficientdet_endpoint``'s and ``masks`` (max_out, 28, 28), each pick's
    sigmoid mask grid."""
    s = task.cfg.image_size
    model.eval()
    dev = _device(model)

    def fn(batch):
        boxes, scores, labels, valid, masks = task.predict(
            model, _tensor(batch["image"], dev, torch.float32),
            max_out=max_out, score_threshold=score_threshold)
        return {"boxes": boxes, "scores": scores,
                "labels": labels.to(torch.int32), "valid": valid,
                "masks": masks}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"image": ((s, s, 3), "float32")},
        output_names=("boxes", "scores", "labels", "valid", "masks"))


def bart_endpoint(model, tcfg, *, name: str = "bart", beam_size: int = 4,
                  max_target_len: int = 64,
                  batch_buckets=(1, 2, 4, 8)) -> ModelEndpoint:
    """Summarization (reference BART ``run_eval.py``): input ``src``
    (tcfg.max_len,) int32 padded ids; outputs ``tokens`` (max_target_len,)
    int32 and ``scores``, the best beam's. The encoder's output and mask are
    tiled ``beam_size`` times for ``beam_search_cached``, which raises past
    the cache's ``cfg.max_len``."""
    from ..models.translation import beam_search_cached

    model.eval()
    dev = _device(model)

    def fn(batch):
        src = _tensor(batch["src"], dev, torch.long)
        with torch.no_grad():
            memory, memory_mask = model.encode(src)
            seqs, scores = beam_search_cached(
                model, memory.repeat_interleave(beam_size, 0),
                memory_mask.repeat_interleave(beam_size, 0),
                src.shape[0], beam_size, max_len=max_target_len,
                bos_id=tcfg.bos_id, eos_id=tcfg.eos_id, pad_id=tcfg.pad_id,
                vocab_size=tcfg.vocab_size)
        return {"tokens": seqs[:, 0].to(torch.int32), "scores": scores[:, 0]}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"src": ((tcfg.max_len,), "int32")},
        output_names=("tokens", "scores"))


def tft_endpoint(task, model, *, name: str = "tft",
                 batch_buckets=(1, 2, 4, 8, 16)) -> ModelEndpoint:
    """Forecasting (reference ``TFT/triton/``): inputs ``observed``
    (encoder_len, n_observed) and ``known`` (encoder_len + horizon, n_known)
    fp32; output ``quantiles`` (horizon, n_quantiles)."""
    cfg = task.cfg
    model.eval()
    dev = _device(model)

    def fn(batch):
        return {"quantiles": task.predict_fn(
            model, _tensor(batch["observed"], dev, torch.float32),
            _tensor(batch["known"], dev, torch.float32))}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={
            "observed": ((cfg.encoder_len, cfg.n_observed), "float32"),
            "known": ((cfg.encoder_len + cfg.horizon, cfg.n_known), "float32"),
        },
        output_names=("quantiles",))


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


def gnmt_endpoint(task, model, *, name: str = "gnmt", beam_size: int = 4,
                  max_len: int = 32, max_target_len: int = 32,
                  batch_buckets=(1, 2, 4)) -> ModelEndpoint:
    """Translation (reference ``GNMT/translate.py``): input ``src``
    (max_len,) int32 padded ids; outputs ``tokens`` (max_target_len,) int32
    and ``scores``, the best beam of the length-normalised full-prefix beam
    search on the model's device."""
    from ..models.translation.beam_search import beam_search

    cfg = task.cfg
    model.eval()
    dev = _device(model)

    def fn(batch):
        src = _tensor(batch["src"], dev, torch.long)
        with torch.no_grad():
            memory, mask = model.encode(src)
            mem_t = memory.repeat_interleave(beam_size, 0)
            mask_t = mask.repeat_interleave(beam_size, 0)
            seqs, scores = beam_search(
                lambda tgt: model.decode(tgt, mem_t, mask_t), src.shape[0],
                beam_size, max_len=max_target_len, bos_id=cfg.bos_id,
                eos_id=cfg.eos_id, pad_id=cfg.pad_id,
                vocab_size=cfg.vocab_size, device=dev)
        return {"tokens": seqs[:, 0].to(torch.int32), "scores": scores[:, 0]}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"src": ((max_len,), "int32")},
        output_names=("tokens", "scores"))


def transformer_xl_generate_endpoint(task, model, *,
                                     name: str = "transformer_xl",
                                     gen_len: int = 32,
                                     batch_buckets=(1, 2, 4)) -> ModelEndpoint:
    """Greedy generation: input ``context`` (seg_len,) int32; output
    ``generated`` (gen_len,) int32. Each step re-runs the whole window with
    no memory (``mem_valid`` 0, where the relative positions need no
    reslicing), takes the argmax of the last position's logits over the
    first ``vocab_size`` columns (a padded id is never emitted or fed back)
    and rolls the window by one."""
    cfg = task.cfg
    model.eval()
    dev = _device(model)

    def fn(batch):
        window = _tensor(batch["context"], dev, torch.long)
        out = torch.empty((window.shape[0], gen_len), dtype=torch.int32,
                          device=dev)
        with torch.no_grad():
            for i in range(gen_len):
                logits, _ = model(window)
                nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)
                window = torch.cat([window[:, 1:], nxt[:, None]], 1)
                out[:, i] = nxt.to(torch.int32)
        return {"generated": out}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"context": ((cfg.seg_len,), "int32")},
        output_names=("generated",))


def unet_endpoint(task, model, *, name: str = "unet", patch: int = 64,
                  batch_buckets=(1, 2, 4)) -> ModelEndpoint:
    """Segmentation (reference ``nnUNet/triton/``): input ``image``
    (*patch, in_channels) fp32, channels last, 2-D or 3-D by
    ``cfg.spatial_rank``; outputs ``mask`` (*patch,) int32, the argmax over
    classes, and ``probs`` (*patch, n_classes), the softmax in fp32."""
    cfg = task.cfg
    model.eval()
    dev = _device(model)

    def fn(batch):
        image = _tensor(batch["image"], dev, torch.float32)
        with torch.no_grad():
            logits = model(image.movedim(-1, 1)).movedim(1, -1)
        probs = torch.softmax(logits.float(), -1)
        return {"mask": logits.argmax(-1).to(torch.int32), "probs": probs}

    spatial = (patch,) * cfg.spatial_rank
    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"image": ((*spatial, cfg.in_channels), "float32")},
        output_names=("mask", "probs"))


def ncf_endpoint(task, model, *, name: str = "ncf", n_candidates: int = 100,
                 batch_buckets=(1, 2, 4, 8, 16)) -> ModelEndpoint:
    """Recommendation (reference ``NCF/inference.py``): inputs ``user``
    (1,) and ``items`` (n_candidates,) int32; outputs ``scores``
    (n_candidates,) and ``ranking``, the items' positions best first. The
    pairs run as one flat batch; the sort is stable (``jnp.argsort``'s), so
    tied scores rank by position."""
    model.eval()
    dev = _device(model)

    def fn(batch):
        items = _tensor(batch["items"], dev, torch.long)
        users = _tensor(batch["user"], dev, torch.long).expand_as(items)
        with torch.no_grad():
            s = model(users.reshape(-1), items.reshape(-1)).reshape(
                items.shape)
        order = torch.argsort(-s, dim=-1, stable=True)
        return {"scores": s, "ranking": order.to(torch.int32)}

    return ModelEndpoint(
        name=name,
        batcher=ContinuousBatcher(fn, batch_buckets=batch_buckets),
        input_spec={"user": ((1,), "int32"),
                    "items": ((n_candidates,), "int32")},
        output_names=("scores", "ranking"))


def quartznet_streaming_server(task, model, *, chunk_frames: int = 64,
                               context_frames: int = 32, mel_cfg=None):
    """Streaming ASR over a CTC model (the Kaldi serving recipe;
    QuartzNet-15x5 by default): a ``StreamingAsrServer`` whose sessions hold
    each correlation id's state. ``infer_fn`` runs the model on its device
    and returns numpy log-probs; ``time_stride`` is the product of the
    blocks' strides."""
    from ..models.tts.audio import MelConfig
    from .streaming_asr import StreamingAsrServer

    model.eval()
    dev = _device(model)

    def infer_fn(mel):
        with torch.no_grad():
            logp = model(_tensor(np.asarray(mel, np.float32), dev))
        return logp.float().cpu().numpy()

    stride = int(np.prod([b.stride for b in task.cfg.blocks]))
    return StreamingAsrServer(
        infer_fn, mel_cfg=mel_cfg or MelConfig(n_mels=task.cfg.n_mels),
        chunk_frames=chunk_frames, context_frames=context_frames,
        time_stride=stride)
