"""FastPitch: parallel (non-autoregressive) mel synthesis, in PyTorch.

Port of ``deeplearningexamples_tpu/models/tts/fastpitch.py`` (reference
``PyTorch/SpeechSynthesis/FastPitch/fastpitch/{model,transformer}.py``),
with the reference's ``state_dict`` names (``encoder.word_emb``,
``encoder.layers.{i}.dec_attn.qkv_net``, ``.pos_ff.CoreNet.0`` ...,
``duration_predictor.layers.{i}.conv``, ``pitch_emb``, ``proj``), so
``utils/torch_import.convert_fastpitch`` in the JAX package maps a port
``state_dict`` into the JAX tree:

- the FFTransformer: a word embedding (flax's ``nn.Embed``, whose padding
  row is not zeroed), the concatenated ``[sin | cos]`` positional table
  (``max(max_mel_len, 2048)`` rows) masked and added, then post-LN blocks
  re-masked after the attention and after the conv FF;
- the attention: one fused qkv projection of width ``3 * n_heads *
  head_dim`` (one head of 64 against d 384), the flash kernels (K1/K2) in
  the (B, S, H, D) layout with the key mask, read in place from the
  projection, and an output projection without bias. With dropout on, the
  probabilities drop at ``dropatt`` inside the kernel, with a fresh int32
  seed per block from ``attention_seed``;
- the temporal predictors (conv, ReLU, LayerNorm, dropout, twice; then an
  fp32 linear head), pitch and energy embedded by a conv and added, energy
  predicted from the pitch-conditioned encoder output;
- ``length_regulate``, a ``searchsorted(right=True)`` gather to a fixed
  ``max_mel_len`` with a validity mask, and ``mel_proj`` in fp32.

Parameters are fp32 and every layer computes in ``dtype``, as flax's
``dtype`` does. Training uses ground-truth durations (the reference's
external-alignment mode); the online aligner is not part of the model here
or in JAX. Hidden dropout is ``ops.dropout.RegenDropout``, whose bits
cannot match ``jax.random``; the attention dropout's hash is JAX's bit for
bit, given the same seed.

Under a data axis (``parallel/mesh.py``) each rank hashes its rows of K1's
dropout as their rows of the global batch (``dropout_batch_offset``), and
the masked means divide by the global batch's counts (``data_mean``), so a
step computes what the one-rank run computes on the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import RegenDropout
from ...ops.flash_attention import flash_attention
from ...parallel.mesh import data_mean, data_rows
from ..bert.modeling import LayerNorm
from ..convnets.layers import Dense
from .layers import Conv1d, acc_dtype

__all__ = ["FastPitch", "FastPitchConfig", "FastPitchTask", "FFTBlock",
           "Predictor", "attention_seed", "average_over_durations",
           "length_regulate"]


@dataclass(frozen=True)
class FastPitchConfig:
    """The JAX ``FastPitchConfig``'s fields and defaults."""

    n_symbols: int = 148
    d_model: int = 384
    n_heads: int = 1
    head_dim: int = 64
    encoder_layers: int = 6
    decoder_layers: int = 6
    conv_kernel: int = 3
    conv_filters: int = 1536
    n_mels: int = 80
    max_mel_len: int = 900
    dropout: float = 0.1
    dropatt: float = 0.1
    predictor_filters: int = 256
    predictor_kernel: int = 3
    predictor_layers: int = 2
    predictor_dropout: float = 0.1
    pitch_kernel: int = 3
    energy: bool = True  # the reference's energy_conditioning default
    energy_kernel: int = 3


def attention_seed(generator: torch.Generator) -> int:
    """One block's attention-dropout seed: an int32, as JAX's
    ``randint(-2**31, 2**31 - 1)``. The CPU tests replace it with JAX's
    seeds."""
    return int(torch.randint(-2**31, 2**31 - 1, (1,), generator=generator))


def length_regulate(x: torch.Tensor, durations: torch.Tensor, max_len: int):
    """Expand (B, T, D) by integer durations to (B, max_len, D), and the
    (B, max_len) mask of the frames within the total duration. Frame j takes
    the symbol whose cumulative-duration interval holds j; frames past the
    total are 0."""
    ends = durations.long().cumsum(1)
    pos = torch.arange(max_len, device=x.device)
    src = torch.searchsorted(ends, pos.expand(x.shape[0], max_len).contiguous(),
                             right=True).clamp(0, x.shape[1] - 1)
    out = x.gather(1, src[:, :, None].expand(-1, -1, x.shape[2]))
    mask = pos[None, :] < ends[:, -1:]
    return out * mask[:, :, None].to(x.dtype), mask


def average_over_durations(values: torch.Tensor,
                           durations: torch.Tensor) -> torch.Tensor:
    """Per-symbol mean of frame values (B, L) over each symbol's span,
    counting only nonzero frames (the reference's ``average_pitch``): (B,
    T), 0 where a span has no nonzero frame."""
    ends = durations.long().cumsum(1)
    starts = F.pad(ends[:, :-1], (1, 0))
    zero = values.new_zeros(values.shape[0], 1)
    csum = torch.cat([zero, values.cumsum(1)], 1)
    cnz = torch.cat([zero, (values != 0.0).to(values.dtype).cumsum(1)], 1)
    n = values.shape[1]
    e, s = ends.clamp(0, n), starts.clamp(0, n)
    sums = csum.gather(1, e) - csum.gather(1, s)
    nelems = cnz.gather(1, e) - cnz.gather(1, s)
    return torch.where(nelems == 0.0, 0.0, sums / nelems.clamp_min(1.0))


def _positional(max_len: int, d_model: int) -> np.ndarray:
    """The concatenated ``[sin | cos]`` table (not interleaved), fp32."""
    inv = 1.0 / (10000 ** (np.arange(0.0, d_model, 2.0) / d_model))
    ang = np.arange(max_len)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def _conv_btc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A (B, C, T) convolution (or stack of them) applied to (B, T, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class _MultiHeadAttn(nn.Module):
    def __init__(self, cfg: FastPitchConfig, dtype: torch.dtype):
        super().__init__()
        self.n_heads, self.head_dim, self.dropatt = (cfg.n_heads, cfg.head_dim,
                                                     cfg.dropatt)
        width = cfg.n_heads * cfg.head_dim
        self.qkv_net = Dense(cfg.d_model, 3 * width, dtype)
        self.o_net = Dense(width, cfg.d_model, dtype, bias=False)
        self.layer_norm = LayerNorm(cfg.d_model, 1e-5, dtype)

    def forward(self, x, mask, seed):
        """The context before ``o_net``; ``seed`` None runs without
        dropout."""
        b, s, _ = x.shape
        q, k, v = (t.view(b, s, self.n_heads, self.head_dim) for t in
                   self.qkv_net(x).split(self.n_heads * self.head_dim, -1))
        rate = self.dropatt if seed is not None else 0.0
        # K1 hashes each row's dropout bits by its row of the global batch
        ctx = flash_attention(q, k, v, key_mask=mask, layout="bshd",
                              dropout_rate=rate, dropout_seed=seed or 0,
                              dropout_batch_offset=data_rows(b)[0])
        return ctx.reshape(b, s, self.n_heads * self.head_dim)


class _PositionwiseConvFF(nn.Module):
    def __init__(self, cfg: FastPitchConfig, dtype: torch.dtype):
        super().__init__()
        self.CoreNet = nn.Sequential(
            Conv1d(cfg.d_model, cfg.conv_filters, cfg.conv_kernel, dtype=dtype),
            nn.ReLU(),
            Conv1d(cfg.conv_filters, cfg.d_model, cfg.conv_kernel, dtype=dtype))
        self.layer_norm = LayerNorm(cfg.d_model, 1e-5, dtype)


class FFTBlock(nn.Module):
    """The reference's ``TransformerLayer``: post-LN attention, re-masked,
    then the conv FF, re-masked."""

    def __init__(self, cfg: FastPitchConfig, dtype: torch.dtype):
        super().__init__()
        self.dec_attn = _MultiHeadAttn(cfg, dtype)
        self.pos_ff = _PositionwiseConvFF(cfg, dtype)
        self.drop = RegenDropout(cfg.dropout)

    def forward(self, x, mask, generator=None, seed=None):
        m = mask[:, :, None].to(x.dtype)
        attn = self.dec_attn
        ctx = self.drop(attn.o_net(attn(x, mask, seed)), generator)
        x = attn.layer_norm(x + ctx) * m
        y = _conv_btc(self.pos_ff.CoreNet, x)
        y = self.drop(y, generator)
        return self.pos_ff.layer_norm(x + y) * m


class _FFTransformer(nn.Module):
    def __init__(self, cfg: FastPitchConfig, dtype: torch.dtype, n: int,
                 embed: bool):
        super().__init__()
        if embed:
            self.word_emb = nn.Embedding(cfg.n_symbols, cfg.d_model)
        self.layers = nn.ModuleList(FFTBlock(cfg, dtype) for _ in range(n))


class _ConvReLUNorm(nn.Module):
    def __init__(self, cin: int, cfg: FastPitchConfig, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv1d(cin, cfg.predictor_filters, cfg.predictor_kernel,
                           dtype=dtype)
        self.norm = LayerNorm(cfg.predictor_filters, 1e-5, dtype)


class Predictor(nn.Module):
    """The reference's ``TemporalPredictor``: masked input, (conv, ReLU,
    LayerNorm, dropout) x ``predictor_layers``, an fp32 linear head, masked
    output (B, T) fp32."""

    def __init__(self, cfg: FastPitchConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            _ConvReLUNorm(cfg.d_model if i == 0 else cfg.predictor_filters,
                          cfg, dtype)
            for i in range(cfg.predictor_layers))
        self.fc = Dense(cfg.predictor_filters, 1, acc_dtype(dtype))
        self.drop = RegenDropout(cfg.predictor_dropout)

    def forward(self, x, mask, generator=None):
        x = x * mask[:, :, None].to(x.dtype)
        for layer in self.layers:
            x = layer.norm(torch.relu(_conv_btc(layer.conv, x)))
            x = self.drop(x, generator)
        out = self.fc(x.to(self.fc.dtype))[..., 0]
        return out * mask.to(out.dtype)


class FastPitch(nn.Module):
    """``forward`` (training, ground-truth durations and pitch) and
    ``infer`` of JAX's ``FastPitch``. A forward with a generator runs
    dropout (JAX ``deterministic=False``)."""

    def __init__(self, cfg: FastPitchConfig = FastPitchConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.encoder = _FFTransformer(cfg, dtype, cfg.encoder_layers, True)
        self.decoder = _FFTransformer(cfg, dtype, cfg.decoder_layers, False)
        self.duration_predictor = Predictor(cfg, dtype)
        self.pitch_predictor = Predictor(cfg, dtype)
        self.pitch_emb = Conv1d(1, cfg.d_model, cfg.pitch_kernel, dtype=dtype)
        if cfg.energy:
            self.energy_predictor = Predictor(cfg, dtype)
            self.energy_emb = Conv1d(1, cfg.d_model, cfg.energy_kernel,
                                     dtype=dtype)
        self.proj = Dense(cfg.d_model, cfg.n_mels, acc_dtype(dtype))
        self.register_buffer("pos", torch.from_numpy(
            _positional(max(cfg.max_mel_len, 2048), cfg.d_model)),
            persistent=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero biases, unit
        LayerNorms, the embedding N(0, 0.02)."""
        for m in self.modules():
            if isinstance(m, (Conv1d, Dense)):
                m.init_(generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        emb = self.encoder.word_emb.weight
        emb.copy_(torch.randn(emb.shape, generator=generator) * 0.02)

    def _fft(self, stack: _FFTransformer, x, mask, generator):
        x = x + self.pos[None, :x.shape[1]].to(x.dtype) * mask[:, :, None].to(x.dtype)
        for blk in stack.layers:
            seed = None if generator is None else attention_seed(generator)
            x = blk(x, mask, generator, seed)
        return x

    def _encode(self, text, text_mask, generator):
        emb = F.embedding(text, self.encoder.word_emb.weight).to(self.dtype)
        return self._fft(self.encoder, emb, text_mask, generator)

    def _embed(self, conv: Conv1d, values):
        return _conv_btc(conv, values[:, :, None].to(self.dtype))

    def _decode(self, x, durations, max_mel_len, generator):
        y, mel_mask = length_regulate(x, durations, max_mel_len)
        y = self._fft(self.decoder, y, mel_mask.to(torch.int32), generator)
        return self.proj(y.to(self.proj.dtype)), mel_mask

    def forward(self, text, durations, pitch, energy=None, max_mel_len=None,
                generator: torch.Generator | None = None):
        """(mel (B, L, n_mels) fp32, log_dur_pred, pitch_pred, energy_pred or
        None, mel_mask (B, L) bool)."""
        cfg = self.cfg
        max_mel_len = max_mel_len or cfg.max_mel_len
        text_mask = (text != 0).to(torch.int32)
        x = self._encode(text, text_mask, generator)
        log_dur_pred = self.duration_predictor(x, text_mask, generator)
        pitch_pred = self.pitch_predictor(x, text_mask, generator)
        x = x + self._embed(self.pitch_emb, pitch)
        energy_pred = None
        if cfg.energy:
            # predicted from the PITCH-CONDITIONED encoder output
            energy_pred = self.energy_predictor(x, text_mask, generator)
            e = energy_pred if energy is None else energy
            x = x + self._embed(self.energy_emb, e)
        mel, mel_mask = self._decode(x, durations, max_mel_len, generator)
        return mel, log_dur_pred, pitch_pred, energy_pred, mel_mask

    @torch.no_grad()
    def infer(self, text, pace: float = 1.0, max_mel_len=None,
              max_duration: float = 75.0):
        """(mel (B, max_mel_len, n_mels) fp32, mel_len (B,) int32): durations
        from the predictor, rounded half to even, and ``mel_len`` saturated
        at ``max_mel_len``."""
        cfg = self.cfg
        max_mel_len = max_mel_len or cfg.max_mel_len
        text_mask = (text != 0).to(torch.int32)
        x = self._encode(text, text_mask, None)
        log_dur = self.duration_predictor(x, text_mask)
        dur = (torch.exp(log_dur) - 1.0).clamp(0.0, max_duration)
        dur = torch.round(dur / pace).to(torch.int32) * text_mask
        x = x + self._embed(self.pitch_emb,
                            self.pitch_predictor(x, text_mask))
        if cfg.energy:
            x = x + self._embed(self.energy_emb,
                                self.energy_predictor(x, text_mask))
        mel, _ = self._decode(x, dur, max_mel_len, None)
        mel_len = dur.sum(1).clamp_max(max_mel_len).to(torch.int32)
        return mel, mel_len


@dataclass
class FastPitchTask:
    """A batch holds ``text`` (B, T) int32 (0 = pad), ``durations`` (B, T)
    int32, ``pitch`` (B, T) fp32 and ``mel`` (B, L, n_mels) fp32, on the
    model's device."""

    cfg: FastPitchConfig = FastPitchConfig()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> FastPitch:
        model = FastPitch(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """The masked mel MSE, plus 0.1 x the log-duration, pitch and energy
        MSEs over the text; the energy target is the mel frames' L2 norm
        averaged over the durations."""
        cfg = self.cfg
        energy_tgt = None
        if cfg.energy:
            frame_energy = torch.linalg.vector_norm(batch["mel"].float(), dim=-1)
            energy_tgt = average_over_durations(frame_energy,
                                                batch["durations"])
        mel, log_dur, pitch_pred, energy_pred, mel_mask = model(
            batch["text"], batch["durations"], batch["pitch"],
            energy=energy_tgt, max_mel_len=batch["mel"].shape[1],
            generator=generator)
        # the masked means over the global batch (``data_mean``)
        m = mel_mask[:, :, None].float()
        mel_loss = data_mean((((mel - batch["mel"]) ** 2) * m).sum(),
                             m.sum()) / cfg.n_mels
        tmask = (batch["text"] != 0).float()
        tcount = tmask.sum()
        target_dur = torch.log1p(batch["durations"].float())
        dur_loss = data_mean((((log_dur - target_dur) ** 2) * tmask).sum(),
                             tcount)
        pitch_loss = data_mean(
            (((pitch_pred - batch["pitch"]) ** 2) * tmask).sum(), tcount)
        loss = mel_loss + 0.1 * dur_loss + 0.1 * pitch_loss
        metrics = {"mel_loss": mel_loss.detach(), "dur_loss": dur_loss.detach()}
        if cfg.energy:
            energy_loss = data_mean(
                (((energy_pred - energy_tgt) ** 2) * tmask).sum(), tcount)
            loss = loss + 0.1 * energy_loss
            metrics["energy_loss"] = energy_loss.detach()
        return loss, (model_state, metrics)
