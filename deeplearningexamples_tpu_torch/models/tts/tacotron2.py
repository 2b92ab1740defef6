"""Tacotron2: attention-based mel-spectrogram synthesis.

Port of ``deeplearningexamples_tpu/models/tts/tacotron2.py`` (reference
``PyTorch/SpeechSynthesis/Tacotron2/tacotron2/model.py``): text embedding,
3-conv + BiLSTM encoder, an autoregressive decoder (Prenet,
location-sensitive attention, two LSTM cells), teacher-forced ``forward``
and gated ``infer``, the 5-conv Postnet and the masked outputs. The modules
carry the reference's ``state_dict`` names (the ones the JAX package's
``utils/torch_import.convert_tacotron2`` reads).

JAX runs the decoder as ``flax.linen.scan`` over the frames; here it is a
Python loop over the decoder cell, about 35 small ops a frame, so at the
batch sizes of training the host, not the card, sets the pace. Only the
Prenet of the teacher-forced frames (which no frame's output feeds) runs
for all frames at once, as in the reference.

Semantics kept from JAX, and through it from the reference:

- the Prenet's dropout (``cfg.dropout``) is always on, in ``infer`` too, and
  so are the attention and decoder dropouts (JAX passes
  ``deterministic=False``); the Encoder's and Postnet's dropouts are 0.5,
  hard-coded, on in a training forward only;
- the encoder convolutions read the pad-symbol embeddings and the Postnet
  the unmasked decoder output, so both BNs' batch statistics span every
  position; the BiLSTM respects the lengths (each row's valid prefix runs
  backwards, as ``pack_padded_sequence`` does), and padded positions of the
  memory are 0;
- masked energies are -1e9, the softmax runs in fp32, the cumulative
  weights add the new weights after it, and the context is cast to the
  compute dtype;
- ``infer`` runs all ``max_steps`` frames: once a row's gate fires its
  length freezes but it keeps decoding, the Postnet reads the frames after
  the finish, and only then are they zeroed.

Interfaces are (B, T, C) as in JAX; the convolutions run NCW.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import _VF, nn
from torch.nn.utils.rnn import (
    PackedSequence,
    pack_padded_sequence,
    pad_packed_sequence,
)

from .layers import (
    BatchNorm1d,
    ConvNorm,
    Dropout,
    LinearNorm,
    LSTMCell,
    LSTMLayer,
    acc_dtype,
    device_generator,
    init_lstm_,
)

__all__ = ["Tacotron2", "Tacotron2Config", "tacotron2_loss"]


@dataclass(frozen=True)
class Tacotron2Config:
    n_symbols: int = 148
    symbols_embedding_dim: int = 512
    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512
    n_mel_channels: int = 80
    attention_rnn_dim: int = 1024
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 2000
    gate_threshold: float = 0.5
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    dropout: float = 0.5


def _conv_bn(cin: int, cout: int, k: int, dtype) -> nn.Sequential:
    """The reference's ``convolutions.{i}``: ``0.conv`` and the BN ``1``."""
    return nn.Sequential(ConvNorm(cin, cout, k, dtype=dtype), BatchNorm1d(cout))


class BiLSTM(LSTMLayer):
    """The encoder's bidirectional LSTM with ``nn.LSTM``'s names (``_l0`` and
    ``_l0_reverse``) and ``LSTMCell``'s one trained bias per direction,
    over packed sequences (cuDNN on the card)."""

    def __init__(self, cin: int, hidden: int, dtype: torch.dtype):
        super().__init__(cin, hidden, dtype, ("_l0", "_l0_reverse"))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x (B, T, C), lengths (B,) -> (B, T, 2 * hidden), 0 past each
        length."""
        b, t, _ = x.shape
        packed = pack_padded_sequence(x.to(self.dtype), lengths.cpu(),
                                      batch_first=True, enforce_sorted=False)
        weights = [w for s in self.suffixes for w in self.weights(s)]
        h0 = x.new_zeros(2, b, self.hidden, dtype=self.dtype)
        out = _VF.lstm(packed.data, packed.batch_sizes, (h0, h0), weights,
                       True, 1, 0.0, self.training, True)[0]
        out, _ = pad_packed_sequence(
            PackedSequence(out, packed.batch_sizes, packed.sorted_indices,
                           packed.unsorted_indices),
            batch_first=True, total_length=t)
        return out

    def init_(self, generator: torch.Generator) -> None:
        for s in self.suffixes:
            init_lstm_(*(getattr(self, f"{n}{s}") for n in
                         ("weight_ih", "weight_hh", "bias_hh", "bias_ih")),
                       generator)


class Encoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config, dtype: torch.dtype):
        super().__init__()
        e = cfg.encoder_embedding_dim
        self.convolutions = nn.ModuleList(
            _conv_bn(cfg.symbols_embedding_dim if i == 0 else e, e,
                     cfg.encoder_kernel_size, dtype)
            for i in range(cfg.encoder_n_convolutions))
        self.lstm = BiLSTM(e, e // 2, dtype)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                deterministic: bool, generator) -> torch.Tensor:
        """Embeddings (B, T, E) -> memory (B, T, E)."""
        x = x.transpose(1, 2)
        for conv, bn in self.convolutions:
            x = self.dropout(F.relu(bn(conv(x), deterministic)), generator,
                             deterministic)
        return self.lstm(x.transpose(1, 2), lengths)


class Prenet(nn.Module):
    """Two ReLU layers without bias, their dropout always on."""

    def __init__(self, cfg: Tacotron2Config, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            LinearNorm(cfg.n_mel_channels if i == 0 else cfg.prenet_dim,
                       cfg.prenet_dim, bias=False, dtype=dtype)
            for i in range(2))
        self.dropout = Dropout(cfg.dropout, always=True)

    def forward(self, x, generator):
        for layer in self.layers:
            x = self.dropout(F.relu(layer(x)), generator)
        return x


class LocationLayer(nn.Module):
    def __init__(self, cfg: Tacotron2Config, dtype: torch.dtype):
        super().__init__()
        self.location_conv = ConvNorm(
            2, cfg.attention_location_n_filters,
            cfg.attention_location_kernel_size, bias=False, dtype=dtype)
        self.location_dense = LinearNorm(cfg.attention_location_n_filters,
                                         cfg.attention_dim, bias=False,
                                         dtype=dtype)


class Attention(nn.Module):
    """Location-sensitive attention's layers (reference ``Attention``)."""

    def __init__(self, cfg: Tacotron2Config, dtype: torch.dtype):
        super().__init__()
        a = cfg.attention_dim
        self.query_layer = LinearNorm(cfg.attention_rnn_dim, a, bias=False,
                                      dtype=dtype)
        self.memory_layer = LinearNorm(cfg.encoder_embedding_dim, a,
                                       bias=False, dtype=dtype)
        self.v = LinearNorm(a, 1, bias=False, dtype=dtype)
        self.location_layer = LocationLayer(cfg, dtype)


class Decoder(nn.Module):
    """The decoder's layers and one autoregressive step (``step``)."""

    def __init__(self, cfg: Tacotron2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        e = cfg.encoder_embedding_dim
        self.prenet = Prenet(cfg, dtype)
        self.attention_rnn = LSTMCell(cfg.prenet_dim + e,
                                      cfg.attention_rnn_dim, dtype)
        self.attention_layer = Attention(cfg, dtype)
        self.decoder_rnn = LSTMCell(cfg.attention_rnn_dim + e,
                                    cfg.decoder_rnn_dim, dtype)
        self.linear_projection = LinearNorm(cfg.decoder_rnn_dim + e,
                                            cfg.n_mel_channels, dtype=dtype)
        self.gate_layer = LinearNorm(cfg.decoder_rnn_dim + e, 1, dtype=dtype)
        self.attention_dropout = Dropout(cfg.p_attention_dropout, always=True)
        self.decoder_dropout = Dropout(cfg.p_decoder_dropout, always=True)

    def init_carry(self, b: int, t_in: int, device) -> list[torch.Tensor]:
        """(attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, context),
        zeros in the compute dtype."""
        cfg = self.cfg
        z = lambda *s: torch.zeros(*s, dtype=self.dtype, device=device)  # noqa: E731
        return [z(b, cfg.attention_rnn_dim), z(b, cfg.attention_rnn_dim),
                z(b, cfg.decoder_rnn_dim), z(b, cfg.decoder_rnn_dim),
                z(b, t_in), z(b, t_in), z(b, cfg.encoder_embedding_dim)]

    def step(self, carry, prenet_out, memory, processed_memory, mask,
             generator):
        """One frame (reference ``decode``): returns (carry, mel (B, n_mel),
        gate (B,), attention weights (B, T_in)), all in the compute dtype."""
        attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, context = carry
        att = self.attention_layer
        attn_h, attn_c = self.attention_rnn(
            torch.cat([prenet_out, context], -1), (attn_h, attn_c))
        attn_h = self.attention_dropout(attn_h, generator)

        # the span the profiling tool reads as the attention's part of a step
        with torch.profiler.record_function("attention"):
            loc = torch.stack([attn_w, attn_w_cum], 1)  # (B, 2, T_in)
            loc = att.location_layer.location_conv(loc)
            loc = att.location_layer.location_dense(loc.transpose(1, 2))
            query = att.query_layer(attn_h)
            energies = att.v(torch.tanh(query[:, None] + processed_memory
                                        + loc))[..., 0]
            energies = energies.masked_fill(~mask, -1e9)
            attn_w = torch.softmax(energies.to(acc_dtype(self.dtype)), -1).to(
                self.dtype)
            attn_w_cum = attn_w_cum + attn_w
            context = torch.bmm(attn_w[:, None].to(memory.dtype),
                                memory)[:, 0].to(self.dtype)

        dec_h, dec_c = self.decoder_rnn(
            torch.cat([attn_h, context], -1), (dec_h, dec_c))
        dec_h = self.decoder_dropout(dec_h, generator)
        proj_in = torch.cat([dec_h, context], -1)
        mel = self.linear_projection(proj_in)
        gate = self.gate_layer(proj_in)[:, 0]
        return ([attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, context],
                mel, gate, attn_w)


class Postnet(nn.Module):
    def __init__(self, cfg: Tacotron2Config, dtype: torch.dtype):
        super().__init__()
        n = cfg.postnet_n_convolutions
        self.convolutions = nn.ModuleList(
            _conv_bn(cfg.n_mel_channels if i == 0 else cfg.postnet_embedding_dim,
                     cfg.n_mel_channels if i == n - 1 else
                     cfg.postnet_embedding_dim, cfg.postnet_kernel_size, dtype)
            for i in range(n))
        self.dropout = Dropout(0.5)

    def forward(self, mel: torch.Tensor, deterministic: bool,
                generator) -> torch.Tensor:
        """mel (B, T, n_mel) -> the residual (B, T, n_mel), compute dtype."""
        x = mel.transpose(1, 2)
        n = len(self.convolutions)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = bn(conv(x), deterministic)
            if i < n - 1:
                x = torch.tanh(x)
            x = self.dropout(x, generator, deterministic)
        return x.transpose(1, 2)


class Tacotron2(nn.Module):
    """``forward`` (teacher-forced training) and ``infer``; ``dtype`` is the
    compute dtype, the parameters stay fp32 (or float64)."""

    def __init__(self, cfg: Tacotron2Config = Tacotron2Config(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embedding = nn.Embedding(cfg.n_symbols, cfg.symbols_embedding_dim)
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.postnet = Postnet(cfg, dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn from ``generator`` (a CPU generator) in
        the modules' order: the embedding ``variance_scaling(1.0, "fan_avg",
        "uniform")``, kernels lecun normal, LSTM hidden kernels orthogonal,
        biases 0, BN scales 1."""
        n, d = self.embedding.weight.shape
        lim = (3.0 / ((n + d) / 2.0)) ** 0.5
        self.embedding.weight.copy_(
            torch.rand(n, d, generator=generator) * (2 * lim) - lim)
        for m in self.modules():
            if hasattr(m, "init_") and m is not self:
                m.init_(generator)

    def _encode(self, text, text_lengths, deterministic, generator):
        emb = F.embedding(text.long(), self.embedding.weight).to(self.dtype)
        memory = self.encoder(emb, text_lengths, deterministic, generator)
        mask = torch.arange(text.shape[1], device=text.device)[None, :] \
            < text_lengths[:, None]
        return memory, mask

    def forward(self, text, text_lengths, mels, mel_lengths,
                generator: torch.Generator | None = None):
        """Teacher-forced forward, BN on batch statistics in training mode.
        mels (B, T_out, n_mel); ``generator`` (CPU) seeds the dropout masks.
        Returns (mel, mel_post, gates, alignments): fp32 (B, T_out, n_mel)
        twice, fp32 (B, T_out) with 1e3 past each length, (B, T_out, T_in)
        in the compute dtype."""
        cfg, dt = self.cfg, self.dtype
        gen = device_generator(generator, text.device)
        deterministic = not self.training
        memory, mask = self._encode(text, text_lengths, deterministic, gen)
        dec = self.decoder
        pm = dec.attention_layer.memory_layer(memory)
        b, t_out, _ = mels.shape
        frames = torch.cat([mels.new_zeros(b, 1, cfg.n_mel_channels),
                            mels[:, :-1]], 1).to(dt)
        prenet = dec.prenet(frames, gen)
        carry = dec.init_carry(b, memory.shape[1], text.device)
        outs = []
        for t in range(t_out):
            carry, mel, gate, align = dec.step(carry, prenet[:, t], memory, pm,
                                               mask, gen)
            outs.append((mel, gate, align))
        mel, gates, aligns = (torch.stack(o, 1) for o in zip(*outs))
        return self._outputs(mel, gates, aligns, mel_lengths, deterministic,
                             gen)

    def _outputs(self, mel, gates, aligns, mel_lengths, deterministic, gen):
        f32 = acc_dtype(self.dtype)
        mel = mel.to(f32)
        mel_post = mel + self.postnet(mel, deterministic, gen).to(f32)
        out_mask = torch.arange(mel.shape[1], device=mel.device)[None, :] \
            < mel_lengths[:, None]
        m = out_mask[:, :, None].to(f32)
        gates = torch.where(out_mask, gates.to(f32), 1e3)
        return mel * m, mel_post * m, gates, aligns

    @torch.no_grad()
    def infer(self, text, text_lengths, max_steps: int | None = None,
              generator: torch.Generator | None = None):
        """Autoregressive inference to a fixed budget of ``max_steps`` frames
        (``cfg.max_decoder_steps`` by default). Returns (mel_post (B, T,
        n_mel) fp32 with the frames after each row's finish zeroed, lengths
        (B,) int32, alignments (B, T, T_in))."""
        cfg, dt = self.cfg, self.dtype
        max_steps = max_steps or cfg.max_decoder_steps
        gen = device_generator(generator, text.device)
        memory, mask = self._encode(text, text_lengths, True, gen)
        # the decoder's weights in the compute dtype once, not at each frame
        dec = copy.deepcopy(self.decoder).to(dt)
        pm = dec.attention_layer.memory_layer(memory)
        b, dev = text.shape[0], text.device
        carry = dec.init_carry(b, memory.shape[1], dev)
        frame = torch.zeros(b, cfg.n_mel_channels, dtype=dt, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        length = torch.zeros(b, dtype=torch.int32, device=dev)
        mels, aligns, done = [], [], []
        for _ in range(max_steps):
            carry, mel, gate, align = dec.step(
                carry, dec.prenet(frame, gen), memory, pm, mask, gen)
            stop = torch.sigmoid(gate.float()) > cfg.gate_threshold
            length = torch.where(finished, length, length + 1)
            finished = finished | stop
            frame = mel
            mels.append(mel)
            aligns.append(align)
            done.append(finished)
        mels = torch.stack(mels, 1).to(acc_dtype(dt))
        mel_post = mels + self.postnet(mels, True, gen).to(mels.dtype)
        done = torch.stack(done, 1)
        valid = ~torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]], 1)
        return mel_post * valid[:, :, None], length, torch.stack(aligns, 1)


def tacotron2_loss(mel, mel_post, gates, target_mel, target_gate):
    """MSE(pre) + MSE(post) + BCE(gate) (reference
    ``loss_function.py:30-45``)."""
    mse = ((mel - target_mel) ** 2).mean() + ((mel_post - target_mel) ** 2).mean()
    return mse + F.binary_cross_entropy_with_logits(gates, target_gate)
