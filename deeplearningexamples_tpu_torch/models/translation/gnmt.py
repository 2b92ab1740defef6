"""GNMT v2: LSTM seq2seq with normalised Bahdanau attention, in PyTorch.

Port of ``deeplearningexamples_tpu/models/translation/gnmt.py`` (reference
``PyTorch/Translation/GNMT/seq2seq/models/``), with the reference's
``state_dict`` names (``encoder.embedder``, ``encoder.rnn_layers.{i}``,
``decoder.att_rnn.rnn``, ``decoder.att_rnn.attn.linear_q`` ...,
``decoder.classifier.classifier``), so ``utils/torch_import.convert_gnmt``
in the JAX package maps a port ``state_dict`` into the JAX tree:

- encoder: the shared embedding, a bidirectional layer 0 (H per direction),
  layer 1 from 2H to H, residuals from the third layer on, dropout on the
  input of every LSTM (the residual taken before it); the output is zeroed
  at the source's pads;
- decoder, without input feeding: layer 0 over the embedded target, the
  attention from its outputs over every step at once, then each later layer
  on ``[x, attn]`` with residuals from the third; an fp32 classifier over
  ``padded_vocab`` columns.

Each LSTM layer runs the whole sequence in one ``torch.lstm`` call (cuDNN on
the card) with ``nn.LSTM``'s names (``weight_ih_l0`` ..., ``_l0_reverse``
for the reverse direction) and flax ``OptimizedLSTMCell``'s one bias:
``bias_hh`` is trained and ``bias_ih`` is a buffer of zeros, as in
``models/tts/layers.LSTMCell``. The reverse direction is flax's
``nn.RNN(reverse=True, keep_order=True)`` with ``seq_lengths``: each row's
first ``length`` steps are reversed (the pads stay behind them), run
forward and flipped back. Every weight is drawn from U(-0.1, 0.1), the
reference's ``init_weight``; LSTM biases start at 0.

Dropout bits come from ``torch.Generator`` and cannot match ``jax.random``
(``ops/dropout.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import _VF, nn

from ...ops.dropout import RegenDropout
from ..convnets.layers import Dense
from ..tts.layers import LSTMLayer, acc_dtype
from .transformer import label_smoothed_loss

__all__ = ["BahdanauAttention", "Gnmt", "GnmtConfig", "GnmtTask", "LSTM",
           "flip_sequences"]


@dataclass(frozen=True)
class GnmtConfig:
    """The JAX ``GnmtConfig``'s fields and defaults."""

    vocab_size: int = 32320
    hidden_size: int = 1024
    num_layers: int = 4
    dropout: float = 0.2
    pad_id: int = 0
    bos_id: int = 2
    eos_id: int = 3
    label_smoothing: float = 0.1

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


@torch.no_grad()
def _u01_(t: torch.Tensor, generator: torch.Generator) -> None:
    """U(-0.1, 0.1), the reference's ``init_weight``."""
    t.copy_(torch.rand(t.shape, generator=generator) * 0.2 - 0.1)


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax's ``flip_sequences`` on (B, T, C): each row's first ``length``
    steps reversed, the rest reversed behind them."""
    t = x.shape[1]
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :]
           + lengths[:, None]) % t
    return x.gather(1, idx[:, :, None].expand_as(x))


class LSTM(LSTMLayer):
    """One LSTM layer over (B, T, C), forward, or both directions
    concatenated (B, T, 2H) with the reverse one over each row's length."""

    def __init__(self, cin: int, hidden: int, dtype: torch.dtype,
                 bidirectional: bool = False):
        super().__init__(cin, hidden, dtype,
                         ("_l0", "_l0_reverse") if bidirectional else ("_l0",))

    def _run(self, suffix: str, x: torch.Tensor) -> torch.Tensor:
        h0 = x.new_zeros(1, x.shape[0], self.hidden, dtype=self.dtype)
        return _VF.lstm(x.to(self.dtype), (h0, h0), self.weights(suffix),
                        True, 1, 0.0, self.training, False, True)[0]

    def forward(self, x: torch.Tensor,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
        out = self._run("_l0", x)
        if len(self.suffixes) == 1:
            return out
        back = flip_sequences(self._run("_l0_reverse",
                                        flip_sequences(x, lengths)), lengths)
        return torch.cat([out, back], -1)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        for s in self.suffixes:
            _u01_(getattr(self, f"weight_ih{s}"), generator)
            _u01_(getattr(self, f"weight_hh{s}"), generator)
            getattr(self, f"bias_hh{s}").zero_()


class BahdanauAttention(nn.Module):
    """Normalised Bahdanau attention over every query step at once (the
    reference's ``normalize=True``): ``v / |v| * g`` scores ``tanh(q + k +
    b)``, masked keys at -1e9, the softmax in fp32."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear_q = Dense(hidden, hidden, dtype, bias=False)
        self.linear_k = Dense(hidden, hidden, dtype, bias=False)
        self.linear_att = nn.Parameter(torch.empty(hidden))
        self.normalize_scalar = nn.Parameter(
            torch.full((1,), 1.0 / hidden**0.5))
        self.normalize_bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, queries, keys, mask):
        """queries (B, T, H), keys (B, S, H), mask (B, S) -> (context (B, T,
        H), weights (B, T, S))."""
        dt = self.dtype
        q, k = self.linear_q(queries), self.linear_k(keys)
        v = self.linear_att
        v_norm = v / torch.linalg.vector_norm(v) * self.normalize_scalar[0]
        sum_qk = q[:, :, None, :] + k[:, None, :, :] + self.normalize_bias.to(dt)
        scores = torch.einsum("btsh,h->bts", torch.tanh(sum_qk), v_norm.to(dt))
        scores = torch.where(mask[:, None, :] > 0, scores, -1e9)
        w = torch.softmax(scores.to(acc_dtype(dt)), -1).to(dt)
        return torch.einsum("bts,bsh->bth", w, keys.to(dt)), w

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        _u01_(self.linear_q.weight, generator)
        _u01_(self.linear_k.weight, generator)
        _u01_(self.linear_att, generator)
        self.normalize_scalar.fill_(1.0 / self.linear_att.shape[0] ** 0.5)
        self.normalize_bias.zero_()


class Gnmt(nn.Module):
    """``encode``, ``decode`` and ``forward`` of JAX's ``Gnmt``; logits are
    fp32 (B, T, padded_vocab)."""

    def __init__(self, cfg: GnmtConfig = GnmtConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        h, n = cfg.hidden_size, cfg.num_layers
        # the reference's module prefixes
        self.encoder = nn.Module()
        self.encoder.embedder = nn.Embedding(cfg.padded_vocab, h)
        self.encoder.rnn_layers = nn.ModuleList(
            [LSTM(h, h, dtype, bidirectional=True), LSTM(2 * h, h, dtype)]
            + [LSTM(h, h, dtype) for _ in range(2, n)])
        self.decoder = nn.Module()
        self.decoder.att_rnn = nn.Module()
        self.decoder.att_rnn.rnn = LSTM(h, h, dtype)
        self.decoder.att_rnn.attn = BahdanauAttention(h, dtype)
        self.decoder.rnn_layers = nn.ModuleList(
            LSTM(2 * h, h, dtype) for _ in range(1, n))
        self.decoder.classifier = nn.Module()
        self.decoder.classifier.classifier = Dense(h, cfg.padded_vocab,
                                                   acc_dtype(dtype))
        self.drop = RegenDropout(cfg.dropout)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        _u01_(self.encoder.embedder.weight, generator)
        for rnn in [*self.encoder.rnn_layers, self.decoder.att_rnn.rnn,
                    *self.decoder.rnn_layers]:
            rnn.init_(generator)
        self.decoder.att_rnn.attn.init_(generator)
        cls = self.decoder.classifier.classifier
        _u01_(cls.weight, generator)
        _u01_(cls.bias, generator)

    def _embed(self, ids):
        return F.embedding(ids, self.encoder.embedder.weight).to(self.dtype)

    def encode(self, src_ids, generator=None):
        """(memory (B, S, H), key mask (B, S) int32), the memory 0 at pads."""
        mask = (src_ids != self.cfg.pad_id).to(torch.int32)
        lengths = mask.sum(1)
        layers = self.encoder.rnn_layers
        x = self.drop(self._embed(src_ids), generator)
        x = layers[0](x, lengths)
        x = layers[1](self.drop(x, generator))
        for rnn in layers[2:]:
            x = rnn(self.drop(x, generator)) + x
        return x * mask[:, :, None].to(x.dtype), mask

    def decode(self, tgt_in, memory, mask, generator=None):
        dec = self.decoder
        x = dec.att_rnn.rnn(self.drop(self._embed(tgt_in), generator))
        attn, _ = dec.att_rnn.attn(x, memory, mask)
        layers = dec.rnn_layers
        x = layers[0](self.drop(torch.cat([x, attn], -1), generator))
        for rnn in layers[1:]:
            x = rnn(self.drop(torch.cat([x, attn], -1), generator)) + x
        cls = dec.classifier.classifier
        return cls(x.to(cls.dtype))

    def forward(self, src_ids, tgt_in, generator=None):
        memory, mask = self.encode(src_ids, generator)
        return self.decode(tgt_in, memory, mask, generator)


@dataclass
class GnmtTask:
    cfg: GnmtConfig = GnmtConfig()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Gnmt:
        model = Gnmt(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """Label-smoothed CE over the non-pad targets, teacher-forced."""
        tgt = batch["tgt"]
        logits = model(batch["src"], tgt[:, :-1], generator)
        loss = label_smoothed_loss(logits, tgt[:, 1:], self.cfg.pad_id,
                                   self.cfg.label_smoothing)
        return loss, (model_state, {})
