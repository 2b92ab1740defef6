"""Transformer for neural machine translation, in PyTorch.

Port of ``deeplearningexamples_tpu/models/translation/transformer.py``
(reference ``PyTorch/Translation/Transformer``: fairseq
transformer_wmt_en_de, 6+6 post-LN layers, d 512, 8 heads, sinusoidal
positions, shared source/target embeddings, label-smoothed CE 0.1). Module
and parameter names are the reference's ``state_dict`` names
(``encoder.embed_tokens``, ``encoder.layers.{i}.self_attn.in_proj_weight_q``,
``.maybe_ln1.ln``, ``decoder.layers.{i}.encoder_attn_layer_norm.ln`` ...),
so ``utils/torch_import.convert_nmt_transformer`` in the JAX package maps a
port ``state_dict`` into the JAX tree. The embedding is tied across encoder,
decoder and output projection and kept once, under ``encoder.embed_tokens``,
with ``padded_vocab`` rows.

Every attention call that JAX routes through ``flash_attention`` runs K1/K2
(``ops/flash_attention.py``) in the (B, S, H, D) layout the projections
write: the encoder's masked self-attention, the decoder's causal
self-attention (BART adds a key mask) and the masked cross-attention,
``Sq != Sk``, which ``decode_step`` runs at ``Sq = 1``. ``decode_step``'s
self-attention appends one token's K/V to a (B, max_len, d) cache and
attends over the slots up to ``pos`` in plain ops, as JAX does outside
Pallas.

Precision follows the JAX model's ``dtype``: fp32 parameters, every dense
layer and embedding sum in the compute dtype, LayerNorm statistics in fp32,
and the tied output projection gives fp32 logits from the compute-dtype
operands (JAX's ``preferred_element_type=float32``): the bf16 operands are
upcast and multiplied in fp32, so no logit is rounded to bf16. A float64
model (``dtype=torch.float64``) computes in float64 throughout.

Dropout is on when a forward is given a ``torch.Generator`` (JAX
``deterministic=False``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import RegenDropout
from ...ops.flash_attention import flash_attention
from ...parallel.mesh import data_mean
from ..bert.modeling import LayerNorm
from ..convnets.layers import Dense
from ..tts.layers import acc_dtype, lecun_normal_

__all__ = ["MHA", "Block", "Cache", "Seq2Seq", "Transformer",
           "TransformerConfig", "TransformerTask", "fairseq_position_ids",
           "label_smoothed_loss", "sinusoidal_positions", "tied_logits"]

# (B*beam, max_len, d) K and V tensors of every decoder layer's
# self-attention, by name ("{layer}.k", "{layer}.v")
Cache = dict[str, torch.Tensor]


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX ``TransformerConfig``'s fields and defaults."""

    vocab_size: int = 33712  # joint BPE vocab, padded at embed to %128
    d_model: int = 512
    d_ff: int = 2048
    num_heads: int = 8
    encoder_layers: int = 6
    decoder_layers: int = 6
    dropout: float = 0.1
    max_len: int = 256
    label_smoothing: float = 0.1
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


def sinusoidal_positions(max_len: int, d: int, pad_id: int = 1) -> np.ndarray:
    """fairseq's sinusoid table: rows are position ids (row ``pad_id``
    zeroed, real tokens from ``pad_id + 1``), [sin | cos] over ``d // 2``
    frequencies spaced by ``1 / (half - 1)`` in log space."""
    rows = max_len + pad_id + 1
    half = d // 2
    freq = np.exp(np.arange(half) * (-np.log(10000.0) / (half - 1)))
    ang = np.arange(rows)[:, None] * freq[None, :]
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    if d % 2:
        out = np.concatenate([out, np.zeros((rows, 1), np.float32)], axis=1)
    out[pad_id] = 0.0
    return out


def fairseq_position_ids(ids: torch.Tensor, pad_id: int,
                         left_pad: bool) -> torch.Tensor:
    """``fairseq.utils.make_positions``: a non-pad token gets ``pad_id + 1 +
    index``; with left padding the count starts at the first real token.
    Pads point at the zeroed row ``pad_id``."""
    seq = ids.shape[1]
    mask = ids != pad_id
    pos = torch.arange(pad_id + 1, pad_id + 1 + seq, device=ids.device)[None, :]
    if left_pad:
        pos = pos - seq + mask.sum(1, keepdim=True)
    return torch.where(mask, pos, pad_id)


class _MaybeLN(nn.Module):
    """fairseq's ``maybe_ln`` wrapper: its LayerNorm is ``.ln``."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.ln = LayerNorm(d, 1e-5, dtype)

    def forward(self, x):
        return self.ln(x)


def tied_logits(x: torch.Tensor, table: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``x @ table.T`` from operands rounded to ``dtype``, multiplied and
    summed in fp32 (float64 for float64): JAX's ``dot_general(...,
    preferred_element_type=float32)``. Runs in a ``vocab_projection``
    profiler span, which ``tools/profile_seq2seq`` reads."""
    acc = acc_dtype(dtype)
    with torch.profiler.record_function("vocab_projection"):
        return F.linear(x.to(dtype).to(acc), table.to(dtype).to(acc))


class MHA(nn.Module):
    """Multi-head attention with the reference's names: fairseq's
    ``in_proj_weight_{q,k,v}`` (applied as ``x @ W``, shape (in, out)) and a
    bias-free ``out_proj`` without ``bias``; HF BART's ``{q,k,v,out}_proj``
    with biases otherwise. Dropout at ``cfg.dropout`` on the output, as
    JAX's ``MHA`` (no attention dropout: no configuration of the port sets
    one)."""

    def __init__(self, cfg, causal: bool, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.causal, self.dtype, self.biased = causal, dtype, bias
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.d_model // cfg.num_heads
        d = cfg.d_model
        if bias:
            self.q_proj, self.k_proj, self.v_proj = (
                Dense(d, d, dtype) for _ in range(3))
        else:
            for t in "qkv":
                self.register_parameter(f"in_proj_weight_{t}",
                                        nn.Parameter(torch.empty(d, d)))
        self.out_proj = Dense(d, d, dtype, bias)
        self.dropout = RegenDropout(cfg.dropout)

    def _proj(self, x: torch.Tensor, t: str) -> torch.Tensor:
        if self.biased:
            return getattr(self, f"{t}_proj")(x)
        return x.to(self.dtype) @ getattr(self, f"in_proj_weight_{t}").to(self.dtype)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        for t in "qkv":
            if self.biased:
                getattr(self, f"{t}_proj").init_(generator)
            else:  # (in, out): fan-in is the first dim
                w = getattr(self, f"in_proj_weight_{t}")
                lecun_normal_(w, w.shape[0], generator)
        self.out_proj.init_(generator)

    def forward(self, q_in, kv_in, kv_mask, generator=None,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                pos: int = 0):
        """``cache`` (the decode path of a causal layer): one query token,
        its K/V written to slot ``pos`` of the (B, max_len, d) tensors."""
        b, sq, d = q_in.shape
        sk = kv_in.shape[1]
        h, hd = self.num_heads, self.head_dim
        q = self._proj(q_in, "q")
        k = self._proj(kv_in, "k")
        v = self._proj(kv_in, "v")
        if cache is not None:
            ck, cv = cache
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
            max_len = ck.shape[1]
            kh = ck.view(b, max_len, h, hd)
            vh = cv.view(b, max_len, h, hd)
            qh = q.view(b, 1, h, hd)
            scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
            valid = torch.arange(max_len, device=q.device) <= pos
            scores = torch.where(valid, scores, -1e9)
            w = torch.softmax(scores.to(acc_dtype(self.dtype)), -1).to(self.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(b, 1, d)
        else:
            ctx = flash_attention(
                q.view(b, sq, h, hd), k.view(b, sk, h, hd),
                v.view(b, sk, h, hd), key_mask=kv_mask, causal=self.causal,
                layout="bshd").reshape(b, sq, d)
        return self.dropout(self.out_proj(ctx), generator)


class Block(nn.Module):
    """Post-LN layer with an optional cross-attention (JAX ``Block``): the
    encoder's LayerNorms are ``maybe_ln1``/``maybe_ln2``, the decoder's
    ``self_attn_layer_norm``, ``encoder_attn_layer_norm`` and
    ``final_layer_norm``; ReLU FFN (the reference's ``relu_dropout`` is 0, and
    no configuration of the port sets another)."""

    def __init__(self, cfg: TransformerConfig, causal: bool, cross: bool,
                 dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.cross = cross
        self.self_attn = MHA(cfg, causal, False, dtype)
        if cross:
            self.self_attn_layer_norm = _MaybeLN(d, dtype)
            self.encoder_attn = MHA(cfg, False, False, dtype)
            self.encoder_attn_layer_norm = _MaybeLN(d, dtype)
            self.final_layer_norm = _MaybeLN(d, dtype)
        else:
            self.maybe_ln1 = _MaybeLN(d, dtype)
            self.maybe_ln2 = _MaybeLN(d, dtype)
        self.fc1 = Dense(d, cfg.d_ff, dtype)
        self.fc2 = Dense(cfg.d_ff, d, dtype)
        self.dropout = RegenDropout(cfg.dropout)

    def lns(self):
        """(after self-attention, after cross-attention, after the FFN)."""
        if self.cross:
            return (self.self_attn_layer_norm, self.encoder_attn_layer_norm,
                    self.final_layer_norm)
        return self.maybe_ln1, None, self.maybe_ln2

    def forward(self, x, x_mask, memory, memory_mask, generator=None,
                cache=None, pos: int = 0):
        ln1, ln_cross, ln2 = self.lns()
        x = ln1(x + self.self_attn(x, x, x_mask, generator, cache, pos))
        if self.cross:
            c = self.encoder_attn(x, memory, memory_mask, generator)
            x = ln_cross(x + c)
        y = self.dropout(self.fc2(torch.relu(self.fc1(x))), generator)
        return ln2(x + y)

    def init_(self, generator: torch.Generator) -> None:
        self.self_attn.init_(generator)
        if self.cross:
            self.encoder_attn.init_(generator)
        self.fc1.init_(generator)
        self.fc2.init_(generator)


class Seq2Seq(nn.Module):
    """What ``Transformer`` and ``BartModel`` share over their own
    ``encode`` / ``decode``: the teacher-forced forward and the decode
    path's KV cache (``cfg.max_len``, ``cfg.d_model``,
    ``cfg.decoder_layers`` and ``self.dtype``)."""

    def init_cache(self, batch: int, device) -> Cache:
        """Zeros for every decoder layer's K/V, in the compute dtype."""
        shape = (batch, self.cfg.max_len, self.cfg.d_model)
        return {f"{i}.{t}": torch.zeros(shape, dtype=self.dtype, device=device)
                for i in range(self.cfg.decoder_layers) for t in "kv"}

    def forward(self, src_ids, tgt_in, generator=None):
        memory, memory_mask = self.encode(src_ids, generator)
        return self.decode(tgt_in, memory, memory_mask, generator)


class Transformer(Seq2Seq):
    """``encode``, ``decode``, ``decode_step`` and ``forward`` of JAX's
    ``Transformer``; logits are fp32 (B, T, padded_vocab)."""

    def __init__(self, cfg: TransformerConfig = TransformerConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        # the reference's ``encoder`` / ``decoder`` prefixes
        self.encoder, self.decoder = nn.Module(), nn.Module()
        self.encoder.embed_tokens = nn.Embedding(cfg.padded_vocab, cfg.d_model)
        self.encoder.layers = nn.ModuleList(
            Block(cfg, False, False, dtype) for _ in range(cfg.encoder_layers))
        self.decoder.layers = nn.ModuleList(
            Block(cfg, True, True, dtype) for _ in range(cfg.decoder_layers))
        self.register_buffer("pos_table", torch.from_numpy(
            sinusoidal_positions(cfg.max_len, cfg.d_model, cfg.pad_id)),
            persistent=False)
        self.dropout = RegenDropout(cfg.dropout)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """JAX's initialisers, drawn on the CPU from ``generator``: the
        embedding N(0, d^-0.5) with its pad row 0, lecun-normal kernels,
        zero biases, LayerNorms at 1 and 0."""
        cfg = self.cfg
        w = self.encoder.embed_tokens.weight
        w.copy_(torch.randn(w.shape, generator=generator) * cfg.d_model**-0.5)
        w[cfg.pad_id] = 0.0
        for layer in [*self.encoder.layers, *self.decoder.layers]:
            layer.init_(generator)

    @property
    def table(self) -> torch.Tensor:
        return self.encoder.embed_tokens.weight

    def _embed(self, ids, generator, left_pad: bool):
        cfg, dt = self.cfg, self.dtype
        scale = torch.tensor(cfg.d_model**0.5, dtype=dt)
        x = F.embedding(ids, self.table).to(dt) * scale
        pos = fairseq_position_ids(ids, cfg.pad_id, left_pad)
        x = x + self.pos_table[pos].to(dt)
        return self.dropout(x, generator)

    def encode(self, src_ids, generator=None):
        """(memory (B, S, d), key mask (B, S) int32); the reference
        left-pads the source."""
        mask = (src_ids != self.cfg.pad_id).to(torch.int32)
        x = self._embed(src_ids, generator, left_pad=True)
        for layer in self.encoder.layers:
            x = layer(x, mask, None, None, generator)
        return x, mask

    def decode(self, tgt_ids, memory, memory_mask, generator=None):
        """Causal self-attention without a key mask (right-padded targets),
        then the tied projection: fp32 logits."""
        x = self._embed(tgt_ids, generator, left_pad=False)
        for layer in self.decoder.layers:
            x = layer(x, None, memory, memory_mask, generator)
        return tied_logits(x, self.table, self.dtype)

    def decode_step(self, token, pos: int, memory, memory_mask,
                    cache: Cache) -> torch.Tensor:
        """One token (B,) at position ``pos`` -> logits (B, V), fp32; writes
        slot ``pos`` of ``cache``. The position row is ``pos + pad_id + 1``."""
        cfg, dt = self.cfg, self.dtype
        x = F.embedding(token[:, None], self.table).to(dt) * torch.tensor(
            cfg.d_model**0.5, dtype=dt)
        x = x + self.pos_table[pos + cfg.pad_id + 1].to(dt)
        for i, layer in enumerate(self.decoder.layers):
            x = layer(x, None, memory, memory_mask, None,
                      (cache[f"{i}.k"], cache[f"{i}.v"]), pos)
        return tied_logits(x, self.table, dt)[:, 0]



def label_smoothed_loss(logits: torch.Tensor, tgt_out: torch.Tensor,
                        pad_id: int, smoothing: float) -> torch.Tensor:
    """``(1 - s) * nll + s * smooth`` over the non-pad targets, where
    ``smooth`` is minus the mean log-probability over every column of the
    logits, the padded vocab's included (JAX's ``loss_fn``). Under a data
    axis the mean is over the global batch's non-pad targets
    (``data_mean``)."""
    valid = (tgt_out != pad_id).to(logits.dtype)
    logp = F.log_softmax(logits, -1)
    nll = -logp.gather(-1, tgt_out.long()[..., None])[..., 0]
    smooth = -logp.mean(-1)
    ce = (1.0 - smoothing) * nll + smoothing * smooth
    return data_mean((ce * valid).sum(), valid.sum())


@dataclass
class TransformerTask:
    cfg: TransformerConfig = TransformerConfig()
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Transformer:
        """A ``Transformer`` with JAX's initialisers drawn on the CPU from
        ``generator``, then placed on ``device``, in training mode."""
        model = Transformer(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """batch: src (B, S), tgt (B, T) with BOS ... EOS; teacher forcing
        shifts inside; pads are left out of the loss."""
        tgt = batch["tgt"]
        logits = model(batch["src"], tgt[:, :-1], generator)
        loss = label_smoothed_loss(logits, tgt[:, 1:], self.cfg.pad_id,
                                   self.cfg.label_smoothing)
        return loss, (model_state, {})
