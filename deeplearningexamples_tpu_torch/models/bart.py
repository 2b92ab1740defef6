"""BART: denoising seq2seq pretraining and summarization fine-tuning, in
PyTorch.

Port of ``deeplearningexamples_tpu/models/bart.py`` (reference
``PyTorch/LanguageModeling/BART``, the HF ``modeling_bart.py`` it vendors),
with the reference's ``state_dict`` names (``model.shared``,
``model.encoder.embed_positions``, ``model.encoder.layernorm_embedding``,
``model.decoder.layers.{i}.encoder_attn.q_proj`` ...), so
``utils/torch_import.convert_bart`` in the JAX package maps a port
``state_dict`` into the JAX tree. Learned positions at index + 2,
``layernorm_embedding`` after embed + position, post-LN layers with
exact-erf GELU and the shared ``MHA`` with biases, a decoder that is causal
and masked by the target's pads, and the tied head's fp32 logits.
``BartModel`` is a ``Seq2Seq`` as the ``Transformer`` is (``encode`` /
``decode`` / ``decode_step`` / ``init_cache``), so both beam searches and the
summarization pipeline drive it unchanged.

The noising functions (``bart_text_infilling``, ``bart_sentence_permute``)
are numpy copies of JAX's and draw the same numbers from one
``np.random.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import RegenDropout
from .bert.modeling import LayerNorm
from .convnets.layers import Dense
from .translation.transformer import (
    MHA,
    Cache,
    Seq2Seq,
    TransformerConfig,
    label_smoothed_loss,
    tied_logits,
)

__all__ = ["BartBlock", "BartConfig", "BartModel", "BartTask",
           "bart_sentence_permute", "bart_text_infilling"]


@dataclass(frozen=True)
class BartConfig:
    """bart-large defaults, the JAX ``BartConfig``'s fields but for its
    ``pre_ln`` and ``scale_embedding``, which are off there and absent here:
    post-LN, unscaled embeddings, learned positions, GELU."""

    vocab_size: int = 50265
    d_model: int = 1024
    d_ff: int = 4096
    num_heads: int = 16
    encoder_layers: int = 12
    decoder_layers: int = 12
    dropout: float = 0.1
    max_len: int = 1024
    label_smoothing: float = 0.1
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    @classmethod
    def from_transformer(cls, t: TransformerConfig) -> "BartConfig":
        return cls(vocab_size=t.vocab_size, d_model=t.d_model, d_ff=t.d_ff,
                   num_heads=t.num_heads, encoder_layers=t.encoder_layers,
                   decoder_layers=t.decoder_layers, dropout=t.dropout,
                   max_len=t.max_len, label_smoothing=t.label_smoothing,
                   pad_id=t.pad_id, bos_id=t.bos_id, eos_id=t.eos_id)


class BartBlock(nn.Module):
    """``BartEncoderLayer`` / ``BartDecoderLayer``: post-LN, GELU FFN,
    dropout on the FFN's output (the ``MHA``s drop their own)."""

    def __init__(self, cfg: BartConfig, causal: bool, cross: bool,
                 dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.cross = cross
        self.self_attn = MHA(cfg, causal, True, dtype)
        self.self_attn_layer_norm = LayerNorm(d, 1e-5, dtype)
        if cross:
            self.encoder_attn = MHA(cfg, False, True, dtype)
            self.encoder_attn_layer_norm = LayerNorm(d, 1e-5, dtype)
        self.fc1 = Dense(d, cfg.d_ff, dtype)
        self.fc2 = Dense(cfg.d_ff, d, dtype)
        self.final_layer_norm = LayerNorm(d, 1e-5, dtype)
        self.dropout = RegenDropout(cfg.dropout)

    def _ff(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))

    def forward(self, x, x_mask, memory, memory_mask, generator=None,
                cache=None, pos: int = 0):
        x = self.self_attn_layer_norm(
            x + self.self_attn(x, x, x_mask, generator, cache, pos))
        if self.cross:
            c = self.encoder_attn(x, memory, memory_mask, generator)
            x = self.encoder_attn_layer_norm(x + c)
        return self.final_layer_norm(x + self.dropout(self._ff(x), generator))

    def init_(self, generator: torch.Generator) -> None:
        self.self_attn.init_(generator)
        if self.cross:
            self.encoder_attn.init_(generator)
        self.fc1.init_(generator)
        self.fc2.init_(generator)


class _Side(nn.Module):
    """``model.encoder`` / ``model.decoder``: positions, their LayerNorm and
    the layers."""

    def __init__(self, cfg: BartConfig, causal: bool, dtype: torch.dtype):
        super().__init__()
        self.embed_positions = nn.Embedding(cfg.max_len + BartModel.POS_OFFSET,
                                            cfg.d_model)
        self.layernorm_embedding = LayerNorm(cfg.d_model, 1e-5, dtype)
        self.layers = nn.ModuleList(
            BartBlock(cfg, causal, causal, dtype)
            for _ in range(cfg.decoder_layers if causal else cfg.encoder_layers))


class _Model(nn.Module):
    def __init__(self, cfg: BartConfig, dtype: torch.dtype):
        super().__init__()
        self.shared = nn.Embedding(cfg.padded_vocab, cfg.d_model)
        self.encoder = _Side(cfg, False, dtype)
        self.decoder = _Side(cfg, True, dtype)


class BartModel(Seq2Seq):
    """JAX's ``BartModel``; logits are fp32 (B, T, padded_vocab)."""

    # positions are looked up at index + 2 (BartLearnedPositionalEmbedding)
    POS_OFFSET = 2

    def __init__(self, cfg: BartConfig = BartConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.model = _Model(cfg, dtype)
        self.dropout = RegenDropout(cfg.dropout)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """JAX's initialisers, drawn on the CPU from ``generator``: the
        token and position tables N(0, 0.02), lecun-normal kernels, zero
        biases, LayerNorms at 1 and 0."""
        m = self.model
        for t in (m.shared.weight, m.encoder.embed_positions.weight,
                  m.decoder.embed_positions.weight):
            t.copy_(torch.randn(t.shape, generator=generator) * 0.02)
        for layer in [*m.encoder.layers, *m.decoder.layers]:
            layer.init_(generator)

    @property
    def table(self) -> torch.Tensor:
        return self.model.shared.weight

    def _tokens(self, ids):
        """Unscaled token embeddings (bart-large's ``scale_embedding`` is
        off)."""
        return F.embedding(ids, self.table).to(self.dtype)

    def _embed(self, ids, side: _Side, generator):
        pos = torch.arange(ids.shape[1], device=ids.device) + self.POS_OFFSET
        x = self._tokens(ids) + side.embed_positions.weight[pos].to(self.dtype)
        return self.dropout(side.layernorm_embedding(x), generator)

    def encode(self, src_ids, generator=None):
        """(memory (B, S, d), key mask (B, S) int32)."""
        enc = self.model.encoder
        mask = (src_ids != self.cfg.pad_id).to(torch.int32)
        x = self._embed(src_ids, enc, generator)
        for layer in enc.layers:
            x = layer(x, mask, None, None, generator)
        return x, mask

    def decode(self, tgt_ids, memory, memory_mask, generator=None):
        """Causal self-attention masked by the target's pads, then the tied
        head (``final_logits_bias`` is a zeros buffer upstream)."""
        dec = self.model.decoder
        x = self._embed(tgt_ids, dec, generator)
        tgt_mask = (tgt_ids != self.cfg.pad_id).to(torch.int32)
        for layer in dec.layers:
            x = layer(x, tgt_mask, memory, memory_mask, generator)
        return tied_logits(x, self.table, self.dtype)

    def decode_step(self, token, pos: int, memory, memory_mask,
                    cache: Cache) -> torch.Tensor:
        """One token (B,) at position ``pos`` -> logits (B, V), fp32."""
        dec = self.model.decoder
        x = self._tokens(token[:, None])
        x = x + dec.embed_positions.weight[pos + self.POS_OFFSET].to(self.dtype)
        x = dec.layernorm_embedding(x)
        for i, layer in enumerate(dec.layers):
            x = layer(x, None, memory, memory_mask, None,
                      (cache[f"{i}.k"], cache[f"{i}.v"]), pos)
        return tied_logits(x, self.table, self.dtype)[:, 0]



def bart_text_infilling(
    tokens: np.ndarray,  # (T,) one document's token ids
    mask_token: int,
    rng: np.random.Generator,
    mask_ratio: float = 0.3,
    poisson_lam: float = 3.0,
) -> np.ndarray:
    """Copy of JAX's ``bart_text_infilling``: about ``mask_ratio`` of the
    tokens replaced by single mask tokens over Poisson-length spans (a
    length-0 span inserts a mask)."""
    out = []
    i = 0
    n = len(tokens)
    budget = int(mask_ratio * n)
    masked = 0
    while i < n:
        if masked < budget and rng.random() < mask_ratio:
            span = int(rng.poisson(poisson_lam))
            out.append(mask_token)
            i += span  # span tokens collapse into ONE mask (possibly 0)
            masked += span
        else:
            out.append(tokens[i])
            i += 1
    return np.asarray(out, tokens.dtype)


def bart_sentence_permute(
    tokens: np.ndarray, sep_token: int, rng: np.random.Generator
) -> np.ndarray:
    """Copy of JAX's ``bart_sentence_permute``: the sentences (split after
    each ``sep_token``) shuffled."""
    idx = np.where(tokens == sep_token)[0]
    pieces = np.split(tokens, idx + 1)
    pieces = [p for p in pieces if len(p)]
    order = rng.permutation(len(pieces))
    return np.concatenate([pieces[i] for i in order])


@dataclass
class BartTask:
    """Denoising pretraining / summarization over ``BartModel``. Takes a
    ``BartConfig`` or a ``TransformerConfig`` (the CLI's), as JAX's."""

    cfg: Any = None
    dtype: torch.dtype = torch.bfloat16
    mask_token: int = 3
    mask_ratio: float = 0.3

    def __post_init__(self):
        if self.cfg is None:
            self.cfg = BartConfig()
        elif isinstance(self.cfg, TransformerConfig):
            self.cfg = BartConfig.from_transformer(self.cfg)

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> BartModel:
        model = BartModel(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def make_denoising_batch(self, docs: list[np.ndarray], seq_len: int,
                             rng: np.random.Generator) -> dict:
        """Numpy batch: src the infilled documents, tgt BOS + the clean
        document + EOS, both padded."""
        cfg = self.cfg
        src = np.full((len(docs), seq_len), cfg.pad_id, np.int32)
        tgt = np.full((len(docs), seq_len + 2), cfg.pad_id, np.int32)
        for i, doc in enumerate(docs):
            corrupted = bart_text_infilling(doc, self.mask_token, rng,
                                            self.mask_ratio)
            src[i, : min(len(corrupted), seq_len)] = corrupted[:seq_len]
            clean = doc[: seq_len]
            tgt[i, 0] = cfg.bos_id
            tgt[i, 1 : 1 + len(clean)] = clean
            tgt[i, 1 + len(clean)] = cfg.eos_id
        return {"src": src, "tgt": tgt}

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """The label-smoothed CE of ``TransformerTask``."""
        tgt = batch["tgt"]
        logits = model(batch["src"], tgt[:, :-1], generator)
        loss = label_smoothed_loss(logits, tgt[:, 1:], self.cfg.pad_id,
                                   self.cfg.label_smoothing)
        return loss, (model_state, {})
