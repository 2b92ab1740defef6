"""Transformer-XL: a segment-recurrent language model, in PyTorch.

Port of ``deeplearningexamples_tpu/models/transformer_xl.py`` (reference
``PyTorch/LanguageModeling/Transformer-XL/pytorch/mem_transformer.py``) with
the reference's ``state_dict`` names, which
``utils/torch_import.convert_transformer_xl`` in the JAX package reads:
``word_emb.emb_layers.0`` (the word table, with JAX's ``padded_vocab``
rows), ``r_w_bias``, ``r_r_bias``, ``crit.out_layers_biases.0`` (the
softmax bias) and per layer ``dec_attn.qkv_net`` (q, k and v stacked),
``dec_attn.r_net``, ``dec_attn.o_net``, ``dec_attn.layer_norm``,
``pos_ff.CoreNet.0``, ``pos_ff.CoreNet.3`` and ``pos_ff.layer_norm``.

- Relative attention: the content term ``(q + u) . k`` and the position
  term ``(q + v) . r`` with the pad-and-reshape shift, over the previous
  segment's hiddens (the memory) and this one's; ``u`` and ``v`` are
  shared by every layer. The scores are fp32; the causal mask and the
  memory's unfilled leading slots (``mem_valid`` counts the filled trailing
  ones) are ``-1e9``.
- Post-LN layers (flax's epsilon 1e-6), ReLU FFN.
- The embedding is scaled by sqrt(d_model); the logits are the tied table's
  product in fp32 (an fp32 GEMM on the compute dtype's rounded operands)
  plus ``softmax_bias``, over the padded vocab (no adaptive softmax, as in
  JAX).
- The memories and ``mem_valid`` travel in the train state's
  ``model_state`` from step to step, detached; the checkpoint keeps them.
  Under a data axis each rank carries its own rows' memories, and the
  checkpoint holds them whole in the global batch's row order.

Dropout is ``ops.dropout.RegenDropout`` (its bits cannot match
``jax.random``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import RegenDropout
from ..parallel.mesh import DATA_AXIS, data_rows, mark_sharded
from .bert.modeling import LayerNorm
from .convnets.layers import Dense
from .tts.layers import acc_dtype

__all__ = ["RelAttention", "TransformerXL", "TransformerXLConfig",
           "TransformerXLTask", "XLLayer"]

LN_EPS = 1e-6  # flax's default


@dataclass(frozen=True)
class TransformerXLConfig:
    """The JAX ``TransformerXLConfig``: WT103's base model."""

    vocab_size: int = 267735
    d_model: int = 512
    n_heads: int = 8
    d_head: int = 64
    d_ff: int = 2048
    n_layers: int = 16
    seg_len: int = 192
    mem_len: int = 192
    dropout: float = 0.1

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


def _rel_shift(x):
    """(B, H, Tq, Tk) position scores, shifted (Dai et al. appendix B)."""
    b, h, q, k = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, k + 1, q)[:, :, 1:, :]
    return x.reshape(b, h, q, k)


class RelAttention(nn.Module):
    def __init__(self, cfg: TransformerXLConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        hd = cfg.n_heads * cfg.d_head
        self.qkv_net = Dense(cfg.d_model, 3 * hd, dtype, bias=False)
        self.r_net = Dense(cfg.d_model, hd, dtype, bias=False)
        self.o_net = Dense(hd, cfg.d_model, dtype, bias=False)
        self.layer_norm = LayerNorm(cfg.d_model, LN_EPS, dtype)
        self.drop = RegenDropout(cfg.dropout)

    def forward(self, x, mem, rel_pos_emb, u, w, mem_valid, generator=None):
        """x (B, T, D), mem (B, M, D) -> the attention's output (B, T, D)."""
        h, dh = self.cfg.n_heads, self.cfg.d_head
        b, t, _ = x.shape
        ctx = torch.cat([mem, x], 1)
        klen = ctx.shape[1]
        # q of the memory's rows is not used: one GEMM, as the reference's
        q, k, v = self.qkv_net(ctx).chunk(3, -1)
        qh = q[:, -t:].reshape(b, t, h, dh)
        kh = k.reshape(b, klen, h, dh)
        vh = v.reshape(b, klen, h, dh)
        rh = self.r_net(rel_pos_emb[:klen]).reshape(klen, h, dh)
        ac = torch.einsum("bthd,bkhd->bhtk", qh + u, kh)
        bd = _rel_shift(torch.einsum("bthd,khd->bhtk", qh + w, rh))
        acc = acc_dtype(self.dtype)
        scores = (ac + bd).to(acc) / math.sqrt(dh)
        qpos = torch.arange(t, device=x.device)[:, None] + (klen - t)
        kpos = torch.arange(klen, device=x.device)[None, :]
        keep = (qpos >= kpos) & (kpos >= (klen - t) - mem_valid)
        scores = scores.masked_fill(~keep, -1e9)
        p = self.drop(torch.softmax(scores, -1).to(self.dtype), generator)
        out = torch.einsum("bhtk,bkhd->bthd", p, vh).reshape(b, t, h * dh)
        return self.drop(self.o_net(out), generator)


class _PositionwiseFF(nn.Module):
    def __init__(self, cfg: TransformerXLConfig, dtype: torch.dtype):
        super().__init__()
        # the reference's CoreNet: Linear, ReLU, Dropout, Linear, Dropout
        self.CoreNet = nn.ModuleDict({
            "0": Dense(cfg.d_model, cfg.d_ff, dtype),
            "3": Dense(cfg.d_ff, cfg.d_model, dtype)})
        self.layer_norm = LayerNorm(cfg.d_model, LN_EPS, dtype)
        self.drop = RegenDropout(cfg.dropout)

    def forward(self, x, generator=None):
        y = self.drop(torch.relu(self.CoreNet["0"](x)), generator)
        return self.layer_norm(x + self.CoreNet["3"](y))


class XLLayer(nn.Module):
    """Post-LN: ``ln1(x + attn)``, then ``ln2(x + ff2(drop(relu(ff1(x)))))``."""

    def __init__(self, cfg: TransformerXLConfig, dtype: torch.dtype):
        super().__init__()
        self.dec_attn = RelAttention(cfg, dtype)
        self.pos_ff = _PositionwiseFF(cfg, dtype)

    def forward(self, x, mem, rel_pos_emb, u, w, mem_valid, generator=None):
        a = self.dec_attn(x, mem, rel_pos_emb, u, w, mem_valid, generator)
        return self.pos_ff(self.dec_attn.layer_norm(x + a), generator)


class TransformerXL(nn.Module):
    """tokens (B, T), the per-layer memories (B, M, D) (None: a fresh
    sequence) and ``mem_valid`` -> (logits (B, T, padded_vocab) fp32, the
    next segment's memories)."""

    def __init__(self, cfg: TransformerXLConfig = TransformerXLConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.word_emb = nn.Module()
        self.word_emb.emb_layers = nn.ModuleList(
            [nn.Embedding(cfg.padded_vocab, cfg.d_model)])
        self.layers = nn.ModuleList([XLLayer(cfg, dtype)
                                     for _ in range(cfg.n_layers)])
        self.r_w_bias = nn.Parameter(torch.zeros(cfg.n_heads, cfg.d_head))
        self.r_r_bias = nn.Parameter(torch.zeros(cfg.n_heads, cfg.d_head))
        self.crit = nn.Module()
        self.crit.out_layers_biases = nn.ParameterList(
            [nn.Parameter(torch.zeros(cfg.padded_vocab))])
        self.drop = RegenDropout(cfg.dropout)
        # reversed distances max_klen - 1 .. 0, sinusoids (not a parameter)
        max_klen = cfg.seg_len + cfg.mem_len
        inv = 1.0 / (10000 ** (np.arange(0, cfg.d_model, 2) / cfg.d_model))
        pos = np.arange(max_klen - 1, -1, -1.0)[:, None] * inv[None, :]
        pe = np.concatenate([np.sin(pos), np.cos(pos)], 1).astype(np.float32)
        self.register_buffer("rel_pos_emb", torch.from_numpy(pe),
                             persistent=False)

    @property
    def table(self) -> torch.Tensor:
        return self.word_emb.emb_layers[0].weight

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: the table, ``r_w_bias`` and ``r_r_bias``
        N(0, 0.02), lecun normal kernels, zero biases, unit LayerNorms."""
        for p in (self.table, self.r_w_bias, self.r_r_bias):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        self.crit.out_layers_biases[0].zero_()
        for m in self.modules():
            if isinstance(m, Dense):
                m.init_(generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()

    def initial_mems(self, batch: int, device) -> list[torch.Tensor]:
        """Zero memories (B, mem_len, d_model) in the compute dtype."""
        return [torch.zeros(batch, self.cfg.mem_len, self.cfg.d_model,
                            dtype=self.dtype, device=device)
                for _ in range(self.cfg.n_layers)]

    def forward(self, tokens, mems=None, mem_valid=None,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        if mems is None:
            mems = self.initial_mems(tokens.shape[0], tokens.device)
            mem_valid = 0 if mem_valid is None else mem_valid
        if mem_valid is None:
            mem_valid = cfg.mem_len
        x = F.embedding(tokens, self.table).to(self.dtype) * float(
            np.sqrt(cfg.d_model))
        x = self.drop(x, generator)
        rel = self.rel_pos_emb.to(self.dtype)
        u, w = self.r_w_bias.to(self.dtype), self.r_r_bias.to(self.dtype)
        new_mems = []
        for layer, mem in zip(self.layers, mems):
            # the next segment's memory: the last mem_len hiddens entering
            # this layer, out of the graph (the reference's _update_mems)
            new_mems.append(torch.cat([mem, x], 1)[:, -cfg.mem_len:].detach())
            x = layer(x, mem, rel, u, w, mem_valid, generator)
        acc = acc_dtype(self.dtype)
        logits = x.to(acc) @ self.table.to(self.dtype).to(acc).t()
        return logits + self.crit.out_layers_biases[0].to(acc), new_mems


def _rows_of_global(mems: list[torch.Tensor]) -> list[torch.Tensor]:
    """The memories marked as this rank's rows of the global batch's (each
    rank carries its own rows'), so that a checkpoint holds them whole in
    the global batch's row order and a restore at another data degree takes
    each rank's rows back."""
    for m in mems:
        mark_sharded(m, DATA_AXIS, data_rows(m.shape[0])[1])
    return mems


@dataclass
class TransformerXLTask:
    """A batch holds ``tokens`` and ``targets`` (B, T) int; the memories
    and their valid count travel in ``model_state`` (``{}`` starts a fresh
    sequence)."""

    cfg: TransformerXLConfig = TransformerXLConfig()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> TransformerXL:
        model = TransformerXL(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def initial_state(self, model: TransformerXL, batch: int) -> dict:
        """A fresh sequence's ``model_state``: zero memories, none valid
        (the same step as ``{}``), with the tensors a checkpoint restores
        into."""
        device = model.table.device
        return {"mems": _rows_of_global(model.initial_mems(batch, device)),
                "mem_valid": torch.zeros((), dtype=torch.int32, device=device)}

    def loss_fn(self, model: TransformerXL, model_state, batch: dict,
                generator: torch.Generator):
        """The mean cross-entropy over the padded vocab; the new state holds
        the next memories and ``min(mem_valid + T, mem_len)``."""
        mems = model_state.get("mems")
        mem_valid = model_state.get("mem_valid", 0 if mems is None else None)
        logits, new_mems = model(batch["tokens"], mems, mem_valid, generator)
        loss = F.cross_entropy(logits.flatten(0, 1),
                               batch["targets"].flatten().long())
        prev = mem_valid if mem_valid is not None else self.cfg.mem_len
        new_valid = torch.clamp(
            torch.as_tensor(prev, dtype=torch.int32, device=logits.device)
            + batch["tokens"].shape[1], max=self.cfg.mem_len)
        return loss, ({"mems": _rows_of_global(new_mems),
                       "mem_valid": new_valid},
                      {"ppl_proxy": loss.detach()})
