"""BERT encoder, pretraining heads and fine-tuning heads in PyTorch.

Port of ``deeplearningexamples_tpu/models/bert/modeling.py``: embeddings,
flash self-attention in the (B,S,H,D) layout, post-LN encoder layers with tanh
GELU, pooler, the MLM + NSP pretraining heads, and the fine-tuning heads: the
span head (SQuAD), sequence classification (GLUE) and multiple choice
(SWAG). Module names follow the NVIDIA/HF ``state_dict``
(``bert.encoder.layer.{i}.attention.self.query``,
``cls.predictions.transform.dense`` ...), so
``utils/torch_import.convert_bert`` in the JAX package maps these weights back
into the JAX tree.

Precision follows the JAX model's ``dtype``: parameters keep their own dtype
(fp32 for training) and every dense layer, embedding sum and LayerNorm output
is computed in the compute dtype, as flax ``Dense(dtype=bf16)`` does;
LayerNorm statistics are fp32. With ``dtype=None`` the compute dtype is the
parameters' own (``BertSquadTask`` casts the encoder to bf16 for serving).
The word table keeps ``padded_vocab`` rows. The QA, NSP and classifier heads
run in fp32 on fp32 weights, and the MLM decoder, tied to the word table,
gives fp32 logits.

Dropout is on when a forward is given a ``torch.Generator`` (JAX
``deterministic=False``): hidden dropout at the JAX sites (embeddings,
attention output, FFN output) through ``ops.dropout``, and attention-
probability dropout inside the flash kernel with a fresh int32 seed per call,
both drawn from that generator.

``BertConfig.attention_impl`` is ``"flash"`` (K1/K2, the default),
``"xla"`` (JAX's plain path, in plain torch ops: fp32 scores, -1e9 masking,
softmax, ``RegenDropout`` on the probabilities, the PV product in the
compute dtype) or ``"ring"`` (``ops.ring_attention`` over the current mesh's
sequence axis, on the (B,H,S,D) transposes of q, k and v; its dropout seed
comes from the generator as the flash path's does, and for one seed its
keep mask is K1's). ``remat`` checkpoints each ``BertLayer`` while gradients are
on and recomputes the whole layer in the backward (JAX's
``remat_policy="full"``; JAX's default "dots" is not kept, see ROADMAP). The
recompute replays the layer's dropout seeds from a copy of the generator's
state taken before the layer, so it regenerates the forward's masks and the
gradients equal those without remat.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.utils.checkpoint as ckpt
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import RegenDropout, regen_dropout
from ...ops.flash_attention import flash_attention
from ...ops.ring_attention import ring_attention
from ...parallel.mesh import data_rows

__all__ = [
    "BERT_CONFIGS",
    "BertConfig",
    "BertEmbeddings",
    "BertSelfAttention",
    "attention_seed",
    "BertLayer",
    "BertModel",
    "BertForMultipleChoice",
    "BertForPreTraining",
    "BertForQuestionAnswering",
    "BertForSequenceClassification",
    "Dense",
    "LayerNorm",
]


@dataclass(frozen=True)
class BertConfig:
    """The JAX ``BertConfig``'s fields and defaults, less ``remat_policy``:
    ``remat`` always recomputes whole layers (JAX's "full")."""

    vocab_size: int = 30528  # 30522 padded up; pad further to %128 at embed
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    remat: bool = False
    gelu_approximate: bool = True  # tanh GELU, as the reference BERT
    attention_impl: str = "flash"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


BERT_CONFIGS = {
    "tiny": BertConfig(
        vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
        intermediate_size=128, max_position_embeddings=512,
    ),
    "base": BertConfig(),
    "large": BertConfig(
        hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
    ),
}


class Dense(nn.Linear):
    """flax ``Dense(dtype=...)``: input, weight and bias cast to the compute
    dtype (``None``: the weight's own) before the product."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype | None = None):
        super().__init__(d_in, d_out)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=...)``: statistics and the affine step in fp32
    for fp32 parameters, the output in the compute dtype."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype | None = None):
        super().__init__(d, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        if self.weight.dtype == dt:
            return F.layer_norm(x.to(dt), self.normalized_shape, self.weight,
                                self.bias, self.eps)
        # fp32 weights, lower-precision compute: flax normalises and applies
        # the affine step in fp32 and rounds only the output
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(dt)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.padded_vocab, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.dropout = RegenDropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids, generator=None):
        dt = self.compute_dtype or self.word_embeddings.weight.dtype
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        # each lookup in the compute dtype, then summed in it, as flax Embed.
        # The lookups index the tables, whose backward on the card sums each
        # row's cotangents in the order of the sorted indices; nn.Embedding's
        # gave the token types' two rows (thousands of cotangents each) bits
        # that differed between two processes on the same inputs, and the
        # ranks of a sequence line must end a step with equal parameters
        x = (self.word_embeddings.weight[input_ids].to(dt)
             + self.position_embeddings.weight[pos].to(dt)
             + self.token_type_embeddings.weight[token_type_ids].to(dt))
        return self.dropout(self.LayerNorm(x), generator)


def attention_seed(generator: torch.Generator) -> int:
    """A fresh int32 seed for K1's dropout hash, as JAX's
    ``jax.random.randint(-2**31, 2**31 - 1)`` per call."""
    return int(torch.randint(-2**31, 2**31 - 1, (1,), generator=generator))


class BertSelfAttention(nn.Module):
    """q/k/v projections written straight into the (B,S,H,D) layout that the
    flash kernel reads in place: no head transpose is materialised."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        if cfg.attention_impl not in ("flash", "xla", "ring"):
            raise ValueError(f"attention_impl {cfg.attention_impl!r}: flash, "
                             "xla or ring")
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.attention_dropout = cfg.attention_dropout
        self.impl = cfg.attention_impl
        self.query = Dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.key = Dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.value = Dense(cfg.hidden_size, cfg.hidden_size, dtype)

    def forward(self, x, key_mask, generator=None):
        b, s, hidden = x.shape
        q, k, v = (proj(x).view(b, s, self.num_heads, self.head_dim)
                   for proj in (self.query, self.key, self.value))
        if self.impl == "xla":
            return self._plain(q, k, v, key_mask, generator).reshape(b, s, hidden)
        rate, seed = 0.0, 0
        if generator is not None and self.attention_dropout > 0.0:
            rate, seed = self.attention_dropout, attention_seed(generator)
        if self.impl == "ring":
            ctx = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), key_mask=key_mask,
                                 dropout_rate=rate, dropout_seed=seed)
            return ctx.transpose(1, 2).reshape(b, s, hidden)
        # the hash's batch row is the global one under a data axis
        ctx = flash_attention(q, k, v, key_mask=key_mask, layout="bshd",
                              dropout_rate=rate, dropout_seed=seed,
                              dropout_batch_offset=data_rows(b)[0])
        return ctx.reshape(b, s, hidden)

    def _plain(self, q, k, v, key_mask, generator):
        """JAX's ``attention_impl == "xla"`` branch: scores from the
        compute-dtype products summed in fp32, scaled, masked to -1e9,
        softmax in fp32, probability dropout, then P (in the compute dtype)
        times V."""
        scale = float(np.float32(1.0 / np.sqrt(self.head_dim)))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        logits = logits.masked_fill(~key_mask.bool()[:, None, None, :],
                                    -1e9)
        p = torch.softmax(logits, dim=-1)
        if generator is not None and self.attention_dropout > 0.0:
            p = regen_dropout(p, self.attention_dropout, generator)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


class _DenseLayerNorm(nn.Module):
    """dense -> dropout -> residual add -> LayerNorm (the HF
    ``BertSelfOutput`` and ``BertOutput``)."""

    def __init__(self, d_in: int, cfg: BertConfig, dtype=None):
        super().__init__()
        self.dense = Dense(d_in, cfg.hidden_size, dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.dropout = RegenDropout(cfg.hidden_dropout)

    def forward(self, y, residual, generator=None):
        return self.LayerNorm(residual + self.dropout(self.dense(y), generator))


class _BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.self = BertSelfAttention(cfg, dtype)
        self.output = _DenseLayerNorm(cfg.hidden_size, cfg, dtype)

    def forward(self, x, key_mask, generator=None):
        return self.output(self.self(x, key_mask, generator), x, generator)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.approximate = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, x):
        return F.gelu(self.dense(x), approximate=self.approximate)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.attention = _BertAttention(cfg, dtype)
        self.intermediate = _Intermediate(cfg, dtype)
        self.output = _DenseLayerNorm(cfg.intermediate_size, cfg, dtype)

    def forward(self, x, key_mask, generator=None):
        x = self.attention(x, key_mask, generator)
        return self.output(self.intermediate(x), x, generator)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.remat = cfg.remat
        self.layer = nn.ModuleList(BertLayer(cfg, dtype)
                                   for _ in range(cfg.num_layers))

    def forward(self, x, key_mask, generator=None):
        for layer in self.layer:
            if self.remat and torch.is_grad_enabled():
                x = self._checkpointed(layer, x, key_mask, generator)
            else:
                x = layer(x, key_mask, generator)
        return x

    def _checkpointed(self, layer, x, key_mask, generator):
        """``layer`` under ``torch.utils.checkpoint`` (non-reentrant). Its
        dropout seeds come from a generator restored to ``generator``'s
        state before the layer, in the forward and again in the recompute
        (checkpoint restores only the default generators); ``generator``
        then moves on as far as the layer drew from it."""
        start = generator.get_state() if generator is not None else None
        end = []

        def run(x, key_mask):
            gen = None
            if start is not None:
                gen = torch.Generator()
                gen.set_state(start)
            out = layer(x, key_mask, gen)
            if gen is not None and not end:
                end.append(gen.get_state())
            return out

        out = ckpt.checkpoint(run, x, key_mask, use_reentrant=False)
        if end:
            generator.set_state(end[0])
        return out


class _Pooler(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    """Returns (sequence output, pooled [CLS] output) in the compute dtype."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, dtype)
        self.encoder = _Encoder(cfg, dtype)
        self.pooler = _Pooler(cfg, dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: torch.Generator | None = None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # the kernel's key-mask type, converted once for all layers
        key_mask = attention_mask.to(torch.int32)
        x = self.embeddings(input_ids, token_type_ids, generator)
        x = self.encoder(x, key_mask, generator)
        return x, self.pooler(x)


class _LMTransform(nn.Module):
    """dense -> tanh GELU -> LayerNorm (JAX ``mlm_transform``, ``mlm_ln``)."""

    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.approximate = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, x):
        return self.LayerNorm(F.gelu(self.dense(x), approximate=self.approximate))


class _LMPrediction(nn.Module):
    """The transform and the decoder's own bias (JAX ``mlm_bias``); the
    decoder weight is the word table, so it has no parameter here."""

    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.transform = _LMTransform(cfg, dtype)
        self.bias = nn.Parameter(torch.zeros(cfg.padded_vocab))


class _PreTrainingHeads(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=None):
        super().__init__()
        self.predictions = _LMPrediction(cfg, dtype)
        self.seq_relationship = Dense(cfg.hidden_size, 2, torch.float32)


class BertForPreTraining(nn.Module):
    """MLM + NSP heads (JAX ``BertForPreTraining``). Returns ``(mlm_logits,
    nsp_logits)``, both fp32: (B, P or S, padded_vocab) and (B, 2)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.bert = BertModel(cfg, dtype)
        self.cls = _PreTrainingHeads(cfg, dtype)

    def forward(self, input_ids, attention_mask, token_type_ids,
                masked_positions=None, generator: torch.Generator | None = None):
        """``masked_positions`` (B, P): only those positions reach the vocab
        projection (the reference's dense-sequence-output)."""
        seq, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                                generator)
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(-1, -1, seq.shape[-1])
            seq = seq.gather(1, idx)  # (B, P, hidden)
        pred = self.cls.predictions
        t = pred.transform(seq)
        word = self.bert.embeddings.word_embeddings.weight
        dt = self.compute_dtype or word.dtype
        # tied decoder: operands rounded to the compute dtype, products summed
        # in fp32 and kept in fp32, as JAX's preferred_element_type=float32
        mlm_logits = F.linear(t.to(dt).float(), word.to(dt).float()) + pred.bias
        nsp_logits = self.cls.seq_relationship(pooled.float())
        return mlm_logits, nsp_logits


class BertForQuestionAnswering(nn.Module):
    """Span start/end head; returns (start_logits, end_logits), fp32. The
    head runs in fp32 and takes no dropout. ``dtype`` is the encoder's
    compute dtype: bf16 over fp32 weights for training; ``None`` for
    serving, whose encoder ``BertSquadTask.place`` casts to bf16."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, dtype)
        self.qa_outputs = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: torch.Generator | None = None):
        seq, _ = self.bert(input_ids, attention_mask, token_type_ids, generator)
        logits = self.qa_outputs(seq.to(self.qa_outputs.weight.dtype))
        return logits[..., 0], logits[..., 1]


class BertForSequenceClassification(nn.Module):
    """GLUE head (JAX ``BertForSequenceClassification``): dropout on the
    pooled output, then an fp32 classifier; returns (B, num_labels) fp32."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, dtype)
        self.dropout = RegenDropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator: torch.Generator | None = None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              generator)
        pooled = self.dropout(pooled, generator)
        return self.classifier(pooled.to(self.classifier.weight.dtype))


class BertForMultipleChoice(nn.Module):
    """SWAG head (JAX ``BertForMultipleChoice``): inputs (B, C, S) folded to
    (B*C, S), one fp32 score per (context, choice) pair from the pooled
    output, reshaped to (B, C) logits."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, dtype)
        self.dropout = RegenDropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, 1)

    def forward(self, input_ids, attention_mask, token_type_ids,
                generator: torch.Generator | None = None):
        b, c, s = input_ids.shape
        _, pooled = self.bert(input_ids.reshape(b * c, s),
                              attention_mask.reshape(b * c, s),
                              token_type_ids.reshape(b * c, s), generator)
        pooled = self.dropout(pooled, generator)
        scores = self.classifier(pooled.to(self.classifier.weight.dtype))
        return scores.reshape(b, c)
