"""BERT encoder, question-answering head and pretraining heads in PyTorch.

Port of ``deeplearningexamples_tpu/models/bert/modeling.py``: embeddings,
flash self-attention in the (B,S,H,D) layout, post-LN encoder layers with tanh
GELU, pooler, the span head, and the MLM + NSP pretraining heads. Module names
follow the NVIDIA/HF ``state_dict`` (``bert.encoder.layer.{i}.attention.self.
query``, ``cls.predictions.transform.dense`` ...), so
``utils/torch_import.convert_bert`` in the JAX package maps these weights back
into the JAX tree.

Precision follows the JAX model's ``dtype``: parameters keep their own dtype
(fp32 for training) and every dense layer, embedding sum and LayerNorm output
is computed in the compute dtype, as flax ``Dense(dtype=bf16)`` does;
LayerNorm statistics are fp32. With ``dtype=None`` the compute dtype is the
parameters' own (``BertSquadTask`` casts the encoder to bf16 for serving).
The word table keeps ``padded_vocab`` rows. The QA and NSP heads run in fp32
on fp32 weights, and the MLM decoder, tied to the word table, gives fp32
logits.

Dropout is on when a forward is given a ``torch.Generator`` (JAX
``deterministic=False``): hidden dropout at the JAX sites (embeddings,
attention output, FFN output) through ``ops.dropout``, and attention-
probability dropout inside the flash kernel with a fresh int32 seed per call,
both drawn from that generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dropout import RegenDropout
from ...ops.flash_attention import flash_attention

__all__ = [
    "BERT_CONFIGS",
    "BertConfig",
    "BertEmbeddings",
    "BertSelfAttention",
    "BertLayer",
    "BertModel",
    "BertForPreTraining",
    "BertForQuestionAnswering",
    "Dense",
    "LayerNorm",
]


@dataclass(frozen=True)
class BertConfig:
    """The JAX ``BertConfig``'s fields and defaults."""

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
    remat_policy: str = "dots"
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
        # each lookup in the compute dtype, then summed in it, as flax Embed
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        return self.dropout(self.LayerNorm(x), generator)


class BertSelfAttention(nn.Module):
    """q/k/v projections written straight into the (B,S,H,D) layout that the
    flash kernel reads in place: no head transpose is materialised."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.attention_dropout = cfg.attention_dropout
        self.query = Dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.key = Dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.value = Dense(cfg.hidden_size, cfg.hidden_size, dtype)

    def forward(self, x, key_mask, generator=None):
        b, s, hidden = x.shape
        q, k, v = (proj(x).view(b, s, self.num_heads, self.head_dim)
                   for proj in (self.query, self.key, self.value))
        rate, seed = 0.0, 0
        if generator is not None and self.attention_dropout > 0.0:
            # a fresh int32 seed per call, as jax.random.randint(-2**31, 2**31-1)
            rate = self.attention_dropout
            seed = int(torch.randint(-2**31, 2**31 - 1, (1,),
                                     generator=generator))
        ctx = flash_attention(q, k, v, key_mask=key_mask, layout="bshd",
                              dropout_rate=rate, dropout_seed=seed)
        return ctx.reshape(b, s, hidden)


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
        self.layer = nn.ModuleList(BertLayer(cfg, dtype)
                                   for _ in range(cfg.num_layers))

    def forward(self, x, key_mask, generator=None):
        for layer in self.layer:
            x = layer(x, key_mask, generator)
        return x


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
    """Span start/end head; returns (start_logits, end_logits), fp32."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.qa_outputs = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        seq, _ = self.bert(input_ids, attention_mask, token_type_ids)
        logits = self.qa_outputs(seq.to(self.qa_outputs.weight.dtype))
        return logits[..., 0], logits[..., 1]
