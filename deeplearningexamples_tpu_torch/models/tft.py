"""Temporal Fusion Transformer: multi-horizon quantile forecasting, in
PyTorch.

Port of ``deeplearningexamples_tpu/models/tft.py`` (reference
``PyTorch/Forecasting/TFT/modeling.py``) with the reference's ``state_dict``
names, which ``utils/torch_import.convert_tft`` in the JAX package reads
(``embedding.*``, ``static_encoder.*``, ``TFTpart2.*``; a GRN's
``lin_a``, ``lin_c``, ``lin_i``, ``glu.lin``, ``out_proj`` and
``layer_norm.ln``).

- GRN: ``lin_a`` (plus ``lin_c`` of the context, broadcast over time), ELU,
  ``lin_i``, dropout, GLU, the residual (through ``out_proj`` where the size
  changes), then LayerNorm (epsilon 1e-3), which a scalar output skips.
- The embeddings: a continuous input is ``x * vector + bias`` per variable;
  a static categorical has a table per variable.
- The history LSTM starts from the static contexts: flax's carry is ``(c,
  h)``, so ``h0 = ch`` and ``c0 = cc``; the future LSTM starts from the
  history's final state. Both are one ``nn.LSTM`` layer with flax's one
  bias (``tts.layers.LSTMLayer``: ``bias_hh_l0`` trained, ``bias_ih_l0`` a
  buffer), run whole by ``torch.lstm``.
- The attention's heads score over one shared value head and are
  averaged; the mask is causal with ``-inf``; probabilities in fp32.
- The quantile projection is fp32, on the horizon's steps only.

Dropout is ``ops.dropout.RegenDropout`` (its bits cannot match
``jax.random``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import _VF, nn

from ..ops.dropout import RegenDropout
from .bert.modeling import LayerNorm
from .convnets.layers import Dense
from .tts.layers import LSTMLayer, acc_dtype, init_lstm_

__all__ = ["GLU", "GRN", "InterpretableMultiHeadAttention",
           "StaticCovariateEncoder", "TFT", "TFTConfig", "TFTEmbedding",
           "TFTTask", "VariableSelectionNetwork", "quantile_loss"]

LN_EPS = 1e-3


@dataclass(frozen=True)
class TFTConfig:
    """The JAX ``TFTConfig``: the ``observed`` block holds the target column
    at ``target_pos``."""

    n_observed: int = 4
    n_known: int = 2
    target_pos: int = 0
    static_categorical_sizes: tuple[int, ...] = (1,)
    hidden: int = 64
    n_heads: int = 4
    encoder_len: int = 48
    horizon: int = 12
    dropout: float = 0.1
    attn_dropout: float = 0.0
    quantiles: tuple[float, ...] = (0.1, 0.5, 0.9)

    @property
    def example_length(self) -> int:
        return self.encoder_len + self.horizon

    @property
    def n_observed_cont(self) -> int:  # the observed block less the target
        return self.n_observed - 1

    @property
    def num_static_vars(self) -> int:
        return len(self.static_categorical_sizes)

    @property
    def num_future_vars(self) -> int:
        return self.n_known

    @property
    def num_historic_vars(self) -> int:
        return self.num_future_vars + self.n_observed_cont + 1


class GLU(nn.Module):
    """``a * sigmoid(b)`` of one Linear's two halves."""

    def __init__(self, cin: int, out: int, dtype: torch.dtype):
        super().__init__()
        self.lin = Dense(cin, 2 * out, dtype)

    def forward(self, x):
        a, b = self.lin(x).chunk(2, -1)
        return a * torch.sigmoid(b)


class _MaybeLayerNorm(nn.Module):
    """LayerNorm, or the identity for a scalar output (the reference's
    ``MaybeLayerNorm``)."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.ln = LayerNorm(d, LN_EPS, dtype) if d != 1 else None

    def forward(self, x):
        return x if self.ln is None else self.ln(x)


class GRN(nn.Module):
    """Gated residual network over (..., cin); ``out`` None keeps
    ``hidden`` (= cin) and the identity residual."""

    def __init__(self, cin: int, hidden: int, out: int | None = None,
                 dropout: float = 0.0, context: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        size = out or hidden
        self.lin_a = Dense(cin, hidden, dtype)
        self.lin_c = Dense(hidden, hidden, dtype, bias=False) if context \
            else None
        self.lin_i = Dense(hidden, hidden, dtype)
        self.glu = GLU(hidden, size, dtype)
        self.out_proj = Dense(cin, size, dtype) if out is not None else None
        self.layer_norm = _MaybeLayerNorm(size, dtype)
        self.drop = RegenDropout(dropout)

    def forward(self, a, c=None, generator=None):
        x = self.lin_a(a)
        if c is not None:  # (B, H), broadcast over the time axis
            x = x + self.lin_c(c)[:, None, :]
        x = self.drop(self.lin_i(F.elu(x)), generator)
        x = self.glu(x)
        y = a if self.out_proj is None else self.out_proj(a)
        return self.layer_norm(x + y)


class TFTEmbedding(nn.Module):
    """The input streams: static categoricals (B, n_static, H), and the
    known, observed and target continuous ones (B, T, F, H)."""

    def __init__(self, cfg: TFTConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        h = cfg.hidden
        self.s_cat_embed = nn.ModuleList(
            [nn.Embedding(n, h) for n in cfg.static_categorical_sizes])
        streams = [("t_cont_k", cfg.n_known), ("t_tgt", 1)]
        if cfg.n_observed_cont:
            streams.append(("t_cont_o", cfg.n_observed_cont))
        for name, n in streams:
            self.register_parameter(f"{name}_embedding_vectors",
                                    nn.Parameter(torch.empty(n, h)))
            self.register_parameter(f"{name}_embedding_bias",
                                    nn.Parameter(torch.zeros(n, h)))

    def _cont(self, x, name: str):
        vec = getattr(self, f"{name}_embedding_vectors").to(self.dtype)
        bias = getattr(self, f"{name}_embedding_bias").to(self.dtype)
        return x.to(self.dtype)[..., None] * vec + bias

    def forward(self, x: dict):
        s_inp = torch.stack([F.embedding(x["s_cat"][..., i], emb.weight)
                             .to(self.dtype)
                             for i, emb in enumerate(self.s_cat_embed)], -2)
        t_observed = self._cont(x["o_cont"], "t_cont_o") \
            if self.cfg.n_observed_cont else None
        return (s_inp, self._cont(x["k_cont"], "t_cont_k"), t_observed,
                self._cont(x["target"], "t_tgt"))


class VariableSelectionNetwork(nn.Module):
    """(..., n, H) -> (..., H) and the variable weights (..., n): a joint
    GRN over the flattened inputs (its own dropout 0, as in JAX) gives
    softmax weights over the per-variable GRNs."""

    def __init__(self, cfg: TFTConfig, num_inputs: int, context: bool,
                 dtype: torch.dtype):
        super().__init__()
        h = cfg.hidden
        self.joint_grn = GRN(num_inputs * h, h, out=num_inputs,
                             context=context, dtype=dtype)
        self.var_grns = nn.ModuleList(
            [GRN(h, h, dropout=cfg.dropout, dtype=dtype)
             for _ in range(num_inputs)])

    def forward(self, x, context=None, generator=None):
        flat = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
        w = torch.softmax(self.joint_grn(flat, context, generator), -1)
        per_var = torch.stack([grn(x[..., i, :], generator=generator)
                               for i, grn in enumerate(self.var_grns)], -1)
        return (per_var * w[..., None, :]).sum(-1), w


class StaticCovariateEncoder(nn.Module):
    """The static VSN, then four context GRNs: (cs, ce, ch, cc), the
    selection, enrichment, LSTM-h and LSTM-c contexts."""

    def __init__(self, cfg: TFTConfig, dtype: torch.dtype):
        super().__init__()
        self.vsn = VariableSelectionNetwork(cfg, cfg.num_static_vars, False,
                                            dtype)
        self.context_grns = nn.ModuleList(
            [GRN(cfg.hidden, cfg.hidden, dropout=cfg.dropout, dtype=dtype)
             for _ in range(4)])

    def forward(self, s_inp, generator=None):
        ctx, _ = self.vsn(s_inp, generator=generator)
        return tuple(grn(ctx, generator=generator) for grn in self.context_grns)


class InterpretableMultiHeadAttention(nn.Module):
    """Per-head causal scores over one shared value head, the heads'
    outputs averaged; returns (out (B, T, H), probabilities (B, nh, T, T))."""

    def __init__(self, cfg: TFTConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        nh, dh = cfg.n_heads, cfg.hidden // cfg.n_heads
        self.qkv_linears = Dense(cfg.hidden, (2 * nh + 1) * dh, dtype,
                                 bias=False)
        self.out_proj = Dense(dh, cfg.hidden, dtype, bias=False)
        self.attn_drop = RegenDropout(cfg.attn_dropout)
        self.drop = RegenDropout(cfg.dropout)

    def forward(self, x, generator=None):
        b, t, _ = x.shape
        nh, dh = self.cfg.n_heads, self.cfg.hidden // self.cfg.n_heads
        q, k, v = self.qkv_linears(x).split([nh * dh, nh * dh, dh], -1)
        q = q.reshape(b, t, nh, dh).transpose(1, 2)
        k = k.reshape(b, t, nh, dh).transpose(1, 2)
        score = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        score = score.masked_fill(~causal, float("-inf"))
        prob = torch.softmax(score.to(acc_dtype(score.dtype)), -1)
        prob = self.attn_drop(prob, generator).to(self.dtype)
        vec = prob @ v[:, None]  # (b, nh, t, dh)
        out = self.out_proj(vec.mean(1))
        return self.drop(out, generator), prob


class _LSTM(LSTMLayer):
    """One forward ``nn.LSTM`` layer from a given state: (B, T, C), (h0,
    c0) (B, H) -> outputs (B, T, H), (h, c)."""

    def __init__(self, cin: int, hidden: int, dtype: torch.dtype):
        super().__init__(cin, hidden, dtype, ("_l0",))

    def forward(self, x, state):
        h0, c0 = (s.to(self.dtype)[None].contiguous() for s in state)
        out, h, c = _VF.lstm(x.to(self.dtype), (h0, c0), self.weights("_l0"),
                             True, 1, 0.0, self.training, False, True)
        return out, (h[0], c[0])

    def init_(self, generator: torch.Generator) -> None:
        init_lstm_(self.weight_ih_l0, self.weight_hh_l0, self.bias_hh_l0,
                   self.bias_ih_l0, generator)


class _Part2(nn.Module):
    """The reference's ``TFTBack`` (``TFTpart2``): the temporal layers."""

    def __init__(self, cfg: TFTConfig, dtype: torch.dtype):
        super().__init__()
        h = cfg.hidden
        self.history_vsn = VariableSelectionNetwork(
            cfg, cfg.num_historic_vars, True, dtype)
        self.history_encoder = _LSTM(h, h, dtype)
        self.future_vsn = VariableSelectionNetwork(
            cfg, cfg.num_future_vars, True, dtype)
        self.future_encoder = _LSTM(h, h, dtype)
        self.input_gate = GLU(h, h, dtype)
        self.input_gate_ln = LayerNorm(h, LN_EPS, dtype)
        self.enrichment_grn = GRN(h, h, dropout=cfg.dropout, context=True,
                                  dtype=dtype)
        self.attention = InterpretableMultiHeadAttention(cfg, dtype)
        self.attention_gate = GLU(h, h, dtype)
        self.attention_ln = LayerNorm(h, LN_EPS, dtype)
        self.positionwise_grn = GRN(h, h, dropout=cfg.dropout, dtype=dtype)
        self.decoder_gate = GLU(h, h, dtype)
        self.decoder_ln = LayerNorm(h, LN_EPS, dtype)
        self.quantile_proj = Dense(h, len(cfg.quantiles), acc_dtype(dtype))


class TFT(nn.Module):
    """x: {"s_cat" (B, n_static) int, "k_cont" (B, enc + hor, n_known),
    "o_cont" (B, enc, n_observed - 1), "target" (B, enc, 1)} -> quantile
    forecasts (B, horizon, n_quantiles) fp32."""

    def __init__(self, cfg: TFTConfig = TFTConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embedding = TFTEmbedding(cfg, dtype)
        self.static_encoder = StaticCovariateEncoder(cfg, dtype)
        self.TFTpart2 = _Part2(cfg, dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero biases, unit
        LayerNorms, xavier normal embedding vectors, the tables N(0, 1 /
        H), the LSTMs as ``OptimizedLSTMCell``'s."""
        for name, p in self.embedding.named_parameters():
            if name.endswith("_vectors"):
                n, h = p.shape
                p.copy_(torch.randn(p.shape, generator=generator)
                        * (2.0 / (n + h)) ** 0.5)
            elif name.endswith("_bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[1] ** -0.5)
        for m in self.modules():
            if isinstance(m, (Dense, _LSTM)):
                m.init_(generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()

    def forward(self, x: dict, generator: torch.Generator | None = None):
        cfg, p2, enc = self.cfg, self.TFTpart2, self.cfg.encoder_len
        s_inp, t_known, t_observed, t_target = self.embedding(x)
        cs, ce, ch, cc = self.static_encoder(s_inp, generator)
        hist = [t_known[:, :enc], t_target[:, :enc]]
        if t_observed is not None:
            hist.insert(0, t_observed[:, :enc])
        hist_features, _ = p2.history_vsn(torch.cat(hist, -2), cs, generator)
        history, state = p2.history_encoder(hist_features, (ch, cc))
        fut_features, _ = p2.future_vsn(t_known[:, enc:], cs, generator)
        future, _ = p2.future_encoder(fut_features, state)

        input_embedding = torch.cat([hist_features, fut_features], 1)
        temporal = p2.input_gate(torch.cat([history, future], 1))
        temporal = p2.input_gate_ln(temporal + input_embedding)
        enriched = p2.enrichment_grn(temporal, ce, generator)
        attn_out, _ = p2.attention(enriched, generator)
        # the quantiles of the horizon's steps only
        attn_out, temporal, enriched = (
            t[:, enc:] for t in (attn_out, temporal, enriched))
        y = p2.attention_ln(p2.attention_gate(attn_out) + enriched)
        y = p2.positionwise_grn(y, generator=generator)
        y = p2.decoder_ln(p2.decoder_gate(y) + temporal)
        return p2.quantile_proj(y.to(p2.quantile_proj.dtype))


def quantile_loss(pred, target, quantiles) -> torch.Tensor:
    """The pinball loss averaged over the batch, the horizon and the
    quantiles (reference ``criterions.py``)."""
    q = torch.tensor(quantiles, dtype=pred.dtype, device=pred.device)
    err = target[..., None].to(pred.dtype) - pred
    return torch.maximum(q * err, (q - 1.0) * err).mean()


@dataclass
class TFTTask:
    """A batch holds ``observed`` (B, enc, n_observed), ``known`` (B, enc +
    hor, n_known) and ``target`` (B, hor): ``data.timeseries``'s windows."""

    cfg: TFTConfig = TFTConfig()
    dtype: torch.dtype = torch.float32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> TFT:
        model = TFT(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def model_inputs(self, observed, known, s_cat=None) -> dict:
        """The loader's {"observed", "known"} as the reference's streams:
        the target column splits out of the observed block; the static
        categoricals default to 0."""
        tpos = self.cfg.target_pos
        x = {"k_cont": known, "target": observed[..., tpos:tpos + 1],
             "s_cat": s_cat if s_cat is not None else torch.zeros(
                 observed.shape[0], self.cfg.num_static_vars,
                 dtype=torch.long, device=observed.device)}
        if self.cfg.n_observed_cont:
            x["o_cont"] = torch.cat([observed[..., :tpos],
                                     observed[..., tpos + 1:]], -1)
        return x

    def loss_fn(self, model: TFT, model_state, batch: dict,
                generator: torch.Generator):
        x = self.model_inputs(batch["observed"], batch["known"],
                              batch.get("s_cat"))
        pred = model(x, generator)
        return quantile_loss(pred, batch["target"], self.cfg.quantiles), \
            (model_state, {})

    @torch.no_grad()
    def predict_fn(self, model: TFT, observed, known, s_cat=None):
        """The quantile forecasts (B, hor, n_quantiles), without dropout."""
        return model(self.model_inputs(observed, known, s_cat))
