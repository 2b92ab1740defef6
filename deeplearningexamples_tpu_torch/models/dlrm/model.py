"""DLRM, the deep learning recommendation model, in PyTorch.

Port of ``deeplearningexamples_tpu/models/dlrm/model.py``: a bottom MLP over
13 numerical features, one lookup per categorical feature into one joint
table (all tables stacked row-wise, each feature's indices shifted by its
offset), the dot (or cat) interaction, and a top MLP to one click logit.

The joint table's lookup is ``ops/embedding.py``'s ``embedding_lookup``, whose
forward on the card is the row-gather kernel K4; the table is stored in
``table_dtype`` (fp32 or bf16) and cast to the compute dtype after the
gather. Under a model axis (``parallel/mesh.py``, JAX's ``--mesh-model``)
the joint table is row-sharded: rank m holds rows ``[m R / N, (m + 1) R /
N)`` of the R rows, looks up the ids it owns (shifted to its rows; the
others masked to zero rows) and the partial rows are summed over the model
axis (``sum_partials``: the MLPs and the loss after it are replicated there,
so the backward is the identity). The table's gradient and its SGD rows
stay on their rank. Parameter names follow the JAX tree: ``embedding_table``,
``bottom_mlp.{i}.weight/bias`` and ``top_mlp.{i}.weight/bias`` (a flax Dense
``bottom_mlp_{i}`` kernel, transposed).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dot_interaction import dot_interaction, interaction_output_dim
from ...ops.embedding import embedding_lookup
from ...parallel.mesh import (MODEL_AXIS, current_mesh, mark_sharded,
                              rank_rows, sum_partials)

__all__ = ["Dlrm", "DlrmConfig"]


@dataclass(frozen=True)
class DlrmConfig:
    categorical_cardinalities: tuple[int, ...]
    embedding_dim: int = 128
    num_numerical: int = 13
    bottom_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"  # dot | cat
    hash_indices: bool = False
    # embedding grad: "scatter" (a dense scatter-add) | "sorted" (argsort +
    # sorted segment sum, ops/embedding.py)
    embedding_grad: str = "scatter"
    # table storage dtype: bf16 halves the bytes behind every row gather
    table_dtype: str = "fp32"  # fp32 | bf16

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.embedding_dim:
            raise ValueError("bottom MLP must end at embedding_dim for dot "
                             "interaction")

    @property
    def num_features(self) -> int:
        return len(self.categorical_cardinalities) + 1

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate(
            [[0], np.cumsum(self.categorical_cardinalities)[:-1]]
        ).astype(np.int64)

    @property
    def total_rows(self) -> int:
        # padded to a multiple of 8, as the JAX table (which row-shards it);
        # pad rows are never indexed
        n = int(sum(self.categorical_cardinalities))
        return -(-n // 8) * 8


def _mlp_layers(d_in: int, sizes: tuple[int, ...]) -> nn.ModuleList:
    layers = []
    for w in sizes:
        layers.append(nn.Linear(d_in, w))
        d_in = w
    return nn.ModuleList(layers)


def _mlp(x: torch.Tensor, layers: nn.ModuleList, dtype: torch.dtype,
         final_relu: bool = True) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` per layer: input, kernel and bias cast
    to ``dtype``; ReLU after each but (without ``final_relu``) the last."""
    for i, lin in enumerate(layers):
        x = F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))
        if i < len(layers) - 1 or final_relu:
            x = F.relu(x)
    return x


class Dlrm(nn.Module):
    """``forward(numerical (B, 13) float, categorical (B, 26) int) -> (B,)``
    fp32 logits. Parameters are fp32 (the table in ``cfg.table_dtype``);
    ``dtype`` is the compute dtype."""

    def __init__(self, cfg: DlrmConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        table_dtype = torch.bfloat16 if cfg.table_dtype == "bf16" else torch.float32
        # this rank's rows of the joint table (all of it without a model axis)
        self.rows = rank_rows(cfg.total_rows, MODEL_AXIS)
        self.sharded = current_mesh().size(MODEL_AXIS) > 1
        self.embedding_table = nn.Parameter(torch.zeros(
            self.rows[1] - self.rows[0], cfg.embedding_dim, dtype=table_dtype))
        if self.sharded:
            mark_sharded(self.embedding_table, MODEL_AXIS, cfg.total_rows)
        self.bottom_mlp = _mlp_layers(cfg.num_numerical, cfg.bottom_mlp)
        inter = (interaction_output_dim(cfg.num_features, cfg.embedding_dim)
                 if cfg.interaction == "dot"
                 else cfg.embedding_dim * cfg.num_features)
        self.top_mlp = _mlp_layers(inter, cfg.top_mlp)
        self.register_buffer("offsets", torch.as_tensor(
            cfg.offsets, dtype=torch.int32), persistent=False)
        self.register_buffer("cardinalities", torch.as_tensor(
            cfg.categorical_cardinalities, dtype=torch.int32), persistent=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX initialisers, drawn from ``generator`` in a fixed order
        (tables, then the bottom and top MLPs): each table uniform in
        +-1/sqrt(cardinality), pad rows 0; each kernel normal with std
        sqrt(2 / (in + out)), each bias normal with std sqrt(1 / out). A
        row shard keeps its rows of the same draws."""
        lo, hi = self.rows
        self.embedding_table.zero_()
        row = 0
        for c in self.cfg.categorical_cardinalities:
            bound = 1.0 / np.sqrt(c)
            part = torch.empty(c, self.cfg.embedding_dim, dtype=torch.float32)
            part.uniform_(-bound, bound, generator=generator)
            a, b = max(row, lo), min(row + c, hi)
            if a < b:
                self.embedding_table[a - lo:b - lo] = part[a - row:b - row].to(
                    self.embedding_table)
            row += c
        for lin in (*self.bottom_mlp, *self.top_mlp):
            d_out, d_in = lin.weight.shape
            w = torch.empty(d_out, d_in).normal_(
                0.0, float(np.sqrt(2.0 / (d_in + d_out))), generator=generator)
            b = torch.empty(d_out).normal_(
                0.0, float(np.sqrt(1.0 / d_out)), generator=generator)
            lin.weight.copy_(w)
            lin.bias.copy_(b)

    def forward(self, numerical: torch.Tensor,
                categorical: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.hash_indices:
            categorical = torch.remainder(categorical, self.cardinalities[None, :])
        # int32 suffices: a joint table of Criteo-1TB's size is ~880M rows
        flat_idx = categorical.to(torch.int32) + self.offsets[None, :]
        if self.sharded:  # the rows this rank owns, then the sum of parts
            local = flat_idx - self.rows[0]
            mine = (local >= 0) & (local < self.rows[1] - self.rows[0])
            emb = sum_partials(embedding_lookup(
                self.embedding_table, local, cfg.embedding_grad, valid=mine),
                MODEL_AXIS)
        else:
            emb = embedding_lookup(self.embedding_table, flat_idx,
                                   cfg.embedding_grad)
        emb = emb.to(self.dtype)  # (B, 26, D)
        bottom = _mlp(numerical, self.bottom_mlp, self.dtype)  # (B, D)
        if cfg.interaction == "dot":
            inter = dot_interaction(bottom, emb)
        else:  # cat (the reference's CatInteraction)
            inter = torch.cat([bottom, emb.reshape(emb.shape[0], -1)], 1)
        logit = _mlp(inter, self.top_mlp, self.dtype, final_relu=False)
        return logit[:, 0].float()
