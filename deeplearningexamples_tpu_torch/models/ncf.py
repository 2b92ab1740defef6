"""NCF: neural collaborative filtering (NeuMF), in PyTorch.

Port of ``deeplearningexamples_tpu/models/ncf.py`` (reference
``PyTorch/Recommendation/NCF/neumf.py``) with the reference's ``state_dict``
names, which ``utils/torch_import.convert_ncf`` in the JAX package reads:
``mf_user_embed``, ``mf_item_embed``, ``mlp_user_embed``,
``mlp_item_embed``, ``mlp.{i}`` and ``final``.

- The GMF branch multiplies the user's and the item's embeddings; the MLP
  branch concatenates the other two and runs the pyramid, ReLU then dropout
  after every layer (``neumf.py:91-92``); the final Linear reads both in
  fp32 and gives one logit a pair.
- Tables and weights are fp32 and cast to the compute dtype at each call,
  as flax's ``nn.Embed`` and ``nn.Dense`` do.
- Evaluation is the reference's leave-one-out protocol: each positive
  ranked against sampled negatives, HR@K and NDCG@K (``hit_rate_ndcg``).

Dropout is ``ops.dropout.RegenDropout`` (its bits cannot match
``jax.random``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import RegenDropout
from .convnets.layers import Dense
from .tts.layers import acc_dtype

__all__ = ["NcfConfig", "NcfTask", "NeuMF", "hit_rate_ndcg"]


@dataclass(frozen=True)
class NcfConfig:
    """The JAX ``NcfConfig``: ML-20M's users and items."""

    nb_users: int = 138493
    nb_items: int = 26744
    mf_dim: int = 64
    mlp_layer_sizes: tuple[int, ...] = (256, 256, 128, 64)
    dropout: float = 0.5


class NeuMF(nn.Module):
    """(users (B,), items (B,)) int -> logits (B,) fp32."""

    def __init__(self, cfg: NcfConfig = NcfConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        half = cfg.mlp_layer_sizes[0] // 2
        self.mf_user_embed = nn.Embedding(cfg.nb_users, cfg.mf_dim)
        self.mf_item_embed = nn.Embedding(cfg.nb_items, cfg.mf_dim)
        self.mlp_user_embed = nn.Embedding(cfg.nb_users, half)
        self.mlp_item_embed = nn.Embedding(cfg.nb_items, half)
        sizes = cfg.mlp_layer_sizes
        self.mlp = nn.ModuleList([Dense(a, b, dtype)
                                  for a, b in zip(sizes[:-1], sizes[1:])])
        self.final = Dense(cfg.mf_dim + sizes[-1], 1, acc_dtype(dtype))
        self.drop = RegenDropout(cfg.dropout)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: tables N(0, 0.01), the MLP glorot uniform,
        the final layer lecun normal, zero biases."""
        for emb in (self.mf_user_embed, self.mf_item_embed,
                    self.mlp_user_embed, self.mlp_item_embed):
            emb.weight.copy_(torch.randn(emb.weight.shape,
                                         generator=generator) * 0.01)
        for lin in self.mlp:
            fan_out, fan_in = lin.weight.shape
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            lin.weight.copy_(torch.empty(lin.weight.shape).uniform_(
                -lim, lim, generator=generator))
            lin.bias.zero_()
        self.final.init_(generator)

    def forward(self, users, items, generator: torch.Generator | None = None):
        def embed(table: nn.Embedding, ids):
            return F.embedding(ids, table.weight).to(self.dtype)

        gmf = embed(self.mf_user_embed, users) * embed(self.mf_item_embed, items)
        x = torch.cat([embed(self.mlp_user_embed, users),
                       embed(self.mlp_item_embed, items)], -1)
        for lin in self.mlp:
            x = self.drop(torch.relu(lin(x)), generator)
        x = torch.cat([gmf, x], -1)
        return self.final(x.to(self.final.dtype))[..., 0]


def hit_rate_ndcg(scores: torch.Tensor, k: int = 10
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (B, 1 + n_neg), column 0 the positive item -> the means of
    HR@k and NDCG@k (the reference's ``val_epoch`` metrics); a negative
    that ties the positive ranks above it."""
    rank = (scores[:, 1:] >= scores[:, :1]).sum(1)  # 0 = top
    hit = rank < k
    ndcg = torch.where(hit, 1.0 / torch.log2(rank.float() + 2.0),
                       torch.zeros((), device=scores.device))
    return hit.float().mean(), ndcg.mean()


@dataclass
class NcfTask:
    """A training batch holds ``user`` and ``item`` (B,) int and ``label``
    (B,) fp32 in {0, 1}; an eval batch ``user`` (B,), ``pos_item`` (B,) and
    ``neg_items`` (B, N)."""

    cfg: NcfConfig = NcfConfig()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> NeuMF:
        model = NeuMF(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def loss_fn(self, model: NeuMF, model_state, batch: dict,
                generator: torch.Generator):
        """The mean sigmoid cross-entropy of the logits
        (``optax.sigmoid_binary_cross_entropy``)."""
        logits = model(batch["user"], batch["item"], generator)
        loss = F.binary_cross_entropy_with_logits(
            logits, batch["label"].to(logits.dtype))
        return loss, (model_state, {})

    @torch.no_grad()
    def metric_fn(self, model: NeuMF, model_state, batch: dict) -> dict:
        items = torch.cat([batch["pos_item"][:, None], batch["neg_items"]], 1)
        users = batch["user"][:, None].expand_as(items)
        scores = model(users.reshape(-1), items.reshape(-1)).reshape(
            items.shape)
        hr, ndcg = hit_rate_ndcg(scores)
        return {"hr@10": hr, "ndcg@10": ndcg}
