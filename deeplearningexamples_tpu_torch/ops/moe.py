"""Mixture-of-Experts feed-forward layer, with expert parallelism over the
mesh's ``model`` axis.

Port of ``deeplearningexamples_tpu/ops/moe.py``, from its code. Dispatch and
combine are dense einsums over a one-hot routing tensor of static capacity
(the Switch Transformer formulation):

- the router is an fp32 linear map without bias; its softmax over the
  experts gives each token's probabilities;
- ``router_top_k`` passes each take a token's best remaining expert (ties go
  to the first maximum); with k = 1 the gate is that probability, with
  k >= 2 the chosen gates are renormalised over their sum. ``router_top_k``
  is not validated, as in JAX;
- each expert has ``max(int(ceil(T / E) * capacity_factor * k), 1)`` slots;
  slots are given pass by pass (every first choice before any second) in
  token order, through an exclusive cumulative sum; an assignment past the
  capacity is dropped;
- the auxiliary load-balance loss is ``E * sum_e fraction(e) *
  mean_prob(e)`` over the first choices, before the capacity drop;
- routing is per batch row (JAX's ``vmap``), the experts' FFN is
  ``gelu_tanh(x @ wi) @ wo`` in fp32 (``jax.nn.gelu`` defaults to the tanh
  approximation), and the layer returns ``(y in x's dtype, the rows' mean
  aux)``. A float64 input and layer compute in float64 throughout (a
  reference on the CPU).

Expert parallelism: on a mesh whose ``model`` axis has n ranks, each rank
holds the contiguous block of E / n experts at its index (JAX's
``P("model")`` on the experts' axis; the parameters are marked sharded, so a
checkpoint gathers them whole). The router and the routing are replicated.
Where JAX leaves the collectives to GSPMD, the port writes them and their
transposes out: the experts' partial outputs are summed over the line
(``sum_partials``: every rank then consumes the sum alike), and the tokens
and gates that enter the rank's experts pass ``sum_cotangents``, whose
backward sums their partial cotangents over the line in one collective.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import (MODEL_AXIS, current_mesh, mark_sharded,
                             rank_rows, sum_cotangents, sum_partials)

__all__ = ["MoEConfig", "MoEFeedForward", "capacity", "moe_reference"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 256
    num_experts: int = 8
    capacity_factor: float = 1.25
    router_top_k: int = 1  # 1 = Switch, 2 = GShard-style top-2


def capacity(cfg: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: JAX's ``max(int(ceil(t / E) *
    capacity_factor * k), 1)``."""
    return max(int(-(-t // cfg.num_experts) * cfg.capacity_factor
                   * cfg.router_top_k), 1)


def _route_topk(logits: torch.Tensor, capacity: int, k: int):
    """logits (..., T, E) fp32 -> dispatch (..., T, E, C) one-hot, combine
    (..., T, E, C) gate-weighted, aux (...). Routing is along T within each
    leading index. ``k = 1`` is Switch top-1 (gate = the probability)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    masked = probs
    onehots, raw_gates = [], []
    for _ in range(k):
        expert = masked.argmax(dim=-1)  # the first maximum
        oh = F.one_hot(expert, e).to(logits.dtype)
        onehots.append(oh)
        raw_gates.append((probs * oh).sum(dim=-1))
        masked = masked * (1.0 - oh)
    if k == 1:
        gates = raw_gates
    else:
        denom = sum(raw_gates)
        gates = [g / denom.clamp(min=1e-9) for g in raw_gates]
    slots = torch.arange(capacity, device=logits.device, dtype=logits.dtype)
    dispatch = combine = 0.0
    # pass by pass: all j-th choices take their slots before any (j+1)-th;
    # a dropped assignment's expert is already full, so counting it too in
    # the offset leaves later positions past the capacity either way
    prior = logits.new_zeros(logits.shape[:-2] + (e,))
    for oh, gate in zip(onehots, gates):
        pos = oh.cumsum(dim=-2) - oh + prior[..., None, :]
        pos_in_expert = (pos * oh).sum(dim=-1)  # (..., T)
        keep = (pos_in_expert < capacity).to(oh.dtype)
        slot = (pos_in_expert[..., None] == slots).to(oh.dtype)  # zeros past C
        d = (oh * keep[..., None])[..., None] * slot[..., None, :]
        dispatch = dispatch + d
        combine = combine + d * gate[..., None, None]
        prior = prior + oh.sum(dim=-2)
    # Switch's load-balance loss on the first choices, differentiable
    # through the mean probabilities only
    aux = e * (onehots[0].mean(dim=-2) * probs.mean(dim=-2)).sum(dim=-1)
    return dispatch, combine, aux


def _route_top1(logits: torch.Tensor, capacity: int):
    """Switch top-1 routing (``_route_topk`` with k = 1)."""
    return _route_topk(logits, capacity, 1)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(torch.nn.init.trunc_normal_(
            torch.empty(t.shape, dtype=t.dtype), 0.0, 1.0, -2.0, 2.0,
            generator=generator) * std)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class MoEFeedForward(nn.Module):
    """(..., T, d_model) -> ((..., T, d_model), aux): the FFN block with
    ``cfg.num_experts`` experts. On a mesh whose model axis has n ranks (the
    current mesh at construction) this rank holds experts ``[lo, hi)`` =
    ``rank_rows(E, "model")`` in ``wi`` (E / n, d, f) and ``wo`` (E / n, f,
    d); ``router.weight`` is (E, d), JAX's ``router/kernel`` transposed.
    ``generator`` draws the initial weights."""

    def __init__(self, cfg: MoEConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh = current_mesh()
        n = mesh.size(MODEL_AXIS)
        if cfg.num_experts % n:
            raise ValueError(f"{cfg.num_experts} experts do not split over "
                             f"{MODEL_AXIS}={n}")
        self.lo, self.hi = rank_rows(cfg.num_experts, MODEL_AXIS)
        local = self.hi - self.lo
        self.router = nn.Linear(cfg.d_model, cfg.num_experts, bias=False)
        self.wi = nn.Parameter(torch.empty(local, cfg.d_model, cfg.d_ff))
        self.wo = nn.Parameter(torch.empty(local, cfg.d_ff, cfg.d_model))
        if n > 1:
            mark_sharded(self.wi, MODEL_AXIS, cfg.num_experts)
            mark_sharded(self.wo, MODEL_AXIS, cfg.num_experts)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """JAX's initialisers (lecun_normal) drawn for all E experts, of
        which this rank keeps its block, so that one seed gives one layer
        on any mesh."""
        cfg = self.cfg
        _lecun_normal_(self.router.weight, cfg.d_model, generator)
        for p, shape, fan_in in (
                (self.wi, (cfg.num_experts, cfg.d_model, cfg.d_ff), cfg.d_model),
                (self.wo, (cfg.num_experts, cfg.d_ff, cfg.d_model), cfg.d_ff)):
            whole = torch.empty(shape)
            _lecun_normal_(whole, fan_in, generator)
            with torch.no_grad():
                p.copy_(whole[self.lo:self.hi])

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        lead, (t, d) = x.shape[:-2], x.shape[-2:]
        acc = torch.promote_types(x.dtype, torch.float32)
        tokens = x.reshape(-1, t, d).to(acc)  # (N, T, D), one routing a row
        logits = tokens @ self.router.weight.to(acc).t()
        dispatch, combine, aux = _route_topk(logits, capacity(cfg, t),
                                             cfg.router_top_k)
        # the tokens and gates into this rank's experts: their cotangents
        # are partial and summed over the line
        tokens_in, combine = sum_cotangents((tokens, combine), MODEL_AXIS,
                                            self.mesh)
        dispatch = dispatch[:, :, self.lo:self.hi]
        combine = combine[:, :, self.lo:self.hi]
        xe = torch.einsum("ntec,ntd->necd", dispatch, tokens_in)
        h = _gelu(torch.einsum("necd,edf->necf", xe, self.wi.to(acc)))
        ye = torch.einsum("necf,efd->necd", h, self.wo.to(acc))
        y = torch.einsum("ntec,necd->ntd", combine, ye)
        y = sum_partials(y, MODEL_AXIS, self.mesh)
        return y.to(x.dtype).reshape(*lead, t, d), aux.mean()


@torch.no_grad()
def moe_reference(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: MoEConfig) -> torch.Tensor:
    """The oracle: each row's tokens routed by the same top-k and capacity
    rule, worked out token by token on the host, then each kept token run
    through its experts' FFN directly (no dispatch einsums). ``params``
    holds all E experts under the layer's names (``router.weight``, ``wi``,
    ``wo``)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    wi, wo = params["wi"].to(acc), params["wo"].to(acc)
    wg = params["router.weight"].to(acc)
    lead, (t, d) = x.shape[:-2], x.shape[-2:]
    k, e_n, cap = cfg.router_top_k, cfg.num_experts, capacity(cfg, t)
    out = []
    for xb in x.reshape(-1, t, d).to(acc):
        probs = torch.softmax(xb @ wg.t(), dim=-1).cpu()
        masked = probs.clone()
        choices, raw = [], []
        for _ in range(k):
            e_i = masked.argmax(dim=-1)
            choices.append(e_i.tolist())
            raw.append(probs[torch.arange(t), e_i].tolist())
            masked = masked * (1.0 - F.one_hot(e_i, e_n).to(masked.dtype))
        gates = raw if k == 1 else [
            [raw[j][i] / max(sum(raw[jj][i] for jj in range(k)), 1e-9)
             for i in range(t)] for j in range(k)]
        rows = torch.zeros(t, d, dtype=acc, device=x.device)
        counts: dict[int, int] = {}
        for j in range(k):  # all first choices take slots before any second
            for i in range(t):
                e = choices[j][i]
                pos = counts.get(e, 0)
                counts[e] = pos + 1
                if pos < cap:
                    rows[i] += (_gelu(xb[i] @ wi[e]) @ wo[e]) * gates[j][i]
        out.append(rows)
    return torch.stack(out).reshape(*lead, t, d).to(x.dtype)
