"""Port of ``deeplearningexamples_tpu/models/se3_transformer.py``: the
SE(3)-Transformer, equivariant attention over 3-D point graphs.

The reference (``DGLPyTorch/DrugDiscovery/SE3Transformer/se3_transformer/
model/``): ``ConvSE3`` and its ``RadialProfile`` (a TFN convolution: a
radial MLP of the invariant edge features weights the equivariant bases of
``ops/se3.py``), ``AttentionBlockSE3``, ``NormSE3``, ``LinearSE3``, and the
pooled QM9 regression (``SE3TransformerPooled``). JAX replaced DGL's sparse
message passing by dense all-pairs tensors over padded molecules with an
atom mask, and the port keeps that design and its numerics:

- flax's ``LayerNorm`` epsilon, 1e-6 (torch's default is 1e-5), in
  ``RadialProfile`` and ``NormSE3``;
- the edge feature ``dist = |rel + 1e-12|`` (the epsilon added to each
  component);
- the pair mask (both atoms real, no self-edge) multiplies the results
  after they are computed, so an inf or NaN on a masked pair still shows;
- attention: keys and queries flattened per head as ``(h, c / h, m)`` and
  concatenated in ``sorted(kq_fiber)`` order, logits filled with ``-1e9``
  off the pairs, the softmax then multiplied by the pair mask;
- max pooling fills the padded atoms with ``-inf``.

Fibers are dicts degree -> channels; features ``{str(d): (B, N, C, 2d +
1)}``. The module names are JAX's (``attn{i}.to_key_value.radial_{di}_{do}
.fc0``, ``norm{i}.ln{d}``, ``final_conv.self_int.w{d}``, ``mlp1``, ...);
``utils.jax_bridge.se3_state_dict_from_jax`` carries JAX's parameters over.
The model computes in fp32 whatever ``--amp`` says, as JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.se3 import degree_to_dim, se3_basis
from .convnets.layers import Dense
from .tts.layers import lecun_normal_

__all__ = ["AttentionBlockSE3", "ConvSE3", "LinearSE3", "NormSE3",
           "RadialProfile", "SE3Config", "SE3RegressionTask", "SE3Transformer",
           "SE3Trunk"]

Fiber = dict  # degree -> channels
LN_EPS = 1e-6  # flax's LayerNorm


@dataclass(frozen=True)
class SE3Config:
    """JAX's ``SE3Config`` (the reference's QM9 width)."""

    num_layers: int = 7
    num_degrees: int = 4  # degrees 0..3 (reference default)
    num_channels: int = 32
    num_heads: int = 8
    channels_div: int = 2
    node_feature_dim: int = 6  # QM9 one-hot species
    pooling: str = "max"  # max | avg
    out_dim: int = 1  # regression target

    @property
    def max_degree(self) -> int:
        return self.num_degrees - 1

    @property
    def fiber_hidden(self) -> Fiber:
        return {d: self.num_channels for d in range(self.num_degrees)}


def _pair_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, N, N): both atoms real and not a self-edge."""
    n = mask.shape[1]
    eye = torch.eye(n, dtype=mask.dtype, device=mask.device)
    return mask[:, :, None] * mask[:, None, :] * (1.0 - eye)[None]


class RadialProfile(nn.Module):
    """Invariant edge MLP -> radial weights (reference ``RadialProfile``:
    (Linear, LayerNorm, ReLU) x 2, then a bias-free output): edge features
    (..., E) -> (..., c_out, c_in * num_freq)."""

    def __init__(self, num_freq: int, cin: int, cout: int, edge_dim: int = 1,
                 mid: int = 32):
        super().__init__()
        self.shape = (cout, cin * num_freq)
        self.fc0 = Dense(edge_dim, mid)
        self.ln0 = nn.LayerNorm(mid, eps=LN_EPS)
        self.fc1 = Dense(mid, mid)
        self.ln1 = nn.LayerNorm(mid, eps=LN_EPS)
        self.out = Dense(mid, num_freq * cin * cout, bias=False)

    def forward(self, edge: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.ln0(self.fc0(edge)))
        h = F.relu(self.ln1(self.fc1(h)))
        h = self.out(h)
        return h.reshape(h.shape[:-1] + self.shape)


class LinearSE3(nn.Module):
    """Per-degree channel mixing (reference ``LinearSE3``): ``w{d}`` (c_out,
    c_in), ``out[d] = w{d} @ x[d]`` over the channels."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber):
        super().__init__()
        self.fiber_out = dict(fiber_out)
        for d, c in fiber_out.items():
            setattr(self, f"w{d}", nn.Parameter(torch.zeros(c, fiber_in[d])))

    def forward(self, feats: dict) -> dict:
        return {str(d): torch.einsum("oc,...cm->...om", getattr(self, f"w{d}"),
                                     feats[str(d)]) for d in self.fiber_out}


class ConvSE3(nn.Module):
    """TFN convolution fiber_in -> fiber_out over all-pairs edges: with
    ``pool`` node features (the mean over the incoming edges of each atom's
    pairs), else per-edge features (attention keys and values);
    ``self_interaction`` adds the reference's per-node linear term."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber, pool: bool = True,
                 self_interaction: bool = False):
        super().__init__()
        self.fiber_in, self.fiber_out = dict(fiber_in), dict(fiber_out)
        self.pool = pool
        for d_out, c_out in fiber_out.items():
            for d_in, c_in in fiber_in.items():
                setattr(self, f"radial_{d_in}_{d_out}", RadialProfile(
                    2 * min(d_in, d_out) + 1, c_in, c_out))
        self.self_int = LinearSE3(
            fiber_in, {d: c for d, c in fiber_out.items() if d in fiber_in}) \
            if self_interaction else None

    def forward(self, feats: dict, edge: torch.Tensor, basis: dict,
                mask: torch.Tensor) -> dict:
        # feats {str(d): (B, N, C, 2d+1)}; edge (B, N, N, E); basis
        # '{di},{do}' (B, N, N, 2di+1, F, 2do+1); mask (B, N). No self-edges:
        # a zero relative position has no direction
        pair = _pair_mask(mask)
        out = {}
        for d_out in self.fiber_out:
            acc = None
            for d_in, c_in in self.fiber_in.items():
                b = basis[f"{d_in},{d_out}"]
                radial = getattr(self, f"radial_{d_in}_{d_out}")(edge)
                # tmp[b,i,j,c,f,k] = sum_l x[b,j,c,l] basis[b,i,j,l,f,k]
                tmp = torch.einsum("bjcl,bijlfk->bijcfk", feats[str(d_in)], b)
                tmp = tmp.reshape(tmp.shape[:3] + (c_in * b.shape[-2],
                                                   tmp.shape[-1]))
                contrib = torch.einsum("bijop,bijpk->bijok", radial, tmp)
                acc = contrib if acc is None else acc + contrib
            acc = acc * pair[..., None, None]
            if self.pool:
                deg = pair.sum(2).clamp_min(1.0)
                acc = acc.sum(2) / deg[..., None, None]
            out[str(d_out)] = acc
        if self.self_int is not None:
            si = self.self_int(feats)
            for d in si:
                out[d] = out[d] + (si[d] if self.pool else si[d][:, :, None])
        return out


class NormSE3(nn.Module):
    """Norm nonlinearity (reference ``NormSE3``): LayerNorm + ReLU of each
    feature's norm, its direction kept; the norm is ``sqrt(|x|^2 +
    clamp^2)`` (smooth at the padded atoms' zero features)."""

    def __init__(self, fiber: Fiber, clamp: float = 2.0 ** -24):
        super().__init__()
        self.fiber, self.clamp = dict(fiber), clamp
        for d, c in fiber.items():
            setattr(self, f"ln{d}", nn.LayerNorm(c, eps=LN_EPS))

    def forward(self, feats: dict) -> dict:
        out = {}
        for d in self.fiber:
            x = feats[str(d)]
            norm = torch.sqrt((x * x).sum(-1, keepdim=True) + self.clamp ** 2)
            new = F.relu(getattr(self, f"ln{d}")(norm[..., 0]))[..., None]
            out[str(d)] = x / norm * new
        return out


class AttentionBlockSE3(nn.Module):
    """Equivariant multi-head attention block (reference
    ``AttentionBlockSE3``): keys and values from one unpooled TFN
    convolution, queries linear, invariant dot-product logits, per-degree
    weighted sums, the input concatenated back (``aggregate_residual``
    'cat') and projected."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber, num_heads: int,
                 channels_div: int):
        super().__init__()
        self.fiber_in, self.fiber_out = dict(fiber_in), dict(fiber_out)
        self.num_heads = num_heads
        self.value_fiber = {d: c // channels_div for d, c in fiber_out.items()}
        self.kq_fiber = {d: c for d, c in self.value_fiber.items()
                         if d in fiber_in}
        kv_fiber = {d: c + self.kq_fiber.get(d, 0)
                    for d, c in self.value_fiber.items()}
        self.to_key_value = ConvSE3(fiber_in, kv_fiber, pool=False)
        self.to_query = LinearSE3(fiber_in, self.kq_fiber)
        self.project = LinearSE3(
            {d: self.value_fiber[d] + fiber_in.get(d, 0) for d in fiber_out},
            fiber_out)

    def forward(self, feats: dict, edge: torch.Tensor, basis: dict,
                mask: torch.Tensor) -> dict:
        h = self.num_heads
        kv = self.to_key_value(feats, edge, basis, mask)
        key, value = {}, {}
        for d, c in self.value_fiber.items():
            e = kv[str(d)]
            if d in self.kq_fiber:
                value[str(d)], key[str(d)] = e[..., :c, :], e[..., c:, :]
            else:
                value[str(d)] = e
        query = self.to_query(feats)

        def heads(x):  # (..., C, m) -> (..., h, C/h * m)
            return x.reshape(x.shape[:-2] + (h, -1))

        k_flat = torch.cat([heads(key[str(d)]) for d in sorted(self.kq_fiber)],
                           -1)  # (B, N, N, h, D)
        q_flat = torch.cat([heads(query[str(d)]) for d in
                            sorted(self.kq_fiber)], -1)  # (B, N, h, D)
        n_feat = sum(c * degree_to_dim(d) for d, c in self.kq_fiber.items())
        logits = torch.einsum("bijhd,bihd->bijh", k_flat, q_flat) \
            / math.sqrt(n_feat)
        pair = _pair_mask(mask)[..., None]
        logits = torch.where(pair > 0, logits, -1e9)
        w = torch.softmax(logits, 2) * pair  # (B, N, N, h)

        cat = {}
        for d, c in self.value_fiber.items():
            v = value[str(d)]  # (B, N, N, c, m)
            v = v.reshape(v.shape[:3] + (h, c // h, v.shape[-1]))
            z = torch.einsum("bijh,bijhcm->bihcm", w, v)
            z = z.reshape(z.shape[:2] + (c, z.shape[-1]))
            parts = [z] + ([feats[str(d)]] if d in self.fiber_in else [])
            cat[str(d)] = torch.cat(parts, -2)
        return self.project(cat)


class SE3Trunk(nn.Module):
    """The reference ``SE3Transformer`` trunk (``model/transformer.py``):
    attention + norm layers, then a final self-interacting TFN convolution:
    ``forward(positions (B, N, 3), feats {str(d): (B, N, C, 2d+1)}, mask
    (B, N))`` -> per-node features ``{str(d): (B, N, C, 2d+1)}`` of
    ``fiber_out``. Its parameters sit at the top level (``attn{i}``,
    ``norm{i}``, ``final_conv``), as JAX's ``_run_trunk`` registers them."""

    def __init__(self, fiber_in: Fiber, fiber_hidden: Fiber, fiber_out: Fiber,
                 num_layers: int = 2, num_heads: int = 2,
                 channels_div: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.max_degree = max(*fiber_in, *fiber_hidden, *fiber_out)
        fiber = dict(fiber_in)
        for i in range(num_layers):
            setattr(self, f"attn{i}", AttentionBlockSE3(
                fiber, fiber_hidden, num_heads, channels_div))
            setattr(self, f"norm{i}", NormSE3(fiber_hidden))
            fiber = dict(fiber_hidden)
        self.final_conv = ConvSE3(fiber, fiber_out, pool=True,
                                  self_interaction=True)

    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal (truncated) kernels, fan in
        the input size (``w{d}``: its first axis, as flax reads a (c_out,
        c_in) kernel), zero biases, LayerNorms at 1 and 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if ".ln" in name or leaf == "bias":
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf == "weight":  # a Dense (out, in)
                    lecun_normal_(p, p.shape[1], generator)
                else:  # LinearSE3's w{d}
                    lecun_normal_(p, p.shape[0], generator)

    def forward(self, positions: torch.Tensor, feats: dict,
                mask: torch.Tensor) -> dict:
        rel = positions[:, :, None, :] - positions[:, None, :, :]
        dist = torch.linalg.vector_norm(rel + 1e-12, dim=-1, keepdim=True)
        basis = se3_basis(rel, self.max_degree)
        for i in range(self.num_layers):
            feats = getattr(self, f"attn{i}")(feats, dist, basis, mask)
            feats = getattr(self, f"norm{i}")(feats)
        return self.final_conv(feats, dist, basis, mask)


class SE3Transformer(SE3Trunk):
    """The trunk, pooling and an MLP head (reference
    ``SE3TransformerPooled`` for QM9 regression): ``forward(positions (B,
    N, 3), node_feats (B, N, F) invariant scalars, mask (B, N) 1 = real
    atom)`` -> (B, out_dim)."""

    def __init__(self, cfg: SE3Config = SE3Config()):
        out = cfg.num_degrees * cfg.num_channels
        super().__init__({0: cfg.node_feature_dim}, cfg.fiber_hidden, {0: out},
                         cfg.num_layers, cfg.num_heads, cfg.channels_div)
        self.cfg = cfg
        self.mlp1 = Dense(out, out)
        self.mlp2 = Dense(out, cfg.out_dim)

    def forward(self, positions: torch.Tensor, node_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        feats = super().forward(positions, {"0": node_feats[..., None]}, mask)
        scalars = feats["0"][..., 0]  # (B, N, C)
        if self.cfg.pooling == "max":
            pooled = torch.where(mask[..., None] > 0, scalars,
                                 -math.inf).amax(1)
        else:
            pooled = (scalars * mask[..., None]).sum(1) \
                / mask.sum(1).clamp_min(1.0)[..., None]
        return self.mlp2(F.relu(self.mlp1(pooled)))


@dataclass
class SE3RegressionTask:
    """QM9-style invariant regression in the train step's contract: a batch
    holds ``positions`` (B, N, 3), ``species`` (B, N, F) one-hot, ``mask``
    (B, N) and ``target`` (B,); the loss is the mean squared error, the
    metric ``mae``."""

    cfg: SE3Config = field(default_factory=SE3Config)

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> SE3Transformer:
        """A model with its initialisers drawn on the CPU from ``generator``,
        then placed on ``device``."""
        model = SE3Transformer(self.cfg)
        model.init_weights_(generator)
        return model.to(device).train()

    def loss_fn(self, model: SE3Transformer, model_state, batch: dict,
                generator: torch.Generator):
        pred = model(batch["positions"], batch["species"], batch["mask"])[:, 0]
        err = pred - batch["target"]
        return (err * err).mean(), (model_state,
                                    {"mae": err.abs().mean().detach()})
