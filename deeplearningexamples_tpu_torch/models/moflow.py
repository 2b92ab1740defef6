"""MoFlow: a normalizing-flow generative model of molecular graphs, in
PyTorch.

Port of ``deeplearningexamples_tpu/models/moflow.py`` (reference
``PyTorch/DrugDiscovery/MoFlow/moflow/model/``) with the reference's
``state_dict`` names, which ``utils/torch_import.convert_moflow`` in the
JAX package reads: ``bond_model.blocks.0.flows.{i}`` (``actnorm.loc``,
``actnorm.scale``, ``coupling.layers.{3j}`` convolutions and
``.{3j + 1}`` BNs, the output convolution last) and
``atom_model.blocks.0.flows.{i}`` (``actnorm``, ``coupling.net_conv.{k}``
with ``graph_conv.graph_linear_self``/``graph_linear_edge`` and ``bn``,
``coupling.net_lin.{k}`` with ``lin`` and ``bn``, the output Linear last),
and ``ln_var``.

- The bonds run NCHW: the adjacency (B, E, N, N) squeezes to (B, E f f,
  N / f, N / f), channel ``e f f + fh f + fw`` (the reference's order, and
  JAX's NHWC one); the couplings' halves alternate (``mask_swap``), without
  1x1 invertible convolutions (conv_lu 2).
- The atoms run (B, N, T); the ActNorm's channel is the node axis, as the
  coupling's BN's (over (B, d) per node row); flow ``i`` keeps row ``i % N``.
- The BNs are flax's: momentum 0.9, the biased running variance
  (``tts.layers.BatchNorm1d``, which serves any (B, C, ...) tensor); the
  inverse runs them on their running statistics.
- ActNorm starts at the identity (JAX's deviation from the reference's
  data-dependent init); the atom coupling's log-determinant counts only
  the rows it changes (JAX's deviation).
- fp32 throughout. The loss is the NLL in bits per dimension with a learned
  variance; the atom flow sees the clean adjacency, the bond flow the
  noised one. The dequantisation noise is drawn from the step's generator
  (``MoFlowTask.draws``; its bits cannot match ``jax.random``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import draw_rows
from .convnets.layers import Dense
from .tts.layers import BatchNorm1d, device_generator, lecun_normal_

__all__ = ["ActNorm", "AffineCoupling", "AtomFlow", "BondGlow",
           "GraphAffineCoupling", "GraphConv", "MoFlow", "MoFlowConfig",
           "MoFlowTask", "ZINC250K_CONFIG"]


@dataclass(frozen=True)
class MoFlowConfig:
    """The JAX ``MoFlowConfig`` (QM9-scale defaults)."""

    n_node: int = 9
    n_atom_types: int = 5  # with the dummy (padding) type
    n_bond_types: int = 4  # dummy, single, double, triple
    bond_n_flow: int = 10
    bond_squeeze: int = 3
    bond_hidden: tuple[int, ...] = (128, 128)
    atom_n_flow: int = 27
    atom_hidden_gnn: tuple[int, ...] = (64,)
    atom_hidden_lin: tuple[int, ...] = (128, 64)
    noise_scale: float = 0.6
    learn_dist: bool = True

    @property
    def b_size(self) -> int:
        return self.n_node * self.n_node * self.n_bond_types

    @property
    def a_size(self) -> int:
        return self.n_node * self.n_atom_types


# the reference's config.py ZINC250K_CONFIG: 40 nodes, 9 atom types and the
# dummy, 38 atom flows, 10 bond flows squeezed 20-fold
ZINC250K_CONFIG = MoFlowConfig(
    n_node=40, n_atom_types=10, n_bond_types=4,
    bond_n_flow=10, bond_squeeze=20, bond_hidden=(512, 512),
    atom_n_flow=38, atom_hidden_gnn=(256,), atom_hidden_lin=(512, 64),
)


def _sigmoid_inverse(x):
    """1 / sigmoid(x)."""
    return 1.0 + torch.exp(-x)


class ActNorm(nn.Module):
    """``scale * (x + loc)`` per channel (dim 1), log-determinant
    ``n_elements * sum(log |scale|)``; ``shape``: the parameters' shape,
    (1, C, 1, 1) or (1, C, 1)."""

    def __init__(self, shape: tuple[int, ...], n_elements: int):
        super().__init__()
        self.n_elements = n_elements
        self.loc = nn.Parameter(torch.zeros(shape))
        self.scale = nn.Parameter(torch.ones(shape))

    def forward(self, x):
        logdet = self.n_elements * torch.log(self.scale.abs()).sum()
        return self.scale * (x + self.loc), logdet

    def reverse(self, x):
        return x / self.scale - self.loc


class _Conv3x3(nn.Conv2d):
    """flax ``nn.Conv`` (3, 3) ``"SAME"`` with bias, lecun normal."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()


class AffineCoupling(nn.Module):
    """The bond coupling: a conv stack on one channel half predicts
    (s_logits, t) for the other; ``y_b = (x_b + t) * sigmoid(s_logits)``."""

    def __init__(self, channels: int, hidden: tuple[int, ...],
                 mask_swap: bool):
        super().__init__()
        self.mask_swap = mask_swap
        layers, cin = [], channels // 2
        for c in hidden:  # conv, BN, ReLU (no parameters)
            layers += [_Conv3x3(cin, c), BatchNorm1d(c), nn.ReLU()]
            cin = c
        layers.append(_Conv3x3(cin, channels))
        self.layers = nn.ModuleList(layers)

    def _s_t(self, xa, deterministic: bool):
        h = xa
        for m in self.layers:
            h = m(h, deterministic) if isinstance(m, BatchNorm1d) else m(h)
        return h.chunk(2, 1)

    def _halves(self, x):
        xa, xb = x.chunk(2, 1)
        return (xb, xa) if self.mask_swap else (xa, xb)

    def _join(self, xa, yb):
        return torch.cat((yb, xa) if self.mask_swap else (xa, yb), 1)

    def forward(self, x):
        xa, xb = self._halves(x)
        s_logits, t = self._s_t(xa, False)
        yb = (xb + t) * torch.sigmoid(s_logits)
        logdet = F.logsigmoid(s_logits).sum((1, 2, 3))
        return self._join(xa, yb), logdet

    def reverse(self, x):
        xa, xb = self._halves(x)
        s_logits, t = self._s_t(xa, True)
        return self._join(xa, xb * _sigmoid_inverse(s_logits) - t)


class _Flow(nn.Module):
    def __init__(self, actnorm: ActNorm, coupling: nn.Module):
        super().__init__()
        self.actnorm, self.coupling = actnorm, coupling


def _blocks(flows: list[_Flow]) -> nn.ModuleList:
    """The reference's ``blocks.0.flows`` nesting."""
    block = nn.Module()
    block.flows = nn.ModuleList(flows)
    return nn.ModuleList([block])


class BondGlow(nn.Module):
    """Squeeze, ``bond_n_flow`` x (ActNorm, coupling), unsqueeze, over the
    adjacency (B, E, N, N)."""

    def __init__(self, cfg: MoFlowConfig):
        super().__init__()
        self.cfg = cfg
        f, n = cfg.bond_squeeze, cfg.n_node
        ch = cfg.n_bond_types * f * f
        self.blocks = _blocks([
            _Flow(ActNorm((1, ch, 1, 1), (n // f) ** 2),
                  AffineCoupling(ch, tuple(cfg.bond_hidden), bool(i % 2)))
            for i in range(cfg.bond_n_flow)])

    @property
    def flows(self):
        return self.blocks[0].flows

    def _squeeze(self, adj):
        b, e, n, _ = adj.shape
        f = self.cfg.bond_squeeze
        x = adj.reshape(b, e, n // f, f, n // f, f).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, e * f * f, n // f, n // f)

    def _unsqueeze(self, x):
        b, _, m, _ = x.shape
        f, e = self.cfg.bond_squeeze, self.cfg.n_bond_types
        x = x.reshape(b, e, f, f, m, m).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, e, m * f, m * f)

    def forward(self, adj):
        """-> (z (B, E, N, N), log-determinant (B,))."""
        x, logdet = self._squeeze(adj), 0.0
        for flow in self.flows:
            x, d1 = flow.actnorm(x)
            x, d2 = flow.coupling(x)
            logdet = logdet + d1 + d2
        return self._unsqueeze(x), logdet

    def reverse(self, z):
        x = self._squeeze(z)
        for flow in reversed(self.flows):
            x = flow.actnorm.reverse(flow.coupling.reverse(x))
        return self._unsqueeze(x)


class GraphConv(nn.Module):
    """Relational graph convolution: ``h = W_self x + sum_e A_e W_e x``; the
    edge Linear's outputs are ordered ``c * n_edge + e``."""

    def __init__(self, cin: int, out: int, n_edge: int):
        super().__init__()
        self.out, self.n_edge = out, n_edge
        self.graph_linear_self = Dense(cin, out)
        self.graph_linear_edge = Dense(cin, out * n_edge)

    def forward(self, adj, nodes):
        """adj (B, E, N, N), nodes (B, N, C) -> (B, N, out)."""
        b, n, _ = nodes.shape
        m = self.graph_linear_edge(nodes).reshape(b, n, self.out, self.n_edge)
        hr = torch.einsum("bemn,bnce->bmc", adj, m)
        return self.graph_linear_self(nodes) + hr


class _GnnLayer(nn.Module):
    def __init__(self, cin: int, out: int, cfg: MoFlowConfig):
        super().__init__()
        self.graph_conv = GraphConv(cin, out, cfg.n_bond_types)
        self.bn = BatchNorm1d(cfg.n_node)


class _LinLayer(nn.Module):
    def __init__(self, cin: int, out: int, cfg: MoFlowConfig):
        super().__init__()
        self.lin = Dense(cin, out)
        self.bn = BatchNorm1d(cfg.n_node)


class GraphAffineCoupling(nn.Module):
    """The atom coupling: rows ``masked_rows`` stay as they are and drive
    (s, t) of the others through GraphConvs and Linears, each followed by a
    BN per node row and ReLU."""

    def __init__(self, cfg: MoFlowConfig, masked_rows: tuple[int, ...]):
        super().__init__()
        self.cfg = cfg
        mask = torch.ones(cfg.n_node, 1)
        mask[list(masked_rows)] = 0.0
        self.register_buffer("mask", mask, persistent=False)
        dims = [cfg.n_atom_types, *cfg.atom_hidden_gnn]
        self.net_conv = nn.ModuleList([_GnnLayer(a, b, cfg)
                                       for a, b in zip(dims[:-1], dims[1:])])
        dims = [dims[-1], *cfg.atom_hidden_lin]
        self.net_lin = nn.ModuleList(
            [*(_LinLayer(a, b, cfg) for a, b in zip(dims[:-1], dims[1:])),
             Dense(dims[-1], 2 * cfg.n_atom_types)])

    def _s_t(self, adj, h, deterministic: bool):
        for layer in self.net_conv:
            h = torch.relu(layer.bn(layer.graph_conv(adj, h), deterministic))
        for layer in self.net_lin[:-1]:
            h = torch.relu(layer.bn(layer.lin(h), deterministic))
        return self.net_lin[-1](h).chunk(2, -1)

    def forward(self, adj, x):
        masked_x = self.mask * x
        s_logits, t = self._s_t(adj, masked_x, False)
        out = masked_x + (1 - self.mask) * (x + t) * torch.sigmoid(s_logits)
        logdet = (F.logsigmoid(s_logits) * (1 - self.mask)).sum((1, 2))
        return out, logdet

    def reverse(self, adj, x):
        masked_x = self.mask * x
        s_logits, t = self._s_t(adj, masked_x, True)
        return masked_x + (1 - self.mask) * (x * _sigmoid_inverse(s_logits) - t)


class AtomFlow(nn.Module):
    """``atom_n_flow`` x (ActNorm over the node rows, masked-row coupling)
    over the atoms (B, N, T), conditioned on the adjacency."""

    def __init__(self, cfg: MoFlowConfig):
        super().__init__()
        self.blocks = _blocks([
            _Flow(ActNorm((1, cfg.n_node, 1), cfg.n_atom_types),
                  GraphAffineCoupling(cfg, (i % cfg.n_node,)))
            for i in range(cfg.atom_n_flow)])

    @property
    def flows(self):
        return self.blocks[0].flows

    def forward(self, adj, x):
        logdet = 0.0
        for flow in self.flows:
            x, d1 = flow.actnorm(x)
            x, d2 = flow.coupling(adj, x)
            logdet = logdet + d1 + d2
        return x, logdet

    def reverse(self, adj, z):
        for flow in reversed(self.flows):
            z = flow.actnorm.reverse(flow.coupling.reverse(adj, z))
        return z


class MoFlow(nn.Module):
    """The bond Glow (``bond_model``), the atom flow (``atom_model``) and,
    with ``learn_dist``, the latent's log-variance ``ln_var``."""

    def __init__(self, cfg: MoFlowConfig = MoFlowConfig()):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.float32
        self.bond_model = BondGlow(cfg)
        self.atom_model = AtomFlow(cfg)
        if cfg.learn_dist:
            self.ln_var = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero biases, unit BNs,
        ActNorm at the identity, ``ln_var`` 0."""
        for m in self.modules():
            if isinstance(m, (_Conv3x3, Dense, BatchNorm1d)):
                m.init_(generator)
            elif isinstance(m, ActNorm):
                m.loc.zero_()
                m.scale.fill_(1.0)
        if self.cfg.learn_dist:
            self.ln_var.zero_()

    def forward(self, adj, x):
        """adj (B, E, N, N) one-hot bonds, x (B, N, T) atoms -> (z_x,
        z_adj, logdet_x, logdet_adj); the atom flow sees ``adj``."""
        z_x, logdet_x = self.atom_model(adj, x)
        z_adj, logdet_adj = self.bond_model(adj)
        return z_x, z_adj, logdet_x, logdet_adj

    @torch.no_grad()
    def reverse(self, z):
        """Latents (B, a_size + b_size), the bonds' part in JAX's (N, N, E)
        order -> (adj (B, E, N, N) one-hot, x (B, N, T)): the bonds decoded,
        symmetrised, one-hot by argmax over the types, then the atoms
        decoded on them."""
        cfg = self.cfg
        b, n = z.shape[0], cfg.n_node
        z_x = z[:, :cfg.a_size].reshape(b, n, cfg.n_atom_types)
        z_adj = z[:, cfg.a_size:].reshape(b, n, n, cfg.n_bond_types)
        adj = self.bond_model.reverse(z_adj.permute(0, 3, 1, 2))
        adj = torch.softmax((adj + adj.transpose(2, 3)) / 2, 1)
        adj = F.one_hot(adj.argmax(1), cfg.n_bond_types).permute(
            0, 3, 1, 2).to(z.dtype)
        return adj, self.atom_model.reverse(adj, z_x)


@dataclass
class MoFlowTask:
    """A batch holds ``atoms`` (B, N, T) and ``adj`` (B, E, N, N), one-hot."""

    cfg: MoFlowConfig = field(default_factory=MoFlowConfig)
    dtype: torch.dtype = torch.float32  # flows stay fp32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> MoFlow:
        model = MoFlow(self.cfg)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        """The BN running statistics, by their ``state_dict`` names."""
        return {n: b for n, b in model.named_buffers() if ".running_" in n}

    def draws(self, generator: torch.Generator, batch: dict) -> dict:
        """The dequantisation noise: U(0, 1) of the atoms' and the
        adjacency's shapes, on their device, from ``generator``."""
        gen = device_generator(generator, batch["atoms"].device)
        # under a data axis each at the global batch's rows, of which this
        # rank keeps its own
        return {k: draw_rows(lambda rows, x=batch[k]: torch.rand(
                    (rows, *x.shape[1:]), generator=gen, device=x.device,
                    dtype=x.dtype), batch[k].shape[0])
                for k in ("atoms", "adj")}

    def loss_fn(self, model: MoFlow, model_state, batch: dict,
                generator: torch.Generator):
        """The NLL in bits per dimension of the atoms and of the bonds (the
        reference's ``MoFlowLoss``)."""
        cfg = self.cfg
        u = self.draws(generator, batch)
        x = batch["atoms"] + u["atoms"] * cfg.noise_scale
        adj_noised = batch["adj"] + u["adj"] * cfg.noise_scale
        z_x, logdet_x = model.atom_model(batch["adj"], x)
        z_adj, logdet_adj = model.bond_model(adj_noised)
        ln_var = model.ln_var[0] if cfg.learn_dist else \
            torch.zeros((), device=x.device)
        ln2 = math.log(2.0)

        def nll(z, logdet, size):
            z = z.reshape(z.shape[0], -1)
            gauss = 0.5 * (ln_var + math.log(2 * math.pi)
                           + z * z * torch.exp(-ln_var))
            return (gauss.sum(1) - (logdet - size * ln2)).mean() / (size * ln2)

        nll_x = nll(z_x, logdet_x, cfg.a_size)
        nll_adj = nll(z_adj, logdet_adj, cfg.b_size)
        return nll_x + nll_adj, (model_state, {"nll_x": nll_x.detach(),
                                               "nll_adj": nll_adj.detach()})

    @torch.no_grad()
    def generate(self, model: MoFlow, model_state, generator: torch.Generator,
                 n: int, temp: float = 0.7):
        """Latents N(0, temp^2) decoded to ``n`` molecules (reference
        ``runtime/generate.py``): (adj, atoms)."""
        device = next(model.parameters()).device
        gen = device_generator(generator, device)
        z = torch.randn(n, self.cfg.a_size + self.cfg.b_size, generator=gen,
                        device=device) * temp
        return model.reverse(z)
