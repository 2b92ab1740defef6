"""LAMB optimizer (NVLAMB semantics) over a dict of tensors: the CLI default.

Port of ``deeplearningexamples_tpu/ops/lamb.py``. In JAX this is plain XLA,
not a Pallas kernel, so here it is plain PyTorch: ``torch._foreach_*`` ops over
the parameter list, a few launches per op instead of a few per tensor. The
math, per tensor::

    g = clip_by_global_norm(g)        (g / ||g||) * max_norm where ||g|| >= max_norm
    m = b1*m + (1-b1)*g,  v = b2*v + (1-b2)*g^2      fp32, stored in moment_dtype
    u = (m / c1) / (sqrt(v / c2) + eps) [+ wd * p]    from the STORED m and v
    ratio = ||p|| / ||u||  (1 where either is 0), only where use_nvlamb or wd
    p += lr(count) * (-ratio * u)

With ``zero`` (a ``parallel.zero.ZeroPlan``, ZeRO-1 over the data axis) the
moments of a sharded leaf hold this rank's rows only: m, v and u are computed
on them, ||p|| and ||u|| from the squares summed over the ranks' rows, and the
update's rows are gathered whole. The clip reads the whole gradient, which
every rank holds after the data axis's mean.

``lr`` is evaluated at the update count before this update (optax's
``scale_by_schedule``), where the flat path (``core/flat.py``) uses the count
after it: the two JAX paths disagree, and the port keeps both as they are.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

__all__ = ["LambState", "Transform", "global_norm", "lamb", "norms"]


class Transform(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``. With
    ``returns_new_params`` the update returns the new parameters (written in
    place) instead of deltas to add."""

    init: Callable
    update: Callable
    returns_new_params: bool = False


class LambState(NamedTuple):
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


_CPU_CHUNK = 1 << 16


def norms(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The L2 norm of each tensor, fp32 0-d tensors on its device.

    The CPU's fp32 reductions add long runs of elements one after another
    and drift with the size: at BERT-Large's widths the gradient norm came
    out 1.5e-4 apart from an H100's. So on the CPU each tensor is cut into
    chunks of 64K elements whose norms are combined in fp64."""
    if not tensors or tensors[0].device.type != "cpu":
        return list(torch._foreach_norm([t.float() for t in tensors]))
    out = []
    for t in tensors:
        parts = torch._foreach_norm([c.float() for c in
                                     t.reshape(-1).split(_CPU_CHUNK)])
        out.append(torch.linalg.vector_norm(torch.stack(parts).double()).float())
    return out


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(norms(tensors)))


def lamb(
    learning_rate: float | Callable[[int], float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    mask: Mapping[str, bool] | None = None,
    grad_clip_norm: float | None = 1.0,
    moment_dtype: torch.dtype = torch.float32,
    use_nvlamb: bool = False,
    zero=None,
) -> Transform:
    """NVLAMB: global-norm clip, LAMB trust-ratio update, lr. ``params`` and
    ``grads`` are dicts name -> tensor; ``mask`` is True where weight decay
    (and, with ``use_nvlamb=False``, the trust ratio) applies; ``zero`` a
    ``ZeroPlan`` that shards the moments (see the module docstring)."""
    local = zero.local if zero is not None else (lambda n, t: t)
    mark = zero.mark if zero is not None else (lambda n, t: t)

    def moments(params: Mapping[str, torch.Tensor]) -> dict:
        return {n: mark(n, torch.zeros_like(local(n, p), dtype=moment_dtype))
                for n, p in params.items()}

    def init(params: Mapping[str, torch.Tensor]) -> LambState:
        return LambState(0, moments(params), moments(params))

    def update(grads: Mapping[str, torch.Tensor], state: LambState,
               params: Mapping[str, torch.Tensor]):
        names = list(params)
        g = [grads[n].float() for n in names]
        if grad_clip_norm:
            # optax.clip_by_global_norm: (t / norm) * max_norm unless norm < max
            gnorm = global_norm(g)
            keep = gnorm < grad_clip_norm
            g = torch._foreach_mul(
                torch._foreach_div(g, torch.where(keep, 1.0, gnorm)),
                torch.where(keep, 1.0, torch.full_like(gnorm, grad_clip_norm)))
        count = state.count + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))

        g = [local(n, x) for n, x in zip(names, g)]
        m32 = torch._foreach_add(
            torch._foreach_mul([state.mu[n].float() for n in names], b1),
            torch._foreach_mul(g, 1 - b1))
        v32 = torch._foreach_add(
            torch._foreach_mul([state.nu[n].float() for n in names], b2),
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        mu = {n: mark(n, m.to(moment_dtype)) for n, m in zip(names, m32)}
        nu = {n: mark(n, v.to(moment_dtype)) for n, v in zip(names, v32)}

        # u from the stored (rounded) moments, as JAX's upd() upcasts them
        u = list(torch._foreach_div(
            torch._foreach_div([mu[n].float() for n in names], c1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div([nu[n].float() for n in names], c2)), eps)))
        p32 = [local(n, params[n]).float() for n in names]
        decays = [weight_decay if (weight_decay and (mask is None or mask[n]))
                  else 0.0 for n in names]
        dec = [i for i, wd in enumerate(decays) if wd]
        if dec:  # u + wd * p, one weight decay for every decayed tensor
            torch._foreach_add_([u[i] for i in dec], torch._foreach_mul(
                [p32[i] for i in dec], weight_decay))
        w_norm = norms(p32)
        u_norm = norms(u)
        if zero is not None and zero.rows:  # the leaf's norms from its rows'
            w_norm, u_norm = ([x.sqrt() for x in zero.sum_squares(
                names, [y * y for y in ys])] for ys in (w_norm, u_norm))
        one = torch.ones((), device=g[0].device)
        # multi_tensor_lamb.cu:276-283: the ratio only where use_nvlamb or wd
        neg_ratio = [
            -torch.where((w > 0) & (n > 0), w / n, one)
            if (use_nvlamb or wd) else -one
            for w, n, wd in zip(w_norm, u_norm, decays)]
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        upd = torch._foreach_mul(torch._foreach_mul(u, neg_ratio), lr)
        if zero is not None:
            upd = zero.gather(names, upd)
        updates = {n: x.to(params[n].dtype) for n, x in zip(names, upd)}
        return updates, LambState(count, mu, nu)

    return Transform(init, update)
