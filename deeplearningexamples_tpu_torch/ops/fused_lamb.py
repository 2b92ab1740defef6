"""Fused LAMB over a flat buffer packed from a dict of tensors on every step.

Port of ``deeplearningexamples_tpu/ops/fused_lamb.py``: ``FlatLayout``,
``make_layout``, ``pack``, ``unpack`` and the ``fused_lamb`` transform. Each
step packs the gradients and the parameters into fp32 buffers whose leaves
start on blocks of ``BLOCK`` = 8 x 1024 elements, runs the two LAMB passes
over them with fp32 moments, and returns the deltas ``new - old`` in each
parameter's dtype, for ``core/train.make_train_step`` to add (JAX's
``optax.apply_updates``; adding a delta can land an ulp away from writing the
new value, in JAX as here).

The passes, on CUDA buffers: K3 (``core/flat.py``'s ``flat_lamb_moments`` and
``flat_lamb_apply``, ``csrc/flat_lamb.cu``) at 8 x 1024-element blocks, which
replaces the TPU kernels ``_update_kernel`` and ``_apply_kernel``. K3's
second pass recomputes u from the stored fp32 moments with the same
operations as the first, so it writes the same new parameters as JAX's pair,
which stores u between its passes, with 8 bytes an element less traffic. On
CPU buffers: ``_update_plain`` and ``_apply_plain``, JAX's two kernels as
written (u written, then read). ``core/flat.py``'s launch counts count K3's
launches from either path.

Leaves are laid out in the order ``jax.tree_util.tree_flatten`` visits the
nested dict whose key paths are the dotted names (keys sorted at every
level), unless an ``order`` is given (``bert_pretrain_jax_order`` for the
port's BERT names), so the buffers equal JAX's element for element.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..core import flat
from ..core.flat import FlatLayout
from .lamb import Transform

__all__ = ["BLOCK", "FlatLayout", "FusedLambState", "fused_lamb",
           "make_layout", "pack", "tree_order", "unpack"]

BLOCK = 8 * 1024  # fp32 elements per block, JAX's (8, 1024) tile
LANES = 1024


def tree_order(names) -> list[str]:
    """``names`` in ``jax.tree_util.tree_flatten``'s order of the nested
    dict whose key paths are the dotted names."""
    return sorted(names, key=lambda n: n.split("."))


def make_layout(params: Mapping[str, torch.Tensor],
                order: Sequence[str] | None = None) -> FlatLayout:
    """The buffer layout of ``params`` (name -> tensor) in 8 x 1024 blocks."""
    names = list(order) if order is not None else tree_order(params)
    if sorted(names) != sorted(params):
        raise ValueError("order must name every tensor once")
    return flat.make_layout_blocked(
        [(n, tuple(params[n].shape)) for n in names], BLOCK)


def pack(layout: FlatLayout, tree: Mapping[str, torch.Tensor],
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """name -> tensor into one (total,) buffer, the padding zeros."""
    first = tree[layout.names[0]]
    out = torch.zeros(layout.total, dtype=dtype, device=first.device)
    for name, start, size in zip(layout.names, layout.starts, layout.sizes):
        out[int(start):int(start) + int(size)].copy_(tree[name].reshape(-1))
    return out


def unpack(layout: FlatLayout, buf: torch.Tensor,
           like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The named tensors of ``buf``, each in ``like``'s dtype (views where
    the dtype is the buffer's)."""
    view = buf.view(-1)
    return {n: view[int(s):int(s) + int(z)].view(shape).to(like[n].dtype)
            for n, s, z, shape in zip(layout.names, layout.starts,
                                      layout.sizes, layout.shapes)}


# ---------------------------------------------------------------------------
# Plain versions of JAX's two kernels, as written
# ---------------------------------------------------------------------------


def _update_plain(g, p, m, v, seg_ids, wd_leaf, hyp):
    """``_update_kernel``: (total,) fp32 g, p, m, v; hyp (b1, b2, eps,
    1 - b1^t, 1 - b2^t) -> new m, v, u and the per-leaf sums of p^2 and
    u^2."""
    b1, b2, eps, c1, c2 = hyp.unbind()
    nb = seg_ids.numel()
    seg = seg_ids.long()
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    u = ((m / c1) / (torch.sqrt(v / c2) + eps)).view(nb, -1) \
        + wd_leaf[seg].view(nb, 1) * p.view(nb, -1)
    sums = torch.zeros((wd_leaf.numel(), 2), dtype=torch.float32,
                       device=p.device)
    sums.index_add_(0, seg, torch.stack(
        [(p * p).view(nb, -1).sum(1), (u * u).sum(1)], 1))
    return m, v, u.view(-1), sums[:, 0], sums[:, 1]


def _apply_plain(p, u, seg_ids, scale_leaf):
    """``_apply_kernel``: p - scale_leaf[leaf] * u."""
    nb = seg_ids.numel()
    return (p.view(nb, -1)
            - scale_leaf[seg_ids.long()].view(nb, 1) * u.view(nb, -1)).view(-1)


def passes_plain(flat_g, flat_p, m, v, seg, wd, hyp, lr, index) -> None:
    """JAX's pair on (rows, 1024) buffers: the clip factor hyp[5] applied to
    g first, u written between the passes, the per-leaf sums taken as it
    goes (``index``, K3's order of the sums, is not needed). Writes p, m, v
    in place."""
    m_new, v_new, u, w_sq, u_sq = _update_plain(
        (flat_g * hyp[5]).view(-1), flat_p.view(-1), m.view(-1), v.view(-1),
        seg, wd, hyp[:5])
    scale = flat.trust_scale(w_sq, u_sq, wd, lr)
    flat_p.copy_(_apply_plain(flat_p.view(-1), u, seg, scale).view_as(flat_p))
    m.copy_(m_new.view_as(m))
    v.copy_(v_new.view_as(v))


def passes_kernel(flat_g, flat_p, m, v, seg, wd, hyp, lr, index) -> None:
    """K3 at 8 x 1024-element blocks: the same update, u recomputed in the
    second pass instead of stored."""
    partial = flat.flat_lamb_moments(flat_g, flat_p, m, v, seg, wd, hyp, BLOCK)
    scale = flat.trust_scale(*flat.leaf_sums(partial, index), wd, lr)
    flat.flat_lamb_apply(flat_p, m, v, seg, wd, hyp, scale, BLOCK)


def _passes(*args) -> None:
    device = args[1].device
    if device.type == "cuda":
        return passes_kernel(*args)
    if device.type == "cpu":
        return passes_plain(*args)
    raise ValueError(f"no fused LAMB for device {device}")


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------


class FusedLambState(NamedTuple):
    count: int
    flat_m: torch.Tensor  # (total // 1024, 1024) fp32
    flat_v: torch.Tensor


def fused_lamb(
    learning_rate: float | Callable[[int], float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    mask: Mapping[str, bool] | None = None,
    grad_clip_norm: float | None = 1.0,
    order: Sequence[str] | None = None,
) -> Transform:
    """NVLAMB as JAX's ``fused_lamb``: ``update(grads, state, params)`` takes
    dicts name -> tensor and returns the deltas ``new - old``. ``mask`` is
    True where weight decay (and so the trust ratio) applies; ``lr`` is
    evaluated at the update count after its increment. ``order``: the
    buffer's leaf order (default ``tree_order``)."""
    held: dict = {}  # the layout, its per-leaf weight decay and sum index
    consts: dict = {}  # per device: seg_ids, wd_leaf, leaf index

    def init(params: Mapping[str, torch.Tensor]) -> FusedLambState:
        layout = make_layout(params, order)
        wd = [weight_decay if (mask is None or mask[n]) else 0.0
              for n in layout.names]
        held.update(layout=layout, wd=np.asarray(wd, np.float32),
                    index=flat.leaf_index(layout))
        consts.clear()
        device = params[layout.names[0]].device
        rows = layout.total // LANES
        return FusedLambState(
            0, torch.zeros((rows, LANES), dtype=torch.float32, device=device),
            torch.zeros((rows, LANES), dtype=torch.float32, device=device))

    def on(device):
        if device not in consts:
            consts[device] = (
                torch.as_tensor(held["layout"].seg_ids, dtype=torch.int32,
                                device=device),
                torch.as_tensor(held["wd"], device=device),
                torch.as_tensor(held["index"], device=device))
        return consts[device]

    def update(grads: Mapping[str, torch.Tensor], state: FusedLambState,
               params: Mapping[str, torch.Tensor]):
        if params is None:
            raise ValueError("fused_lamb requires params")
        layout = held["layout"]
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        hyp = flat.step_hyp(b1, b2, eps, count, [grads[n] for n in layout.names],
                       grad_clip_norm)
        flat_g = pack(layout, grads).view(-1, LANES)
        flat_p = pack(layout, params).view(-1, LANES)
        seg, wd, index = on(flat_p.device)
        _passes(flat_g, flat_p, state.flat_m, state.flat_v, seg, wd, hyp, lr,
                index)
        new = unpack(layout, flat_p, params)
        updates = {n: new[n] - params[n] for n in layout.names}
        return updates, FusedLambState(count, state.flat_m, state.flat_v)

    return Transform(init, update)
