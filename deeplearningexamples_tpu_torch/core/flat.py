"""Flat-parameter training with the fused LAMB: CUDA kernels (K3) and their
plain versions.

Port of ``deeplearningexamples_tpu/core/flat.py``. Every parameter of the
model becomes a view into one (rows, 1024) fp32 buffer, each segment padded
to whole blocks of 64 x 1024 elements, and so does its gradient: autograd
adds each parameter's gradient in place into its view of one flat gradient
buffer, which is what ``unflatten``'s custom VJP does in JAX. The optimizer
then reads and writes the two buffers in two passes:

  pass 1 (``flat_lamb_moments``): m, v update with the clip factor folded
         into g, and one partial (sum p^2, sum u^2) per block
  torch: per-tensor sums of the partials in a fixed order, trust ratio
         gated by wd > 0, scale = lr * ratio (JAX's "tiny XLA" step)
  pass 2 (``flat_lamb_apply``): u again from the stored m and v, and
         p -= scale[tensor] * u, in place

On CUDA tensors the passes launch the kernels of ``csrc/flat_lamb.cu``
(which replace the TPU kernels ``_moment_kernel`` and ``_apply_kernel``) or
raise; on CPU tensors they run the plain versions below, which are the
kernels' oracles. The passes take 64 x 1024-element blocks (this module's
layout) or 8 x 1024 (``ops/fused_lamb.py``'s), and the launch counts count
both. ``flat_lamb`` evaluates ``lr`` at the update count after the
increment, where the tree LAMB (``ops/lamb.py``) uses the count before it; both
are as in JAX.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.lamb import Transform, global_norm

__all__ = [
    "BLOCK",
    "FlatLayout",
    "LANES",
    "default_wd_mask",
    "flat_lamb",
    "flat_lamb_apply",
    "flat_lamb_moments",
    "flatten_train",
    "launches_apply",
    "launches_moments",
    "leaf_index",
    "leaf_sums",
    "make_layout_blocked",
    "step_hyp",
    "trust_scale",
    "unflatten",
]

LANES = 1024
BLOCK_ROWS = 64
BLOCK = BLOCK_ROWS * LANES

# Kernel launches since the count was last set to 0; only CUDA launches add.
launches_moments = 0
launches_apply = 0
_count_lock = threading.Lock()


class FlatLayout(NamedTuple):
    """JAX ``ops/fused_lamb.py``'s ``FlatLayout``, names in place of the
    treedef."""

    names: tuple  # leaf names, in buffer order
    shapes: tuple
    starts: np.ndarray  # padded start offset per leaf
    sizes: np.ndarray  # true size per leaf
    total: int  # padded total
    seg_ids: np.ndarray  # (total // block,) leaf index per block
    n_leaves: int


def make_layout_blocked(named_shapes: Sequence[tuple[str, tuple]],
                        block: int = BLOCK) -> FlatLayout:
    """JAX ``_make_layout_blocked`` over ``(name, shape)`` pairs in buffer
    order: each leaf's segment starts on a block boundary."""
    names = tuple(n for n, _ in named_shapes)
    shapes = tuple(tuple(s) for _, s in named_shapes)
    sizes = np.asarray([int(np.prod(s)) if s else 1 for s in shapes])
    padded = ((sizes + block - 1) // block) * block
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    total = int(padded.sum())
    seg_ids = np.repeat(np.arange(len(shapes)), padded // block)
    return FlatLayout(names, shapes, starts, sizes, total, seg_ids, len(shapes))


def default_wd_mask(names: Sequence[str]) -> dict[str, bool]:
    """The reference BERT weight-decay grouping (run_pretraining.py's
    no_decay list): no decay on biases or LayerNorm parameters. JAX's
    ``default_wd_mask`` picks the same set by its names (bias, scale,
    mlm_bias)."""
    return {n: not ("bias" in n or "LayerNorm" in n) for n in names}


def unflatten(layout: FlatLayout, flat: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views of ``flat`` as the named tensors."""
    view = flat.view(-1)
    return {n: view[int(s):int(s) + int(z)].view(shape)
            for n, s, z, shape in zip(layout.names, layout.starts,
                                      layout.sizes, layout.shapes)}


# ---------------------------------------------------------------------------
# Plain versions of the two passes
# ---------------------------------------------------------------------------


def _moments_plain(g, p, m, v, seg_ids, wd_leaf, hyp):
    b1, b2, eps, c1, c2, cs = hyp.unbind()
    nb = seg_ids.numel()
    g = g * cs
    m32 = b1 * m.float() + (1 - b1) * g
    v32 = b2 * v.float() + (1 - b2) * g * g
    wd = wd_leaf[seg_ids.long()].view(nb, 1)
    u = ((m32 / c1) / (torch.sqrt(v32 / c2) + eps)).view(nb, -1) \
        + wd * p.view(nb, -1)
    m.copy_(m32)
    v.copy_(v32)
    return torch.stack([(p * p).view(nb, -1).sum(1), (u * u).sum(1)], 1)


def _apply_plain(p, m, v, seg_ids, wd_leaf, hyp, scale_leaf):
    eps, c1, c2 = hyp[2], hyp[3], hyp[4]
    nb = seg_ids.numel()
    seg = seg_ids.long()
    u = ((m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)).view(nb, -1) \
        + wd_leaf[seg].view(nb, 1) * p.view(nb, -1)
    p.view(nb, -1).sub_(scale_leaf[seg].view(nb, 1) * u)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_kernel_fns: dict = {}
_ARGTYPES = {
    # g, p, m, v, seg_ids, wd_leaf, hyp, partial, n_blocks, block, bf16, stream
    "dlx_flat_lamb_moments": [ctypes.c_void_p] * 8,
    # p, m, v, seg_ids, wd_leaf, hyp, scale_leaf, n_blocks, block, bf16, stream
    "dlx_flat_lamb_apply": [ctypes.c_void_p] * 7,
}
BLOCKS = (BLOCK, 8 * LANES)  # the block sizes the kernels are built for


def _kernel(name: str):
    if name not in _kernel_fns:
        from ..ops._build import load

        fn = getattr(load(), name)
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fns[name] = fn
    return _kernel_fns[name]


def _check(p, m, v, seg_ids, wd_leaf, hyp, block, extra=()):
    """Validate what the kernels take; returns the number of blocks."""
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}, got {block}")
    rows = block // LANES
    if p.dim() != 2 or p.shape[1] != LANES or p.shape[0] % rows:
        raise ValueError(f"the flat buffer must be ({rows}k, {LANES}), got "
                         f"{tuple(p.shape)}")
    nb = p.shape[0] // rows
    if m.dtype != v.dtype or m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m and v must share fp32 or bf16, got {m.dtype}, {v.dtype}")
    if seg_ids.dtype != torch.int32 or seg_ids.shape != (nb,):
        raise ValueError(f"seg_ids must be int32 ({nb},)")
    for name, t in (("p", p), ("m", m), ("v", v), ("seg_ids", seg_ids),
                    ("wd_leaf", wd_leaf), ("hyp", hyp), *extra):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {p.device}")
        if name not in ("m", "v", "seg_ids") and t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32, got {t.dtype}")
    if m.shape != p.shape or v.shape != p.shape:
        raise ValueError("m and v must have the buffer's shape")
    if hyp.shape != (6,):
        raise ValueError("hyp must be (b1, b2, eps, c1, c2, clip factor)")
    return nb


def flat_lamb_moments(g, p, m, v, seg_ids, wd_leaf, hyp,
                      block: int = BLOCK) -> torch.Tensor:
    """Pass 1: update ``m`` and ``v`` in place; returns the (n_blocks, 2) fp32
    partial sums of p^2 and u^2, u from the unrounded fp32 moments. ``hyp``
    is (b1, b2, eps, 1 - b1^t, 1 - b2^t, clip factor), fp32 on the device;
    ``block`` the elements of a flat block (one of ``BLOCKS``)."""
    global launches_moments
    nb = _check(p, m, v, seg_ids, wd_leaf, hyp, block, (("g", g),))
    if g.shape != p.shape:
        raise ValueError("g must have the buffer's shape")
    if p.device.type == "cpu":
        return _moments_plain(g, p, m, v, seg_ids, wd_leaf, hyp)
    if p.device.type != "cuda":
        raise ValueError(f"no flat LAMB for device {p.device}")
    partial = torch.empty((nb, 2), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = _kernel("dlx_flat_lamb_moments")(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            seg_ids.data_ptr(), wd_leaf.data_ptr(), hyp.data_ptr(),
            partial.data_ptr(), nb, block, int(m.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flat_lamb_moments kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches_moments += 1
    return partial


def flat_lamb_apply(p, m, v, seg_ids, wd_leaf, hyp, scale_leaf,
                    block: int = BLOCK) -> None:
    """Pass 2: ``p -= scale_leaf[tensor] * u`` in place, u recomputed from the
    stored ``m`` and ``v``."""
    global launches_apply
    nb = _check(p, m, v, seg_ids, wd_leaf, hyp, block,
                (("scale_leaf", scale_leaf),))
    if p.device.type == "cpu":
        return _apply_plain(p, m, v, seg_ids, wd_leaf, hyp, scale_leaf)
    if p.device.type != "cuda":
        raise ValueError(f"no flat LAMB for device {p.device}")
    with torch.cuda.device(p.device):
        err = _kernel("dlx_flat_lamb_apply")(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
            wd_leaf.data_ptr(), hyp.data_ptr(), scale_leaf.data_ptr(), nb,
            block, int(m.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flat_lamb_apply kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches_apply += 1


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def step_hyp(b1: float, b2: float, eps: float, count: int,
             grads: Sequence[torch.Tensor],
             grad_clip_norm: float | None) -> torch.Tensor:
    """The passes' ``hyp`` for update ``count`` (after its increment): (b1,
    b2, eps, 1 - b1^t, 1 - b2^t, clip factor), fp32 on the gradients'
    device. The clip factor is fused_lamb.py's: g /= max(1, gnorm / max_norm),
    no eps."""
    device = grads[0].device
    if grad_clip_norm:
        gnorm = global_norm(list(grads))
        cs = torch.where(gnorm > grad_clip_norm,
                         gnorm.new_full((), grad_clip_norm) / gnorm, 1.0)
    else:
        cs = torch.ones((), dtype=torch.float32, device=device)
    cf = np.float32(count)
    consts_h = [b1, b2, eps, np.float32(1) - np.float32(b1) ** cf,
                np.float32(1) - np.float32(b2) ** cf]
    host = torch.from_numpy(np.asarray(consts_h, np.float32))
    if device.type == "cuda":
        # from pinned memory, asynchronously: a pageable copy would make the
        # host wait here for the whole backward
        host = host.pin_memory()
    return torch.cat([host.to(device, non_blocking=True), cs.reshape(1)])


def leaf_sums(partial: torch.Tensor, index: torch.Tensor):
    """Pass 1's (n_blocks, 2) partials summed per leaf in block order through
    ``index`` (``leaf_index``): (sum p^2, sum u^2), each (n_leaves,)."""
    return torch.cat([partial, partial.new_zeros((1, 2))])[index].sum(1).unbind(1)


def trust_scale(w_sq: torch.Tensor, u_sq: torch.Tensor, wd: torch.Tensor,
                lr) -> torch.Tensor:
    """lr * the trust ratio ||p|| / ||u|| of each leaf, from its sums of p^2
    and u^2."""
    w_norm, u_norm = torch.sqrt(w_sq), torch.sqrt(u_sq)
    # LAMBStage2Functor gating (multi_tensor_lamb.cu:276-283): no-decay
    # leaves take a plain-lr step
    ratio = torch.where((wd > 0) & (w_norm > 0) & (u_norm > 0),
                        w_norm / u_norm, 1.0)
    return torch.as_tensor(lr, dtype=torch.float32) * ratio


class FlatLambState(NamedTuple):
    count: int
    flat_m: torch.Tensor
    flat_v: torch.Tensor


def leaf_index(layout: FlatLayout) -> np.ndarray:
    """(n_leaves, most blocks of a leaf) block indices, padded with n_blocks
    (a zero row): summing along dim 1 adds each leaf's partials in block
    order, with no float atomics."""
    seg = layout.seg_ids
    counts = np.bincount(seg, minlength=layout.n_leaves)
    idx = np.full((layout.n_leaves, int(counts.max())), len(seg), np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for leaf, (f, c) in enumerate(zip(first, counts)):
        idx[leaf, :c] = np.arange(f, f + c)
    return idx


def flat_lamb(
    learning_rate: float | Callable[[int], float],
    layout: FlatLayout,
    wd_leaf: np.ndarray,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    grad_clip_norm: float | None = 1.0,
    moment_dtype: torch.dtype = torch.float32,
) -> Transform:
    """NVLAMB on a flat parameter buffer. ``wd_leaf`` is the per-leaf weight
    decay (0.0 where masked). ``update(flat_g, state, flat_p)`` writes the new
    parameters into ``flat_p`` and returns it."""
    rows = layout.total // LANES
    index_np = leaf_index(layout)
    consts: dict = {}  # per device: seg_ids, wd_leaf, leaf index

    def on(device):
        if device not in consts:
            consts[device] = (
                torch.as_tensor(layout.seg_ids, dtype=torch.int32, device=device),
                torch.as_tensor(wd_leaf, dtype=torch.float32, device=device),
                torch.as_tensor(index_np, device=device))
        return consts[device]

    def init(flat_params: torch.Tensor) -> FlatLambState:
        if tuple(flat_params.shape) != (rows, LANES):
            raise ValueError(f"flat_lamb layout mismatch: {tuple(flat_params.shape)}"
                             f" vs {(rows, LANES)}")
        return FlatLambState(
            0,
            torch.zeros((rows, LANES), dtype=moment_dtype, device=flat_params.device),
            torch.zeros((rows, LANES), dtype=moment_dtype, device=flat_params.device))

    def update(flat_g: torch.Tensor, state: FlatLambState, flat_p: torch.Tensor):
        seg, wd, index = on(flat_p.device)
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        hyp = step_hyp(b1, b2, eps, count, [flat_g], grad_clip_norm)
        partial = flat_lamb_moments(flat_g, flat_p, state.flat_m, state.flat_v,
                                    seg, wd, hyp)
        scale_leaf = trust_scale(*leaf_sums(partial, index), wd, lr)
        flat_lamb_apply(flat_p, state.flat_m, state.flat_v, seg, wd, hyp,
                        scale_leaf)
        return flat_p, FlatLambState(count, state.flat_m, state.flat_v)

    return Transform(init, update, returns_new_params=True)


def flatten_train(
    model: nn.Module,
    *,
    lr: float | Callable[[int], float],
    weight_decay: float = 0.01,
    grad_clip_norm: float | None = 1.0,
    moment_dtype: torch.dtype = torch.float32,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    order: Sequence[str] | None = None,
) -> tuple[Transform, torch.Tensor, FlatLayout]:
    """Move ``model``'s fp32 parameters into one flat buffer and return
    ``(tx, flat_params, layout)`` for ``create_train_state`` and
    ``make_train_step``. Each parameter becomes a view of ``flat_params`` and
    its ``.grad`` a view of ``flat_params.grad``, so the model trains and
    evaluates as it did. ``order`` gives the buffer's leaf order (default: the
    model's); ``bert_pretrain_jax_order`` gives the JAX package's."""
    named = dict(model.named_parameters())
    names = list(order) if order is not None else list(named)
    if sorted(names) != sorted(named):
        raise ValueError("order must name every parameter of the model once")
    if any(p.dtype != torch.float32 for p in named.values()):
        raise ValueError("the flat buffer holds fp32 parameters")
    layout = make_layout_blocked([(n, tuple(named[n].shape)) for n in names])
    device = next(iter(named.values())).device
    flat = torch.zeros((layout.total // LANES, LANES), dtype=torch.float32,
                       device=device)
    flat.grad = torch.zeros_like(flat)
    views, grads = unflatten(layout, flat), unflatten(layout, flat.grad)
    with torch.no_grad():
        for n in names:
            views[n].copy_(named[n])
            named[n].data = views[n]
            named[n].grad = grads[n]
    mask = default_wd_mask(names)
    wd_leaf = np.asarray([weight_decay if mask[n] else 0.0 for n in names],
                         np.float32)
    tx = flat_lamb(lr, layout, wd_leaf, b1=b1, b2=b2, eps=eps,
                   grad_clip_norm=grad_clip_norm, moment_dtype=moment_dtype)
    return tx, flat, layout
