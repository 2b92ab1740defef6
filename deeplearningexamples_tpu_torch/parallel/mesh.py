"""The (data, model, sequence) mesh of ranks, the batch's rows per rank, and
the collectives the port runs over the mesh's axes.

Port of ``deeplearningexamples_tpu/parallel/mesh.py``. In JAX the mesh
reshapes the devices, sharding annotations place the arrays and XLA inserts
the collectives. Here each rank is a process (``parallel/dist.py``) and the
collectives are written out, all of them in this module:

- ``MeshSpec.resolve`` is JAX's, with its errors; ``build_mesh`` places the
  ranks as JAX reshapes the devices, ``rank = (d * M + m) * S + s``, and
  makes one process group per line of ranks along each axis;
- ``shard_batch`` gives this rank its rows of a global batch (JAX's
  ``shard_batch``): under ``accum_steps`` its slice of each of JAX's
  contiguous microbatches, so each microbatch's rows and denominators are
  JAX's; ``check_batch_split`` refuses a training batch that does not
  split evenly;
- the collectives are no-ops on an axis of one rank, so a run without
  ``torchrun`` (no process group, ``build_mesh`` gives the 1 x 1 x 1 mesh)
  runs no collective at all;
- gloo on device tensors stages them through pinned host memory, chosen by
  the backend's name; NCCL takes device tensors as they are.

The transpose of a collective is written on purpose. ``sum_over_ranks`` sums
per-rank values whose consumers differ by rank (BN's batch statistics over
the data axis): its backward sums the cotangents too. ``sum_partials`` sums
partial results that every rank then consumes alike (DLRM's lookup, whose
MLPs and loss are replicated over the model axis): each rank already holds
the whole cotangent, so its backward is the identity; a summing backward
would make the table's gradient N times too large. ``sum_cotangents`` is its
transpose: the identity forward of a replicated value that each rank
consumes in part (MoE's tokens into the rank's experts), whose backward sums
the partial cotangents.

The sequence axis and the pipeline move tensors between neighbours:
``ppermute`` is JAX's ``lax.ppermute`` (each rank sends to its destination
under a permutation of the axis and receives from its source; a rank that
is no destination receives zeros), and its backward sends the cotangent
along the inverse permutation. ``shard_along`` takes this rank's block of a
replicated tensor (its backward gathers the blocks' cotangents, JAX's
transpose of a ``shard_map`` input) and ``gather_along`` gathers the ranks'
blocks (its backward keeps this rank's block). Each of these takes several
tensors in one call and runs one collective for all of them, in the forward
and in the backward, so that every rank runs the same collectives in the
same order whatever order autograd visits independent nodes in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AXES", "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "MeshSpec",
    "all_gather_rows", "all_reduce_", "all_reduce_mean_", "batch_positions",
    "build_mesh", "check_batch_split",
    "current_mesh", "data_mean", "data_rows", "draw_rows", "gather_data_rows",
    "gather_along", "gather_objects", "global_flip", "gather_sharded",
    "mark_sharded", "mean_over_data", "ppermute", "rank_rows", "reset_mesh",
    "shard_along", "shard_batch", "shard_rows_of", "sum_cotangents",
    "sum_over_ranks", "sum_partials",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "sequence"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. ``-1`` on one axis means "all remaining
    ranks"."""

    data: int = -1
    model: int = 1
    sequence: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        dims = [self.data, self.model, self.sequence]
        if dims.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = int(np.prod([d for d in dims if d != -1]))
        if -1 in dims:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by {known}")
            dims[dims.index(-1)] = n_devices // known
        if int(np.prod(dims)) != n_devices:
            raise ValueError(f"mesh {dims} != {n_devices} devices")
        return tuple(dims)  # type: ignore


class Mesh:
    """The grid of ranks, this rank's coordinates on it and the process
    group of its line along each axis (None on an axis of one rank)."""

    def __init__(self, shape: Sequence[int], rank: int = 0,
                 groups: Mapping[str, Any] | None = None,
                 backend: str | None = None):
        self.shape = dict(zip(AXES, (int(n) for n in shape)))
        d, m, s = (self.shape[a] for a in AXES)
        self.rank = rank
        self.coords = {DATA_AXIS: rank // (m * s), MODEL_AXIS: rank // s % m,
                       SEQ_AXIS: rank % s}
        self.groups = dict(groups or dict.fromkeys(AXES))
        self.backend = backend

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def world(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def is_primary(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank at ``index`` on ``axis`` of this rank's line."""
        coords = {**self.coords, axis: index}
        return ((coords[DATA_AXIS] * self.shape[MODEL_AXIS]
                 + coords[MODEL_AXIS]) * self.shape[SEQ_AXIS] + coords[SEQ_AXIS])


_ONE = Mesh((1, 1, 1))
_current = _ONE


def current_mesh() -> Mesh:
    """The mesh ``build_mesh`` made last, or the 1 x 1 x 1 mesh."""
    return _current


def reset_mesh() -> None:
    """Back to the 1 x 1 x 1 mesh (a test's process after a mesh run)."""
    global _current
    _current = _ONE


def build_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The (data, model, sequence) mesh over the process group's ranks (one
    rank without a group), made the current mesh. Every rank calls it, in
    the same order, as ``new_group`` asks."""
    global _current
    spec = spec or MeshSpec()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = spec.resolve(world)
    grid = np.arange(world).reshape(shape)
    groups = dict.fromkeys(AXES)
    for i, axis in enumerate(AXES):
        if shape[i] == 1:
            continue
        # every line of ranks along the axis, in one order on every rank
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    _current = Mesh(shape, rank, groups,
                    dist.get_backend() if dist.is_initialized() else None)
    return _current


# ---------------------------------------------------------------------------
# Rows of the batch
# ---------------------------------------------------------------------------


def rank_rows(n: int, axis: str = DATA_AXIS,
              index: int | None = None) -> tuple[int, int]:
    """``[lo, hi)`` of ``n`` rows that rank ``index`` of ``axis`` holds
    (this rank's by default): ``n * i // N`` to ``n * (i + 1) // N``, even
    when N does not divide n."""
    mesh = current_mesh()
    k = mesh.size(axis)
    i = mesh.index(axis) if index is None else index
    return n * i // k, n * (i + 1) // k


def data_rows(n_local: int) -> tuple[int, int]:
    """``(offset, global rows)`` of a tensor whose dim 0 is this rank's
    ``n_local`` rows of the data axis: what dropout needs to draw the mask
    the one-rank run draws for these rows."""
    mesh = current_mesh()
    return mesh.index(DATA_AXIS) * n_local, n_local * mesh.size(DATA_AXIS)


def draw_rows(draw, n_local: int) -> torch.Tensor:
    """This rank's ``n_local`` rows of ``draw(rows)``, a random draw whose
    dim 0 is ``rows``, made at the global batch's rows: the rows the
    one-rank run draws for this rank's part of the batch (the draw itself on
    one data rank)."""
    off, rows = data_rows(n_local)
    out = draw(rows)
    return out if rows == n_local else out[off:off + n_local]


def check_batch_split(n: int, accum_steps: int = 1) -> None:
    """Raise unless a global training batch of ``n`` rows splits into
    ``accum_steps`` microbatches of equal shares on every data rank: the
    step's gradient mean, BN's counts and the dropout offsets take the
    ranks' shares as equal (JAX's ``shard_batch`` refuses such a batch
    too). Only an eval batch may split unevenly (``gather_data_rows``)."""
    k = current_mesh().size(DATA_AXIS)
    if k > 1 and n % (accum_steps * k):
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{accum_steps} microbatches over {k} data ranks")


def batch_positions(n: int, accum_steps: int = 1) -> np.ndarray:
    """The positions of this rank's rows in a global batch of ``n``: its
    rows of each of the ``accum_steps`` contiguous microbatches, in order
    (all ``n`` on one data rank)."""
    if accum_steps > 1:
        check_batch_split(n, accum_steps)
    step = n // accum_steps
    lo, hi = rank_rows(step)
    return np.concatenate([np.arange(j * step + lo, j * step + hi)
                           for j in range(accum_steps)])


def _length(v: Any) -> int | None:
    if isinstance(v, list):
        return len(v)
    if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
        return v.shape[0]
    return None


def shard_batch(batch: Mapping[str, Any], accum_steps: int = 1) -> dict:
    """This rank's rows of a global batch: each array (or list, SSD300's
    ``gt``) whose length is the batch's, along dim 0; anything else as it
    is. With ``accum_steps`` n the rows are this rank's slice of each of
    the n contiguous microbatches the step splits the batch into, so that
    the step's own split gives each microbatch JAX's rows. Unsharded on one
    data rank."""
    mesh = current_mesh()
    k = mesh.size(DATA_AXIS)
    if k == 1:
        return dict(batch)
    n = max(n for n in map(_length, batch.values()) if n is not None)
    pos = batch_positions(n, accum_steps)
    lo, hi = int(pos[0]), int(pos[-1]) + 1

    def rows(v):
        if isinstance(v, list):
            return [v[i] for i in pos]
        if accum_steps == 1:  # one contiguous block: a view
            return v[lo:hi]
        return v[torch.as_tensor(pos, device=v.device)
                 if isinstance(v, torch.Tensor) else pos]

    return {key: rows(v) if _length(v) == n else v
            for key, v in batch.items()}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


# (dtype, slot) -> the pinned host buffer gloo's staging reuses
_PINNED: dict = {}


def _staged(t: torch.Tensor, mesh: Mesh | None = None, slot: int = 0):
    """(the tensor the collective runs on, a function that puts the result
    back): gloo on a device tensor goes through pinned host memory (one
    buffer a dtype and ``slot``, grown as needed: pinning is slow, about
    0.5 s a GB). A send and a receive in flight together take two slots."""
    if t.device.type == "cuda" and (mesh or current_mesh()).backend == "gloo":
        buf = _PINNED.get((t.dtype, slot))
        if buf is None or buf.numel() < t.numel():
            buf = _PINNED[t.dtype, slot] = torch.empty(
                t.numel(), dtype=t.dtype, pin_memory=True)
        host = buf[:t.numel()].view(t.shape)
        host.copy_(t)
        return host, lambda: t.copy_(host)
    return t, lambda: t


def all_reduce_(t: torch.Tensor, axis: str = DATA_AXIS,
                op: str = "sum", mesh: Mesh | None = None) -> torch.Tensor:
    """Sum (or ``op``: "max") ``t`` over ``axis`` in place; not
    differentiable."""
    mesh = mesh or current_mesh()
    group = mesh.groups[axis]
    if group is None:
        return t
    work, back = _staged(t, mesh)
    dist.all_reduce(work, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    back()
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     axis: str = DATA_AXIS) -> None:
    """Each tensor replaced by its mean over ``axis``, in place, through
    one flat bucket per dtype (the data axis's gradient mean)."""
    mesh = current_mesh()
    k = mesh.size(axis)
    if k == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce_(flat, axis)
        flat.div_(k)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def mean_over_data(metrics: Mapping[str, torch.Tensor]) -> dict:
    """0-d metrics averaged over the data axis in one collective (each
    rank's metric is over its equal share of the rows)."""
    if current_mesh().size(DATA_AXIS) == 1 or not metrics:
        return dict(metrics)
    names = list(metrics)
    vec = torch.stack([torch.as_tensor(metrics[k]).float().reshape(())
                       for k in names])
    all_reduce_mean_([vec])
    return dict(zip(names, vec.unbind()))


def data_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / max(den, 1)`` over the global batch (JAX's data-dependent
    denominators: the MLM loss and accuracy), as this rank's share: its
    numerator times the data degree over the denominator summed over the
    data axis, so that the data axis's mean of it, and of its gradient, is
    the global value. On one data rank, ``num / max(den, 1)``."""
    k = current_mesh().size(DATA_AXIS)
    if k == 1:
        return num / den.clamp(min=1)
    return num * k / all_reduce_(den.detach().clone()).clamp(min=1)


def global_flip(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch's ``x.flip(0)`` (mixup mixes
    each row with the reversed batch's): every rank's rows gathered, then
    flipped, then this rank's taken."""
    if current_mesh().size(DATA_AXIS) == 1:
        return x.flip(0)
    off, _ = data_rows(x.shape[0])
    return all_gather_rows(x).flip(0)[off:off + x.shape[0]]


def all_gather_rows(t: torch.Tensor, axis: str = DATA_AXIS,
                    counts: Sequence[int] | None = None,
                    mesh: Mesh | None = None) -> torch.Tensor:
    """The ranks' ``t`` along ``axis``, concatenated on dim 0 in rank order.
    ``counts``: each rank's rows where they differ (else all are ``t``'s)."""
    mesh = mesh or current_mesh()
    group = mesh.groups[axis]
    if group is None:
        return t
    k = mesh.size(axis)
    counts = list(counts) if counts is not None else [t.shape[0]] * k
    width = max(counts)
    src = t.contiguous()
    if t.shape[0] < width:
        src = torch.cat([src, src.new_zeros(width - t.shape[0], *t.shape[1:])])
    work, _ = _staged(src, mesh)
    parts = [torch.empty_like(work) for _ in range(k)]
    dist.all_gather(parts, work, group=group)
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return out.to(t.device)


def gather_data_rows(t: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``t`` in rank order: the global batch's
    rows (the ranks of a short last batch may hold different counts)."""
    if current_mesh().size(DATA_AXIS) == 1:
        return t
    return all_gather_rows(t, DATA_AXIS, gather_objects(int(t.shape[0])))


def gather_objects(obj: Any, axis: str = DATA_AXIS) -> list:
    """Every rank's ``obj`` along ``axis`` in rank order (pickled)."""
    mesh = current_mesh()
    group = mesh.groups[axis]
    if group is None:
        return [obj]
    out = [None] * mesh.size(axis)
    dist.all_gather_object(out, obj, group=group)
    return out


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce_(x.clone(), axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over_ranks(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """Differentiable sum over ``axis`` whose backward sums the cotangents:
    for values each rank consumes differently (BN's statistics)."""
    if current_mesh().groups[axis] is None:
        return x
    return _SumOverRanks.apply(x, axis)


def sum_partials(x: torch.Tensor, axis: str = MODEL_AXIS,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """Differentiable sum over ``axis`` whose backward is the identity: for
    partial results that every rank then consumes alike (DLRM's lookup,
    MoE's experts)."""
    mesh = mesh or current_mesh()
    if mesh.groups[axis] is None:
        return x
    return _SumPartials.apply(x, axis, mesh)


# ---------------------------------------------------------------------------
# Several tensors in one collective: the sequence axis, the pipeline, MoE
# ---------------------------------------------------------------------------


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors (of one dtype) flattened into one contiguous buffer."""
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("one collective takes tensors of one dtype, got "
                         f"{sorted(str(t.dtype) for t in tensors)}")
    if len(tensors) == 1:
        return tensors[0].contiguous().view(-1)
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack(flat: torch.Tensor, shapes: Sequence[torch.Size]) -> list:
    sizes = [int(np.prod(s)) for s in shapes]
    return [part.view(s) for part, s in zip(flat.split(sizes), shapes)]


def _meta(xs) -> list:
    """Shapes and dtypes of ``xs`` for a backward, on the meta device."""
    return [torch.empty_like(x, device="meta") for x in xs]


def _filled(gs, like: Sequence[torch.Tensor]) -> list:
    """Cotangents with None (an output autograd had no gradient for) as
    zeros of ``like``'s shape and dtype, so that every rank sends the same
    buffer."""
    dev = next(g.device for g in gs if g is not None)
    return [torch.zeros(t.shape, dtype=t.dtype, device=dev) if g is None
            else g for g, t in zip(gs, like)]


def _permute(flat: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """JAX's ``ppermute`` of one buffer: this rank sends ``flat`` to its
    destination under ``perm`` and returns what its source sent (zeros if
    it is no destination). The send and the receive are posted together: a
    ring of blocking sends would deadlock."""
    i = mesh.index(axis)
    dst = [d for s, d in perm if s == i]
    src = [s for s, d in perm if d == i]
    if dst == src == [i]:
        return flat.clone()
    out = torch.zeros_like(flat)
    send, _ = _staged(flat, mesh, slot=0)
    recv, back = _staged(out, mesh, slot=1)
    group = mesh.groups[axis]
    ops = [dist.P2POp(op, t, mesh.rank_at(axis, peer[0]), group)
           for op, t, peer in ((dist.isend, send, dst), (dist.irecv, recv, src))
           if peer]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    back()
    return out


def _check_perm(perm, n: int) -> tuple[tuple[int, int], ...]:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= j < n for j in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a permutation of {n} ranks")
    return perm


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, perm, *xs):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        ctx.like = _meta(xs)
        return tuple(_unpack(_permute(_pack(xs), mesh, axis, perm),
                             [x.shape for x in xs]))

    @staticmethod
    def backward(ctx, *gs):
        gs = _filled(gs, ctx.like)
        inverse = tuple((d, s) for s, d in ctx.perm)
        back = _permute(_pack(gs), ctx.mesh, ctx.axis, inverse)
        return (None, None, None, *_unpack(back, [g.shape for g in gs]))


def _tensors(x) -> tuple[tuple[torch.Tensor, ...], bool]:
    if isinstance(x, torch.Tensor):
        return (x,), True
    return tuple(x), False


def ppermute(x, axis: str, perm: Sequence[tuple[int, int]],
             mesh: Mesh | None = None):
    """JAX's ``lax.ppermute`` over ``axis``: ``perm`` holds (source,
    destination) pairs of indices on the axis; each rank returns what its
    source sent, zeros where it is no destination. Differentiable: the
    cotangent goes back along the inverse permutation. ``x`` is a tensor or
    a sequence of tensors of one dtype (one collective for all of them). The
    identity on an axis of one rank, with no collective."""
    mesh = mesh or current_mesh()
    xs, single = _tensors(x)
    perm = _check_perm(perm, mesh.size(axis))
    if mesh.groups[axis] is None:
        return x
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        out = _PPermute.apply(mesh, axis, perm, *xs)
    else:
        out = _unpack(_permute(_pack(xs), mesh, axis, perm),
                      [t.shape for t in xs])
    return out[0] if single else tuple(out)


def _gathered(xs, mesh: Mesh, axis: str, dim: int) -> list:
    """Each of ``xs`` with every rank's block concatenated along ``dim``."""
    parts = [_unpack(p, [x.shape for x in xs]) for p in
             all_gather_rows(_pack(xs)[None], axis, mesh=mesh)]
    return [torch.cat([part[j] for part in parts], dim)
            for j in range(len(xs))]


def _block(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.size(axis)
    return x.narrow(dim, mesh.index(axis) * n, n)


class _ShardAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        blocks = [_block(x, mesh, axis, dim) for x in xs]
        ctx.like = _meta(blocks)
        return tuple(t.clone() for t in blocks)

    @staticmethod
    def backward(ctx, *gs):
        gs = _filled(gs, ctx.like)
        return (None, None, None,
                *_gathered(gs, ctx.mesh, ctx.axis, ctx.dim))


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return tuple(_gathered(xs, mesh, axis, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *(
            None if g is None else _block(g, ctx.mesh, ctx.axis, ctx.dim)
            for g in gs))


def shard_along(x, axis: str, dim: int, mesh: Mesh | None = None):
    """This rank's block of ``dim`` (of ``mesh.size(axis)`` equal blocks) of
    a tensor that every rank of the line holds alike, or of each of a
    sequence of tensors of one dtype. The backward gathers every rank's
    block of the cotangents (one collective): the whole cotangent, on every
    rank, as the replicated input's consumers need it."""
    mesh = mesh or current_mesh()
    xs, single = _tensors(x)
    k = mesh.size(axis)
    for t in xs:
        if t.shape[dim] % k:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible "
                             f"by {axis}={k}")
    if mesh.groups[axis] is None:
        return x
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        out = _ShardAlong.apply(mesh, axis, dim, *xs)
    else:
        out = [_block(t, mesh, axis, dim) for t in xs]
    return out[0] if single else tuple(out)


def gather_along(x, axis: str, dim: int, mesh: Mesh | None = None):
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in rank
    order (one collective for a sequence of tensors of one dtype). The
    backward keeps this rank's block of the cotangent: every rank consumes
    the gathered tensor alike, so each holds the whole cotangent."""
    mesh = mesh or current_mesh()
    xs, single = _tensors(x)
    if mesh.groups[axis] is None:
        return x
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        out = _GatherAlong.apply(mesh, axis, dim, *xs)
    else:
        out = _gathered(xs, mesh, axis, dim)
    return out[0] if single else tuple(out)


class _SumCotangents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.like = _meta(xs)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = _filled(gs, ctx.like)
        flat = all_reduce_(_pack(gs).clone(), ctx.axis, mesh=ctx.mesh)
        return (None, None, *_unpack(flat, [g.shape for g in gs]))


def sum_cotangents(x, axis: str = MODEL_AXIS, mesh: Mesh | None = None):
    """The identity, whose backward sums the cotangents over ``axis`` (one
    collective for a sequence of tensors of one dtype): the transpose of
    ``sum_partials``, for a value every rank holds alike and consumes in
    part (MoE's tokens and gates into the rank's own experts)."""
    mesh = mesh or current_mesh()
    xs, single = _tensors(x)
    if mesh.groups[axis] is None or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in xs):
        return x
    out = _SumCotangents.apply(mesh, axis, *xs)
    return out[0] if single else tuple(out)


# ---------------------------------------------------------------------------
# Tensors sharded on dim 0 (ZeRO's moments, DLRM's table)
# ---------------------------------------------------------------------------


def mark_sharded(t: torch.Tensor, axis: str, total_rows: int) -> torch.Tensor:
    """Mark ``t`` as this rank's rows ``rank_rows(total_rows, axis)`` of a
    tensor sharded over ``axis``, so a checkpoint gathers it whole and a
    restore takes back only these rows."""
    t._dlx_shard = (axis, int(total_rows))
    return t


def gather_sharded(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a marked shard (every rank of its axis takes
    part); an unmarked tensor as it is."""
    mark = getattr(t, "_dlx_shard", None)
    if mark is None:
        return t
    axis, total = mark
    counts = [hi - lo for lo, hi in (
        rank_rows(total, axis, i) for i in range(current_mesh().size(axis)))]
    return all_gather_rows(t.detach(), axis, counts)


def shard_rows_of(template: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """The rows of ``whole`` that a marked ``template`` holds (all of it for
    an unmarked one)."""
    mark = getattr(template, "_dlx_shard", None)
    if mark is None or whole.shape[0] != mark[1]:
        return whole
    lo, hi = rank_rows(mark[1], mark[0])
    return whole[lo:hi]
