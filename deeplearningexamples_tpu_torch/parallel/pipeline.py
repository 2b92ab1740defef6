"""Pipeline parallelism: the GPipe schedule over a mesh axis.

Port of ``deeplearningexamples_tpu/parallel/pipeline.py``. Each rank of a
line along ``axis_name`` holds one stage; for S stages and M microbatches
the schedule runs S + M - 1 ticks, and at tick t stage s works on
microbatch t - s when 0 <= t - s < M (GPipe's fill and drain; the bubble is
(S - 1) / (S + M - 1)). After each tick the activations move j -> j+1 along
the line through ``parallel.mesh``'s ``ppermute`` (every rank takes part at
every tick), and the last stage's outputs are summed over the line, so that
every rank of it holds them, as JAX's ``psum`` of the last stage's result.

JAX computes every tick on every device and masks the ones outside a
stage's window out; here a stage skips them (it sends zeros), which leaves
the outputs and gradients as they were. The backward is written out as the
forward's reverse schedule (``_GPipe``), with one ``ppermute`` a tick along
the inverse direction, so that every rank runs the same collectives in the
same order: stage s takes the cotangent of its output at tick t from stage
s + 1 (the last stage from the output's cotangent), runs the stage's
backward, and hands the cotangent of its input to stage s - 1. The
gradients are exact, as JAX's transpose of its scan.

``remat=True`` applies ``torch.utils.checkpoint`` to the stage: a tick keeps
only its input and recomputes the stage in the backward, where without it a
tick keeps the stage's whole graph until the backward.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.utils.checkpoint as ckpt
from torch import nn

from .mesh import MODEL_AXIS, Mesh, _permute, all_reduce_, current_mesh

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(per_stage: Sequence[Mapping[str, torch.Tensor]]
                       ) -> dict[str, torch.Tensor]:
    """S stages' parameters of one structure (a dict of tensors each, such
    as ``dict(module.named_parameters())``), stacked along a new leading
    stage axis: the axis ``pipeline_apply`` takes a stage from."""
    return {name: torch.stack([p[name].detach() for p in per_stage])
            for name in per_stage[0]}


class _GPipe(torch.autograd.Function):
    """The schedule on this rank's stage. Inputs: the static arguments
    (``track``: keep what the backward needs), then the microbatches (M,
    mb, ...), then the stage's parameters."""

    @staticmethod
    def forward(ctx, stage_fn, names, mesh, axis, remat, track, x, *params):
        n, s, m = mesh.size(axis), mesh.index(axis), x.shape[0]
        ctx.meta = (mesh, axis)
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]

        def stage(a, *ps):
            return stage_fn(dict(zip(names, ps)), a)

        def run(a):
            if remat:
                return ckpt.checkpoint(stage, a, *leaves, use_reentrant=False)
            return stage(a, *leaves)

        fwd = [(j, j + 1) for j in range(n - 1)]
        ticks, outs = {}, [None] * m
        act = torch.zeros_like(x[0])
        for t in range(n + m - 1):
            mb = t - s
            if 0 <= mb < m:
                a_in = (x[mb] if s == 0 else act).detach().requires_grad_()
                with torch.set_grad_enabled(track):
                    a_out = run(a_in)
                if track:
                    ticks[t] = (a_in, a_out)
                send = outs[mb] = a_out.detach()
            else:  # outside the stage's window: nothing to compute
                send = torch.zeros_like(act)
            if t < n + m - 2:  # the last tick's send would go unread
                act = _permute(send.reshape(-1), mesh, axis, fwd).view_as(send)
        ctx.ticks, ctx.leaves = ticks, leaves
        ctx.x_like = torch.empty_like(x, device="meta")
        y = torch.stack(outs) if s == n - 1 else torch.zeros(
            (m, *act.shape), dtype=act.dtype, device=act.device)
        return all_reduce_(y, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, gy):
        mesh, axis = ctx.meta
        n, s, m = mesh.size(axis), mesh.index(axis), gy.shape[0]
        bwd = [(j + 1, j) for j in range(n - 1)]
        trained = [p for p in ctx.leaves if p.requires_grad]
        grads = {id(p): None for p in trained}
        dx = torch.zeros(ctx.x_like.shape, dtype=ctx.x_like.dtype,
                         device=gy.device)
        g_out = torch.zeros_like(gy[0])
        for t in reversed(range(n + m - 1)):
            mb = t - s
            if 0 <= mb < m:
                a_in, a_out = ctx.ticks.pop(t)
                got = torch.autograd.grad(
                    a_out, [a_in, *trained], gy[mb] if s == n - 1 else g_out,
                    allow_unused=True)
                send = got[0] if got[0] is not None else torch.zeros_like(a_in)
                for p, g in zip(trained, got[1:]):
                    if g is not None:
                        prev = grads[id(p)]
                        grads[id(p)] = g if prev is None else prev + g
                if s == 0:
                    dx[mb] = send
            else:
                send = torch.zeros_like(g_out)
            if t > 0:  # the cotangent of tick 0's input has no reader
                g_out = _permute(send.reshape(-1), mesh, axis,
                                 bwd).view_as(send)
        if ctx.needs_input_grad[6]:
            # the microbatches are the same on every rank of the line: their
            # cotangent is the ranks' sum (stage 0's; the others hold zeros)
            all_reduce_(dx, axis, mesh=mesh)
        else:
            dx = None
        return (None, None, None, None, None, None, dx,
                *(grads.get(id(p)) for p in ctx.leaves))


def pipeline_apply(stage_fn: Callable[[dict, torch.Tensor], torch.Tensor] | nn.Module,
                   stacked_params: Mapping[str, torch.Tensor],
                   microbatches: torch.Tensor, *, mesh: Mesh | None = None,
                   axis_name: str = MODEL_AXIS, batch_axis: str | None = None,
                   remat: bool = False) -> torch.Tensor:
    """Run ``microbatches`` (M, mb, ...) through S pipeline stages, one a
    rank of ``axis_name``'s line (``mesh=None``: the current mesh).

    ``stage_fn(params, x) -> y`` maps activations to activations of the
    same shape and dtype (a homogeneous trunk); ``params`` is a dict of
    tensors, or ``stage_fn`` an ``nn.Module`` run through
    ``torch.func.functional_call``. ``stacked_params`` has a leading stage
    axis of ``mesh.size(axis_name)`` (``stack_stage_params``); each rank
    takes its own stage's slice, so each stage's gradient lands in its
    slice on its own rank. ``batch_axis`` shards each microbatch's batch
    dim over that axis (DPxPP: this rank's rows ``rank_rows(mb,
    batch_axis)``; the gradients' mean over it stays the caller's, as in
    plain data parallelism). ``remat=True`` checkpoints each stage
    application. Returns (M, mb, ...), this rank's rows under
    ``batch_axis``, on every rank of the line: the stages applied one after
    another."""
    mesh = mesh or current_mesh()
    n = mesh.size(axis_name)
    names = list(stacked_params)
    lead = stacked_params[names[0]].shape[0]
    if lead != n:
        raise ValueError(f"stacked_params stage axis {lead} != mesh axis "
                         f"{axis_name}={n}")
    if isinstance(stage_fn, nn.Module):
        module = stage_fn
        stage_fn = lambda p, x: torch.func.functional_call(module, p, (x,))  # noqa: E731
    if batch_axis is not None:  # this rank's rows, as parallel.mesh.rank_rows
        k, i = mesh.size(batch_axis), mesh.index(batch_axis)
        rows = microbatches.shape[1]
        microbatches = microbatches[:, rows * i // k:rows * (i + 1) // k]
    s = mesh.index(axis_name)
    params = [stacked_params[k][s] for k in names]
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in (microbatches, *params))
    return _GPipe.apply(stage_fn, names, mesh, axis_name, remat, track,
                        microbatches, *params)

