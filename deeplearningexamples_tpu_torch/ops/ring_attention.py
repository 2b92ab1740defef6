"""Ring attention: exact attention over a sequence sharded on the mesh's
``sequence`` axis.

Port of ``deeplearningexamples_tpu/ops/ring_attention.py``. Each rank of a
sequence line holds one block of the queries and passes its key/value block
(with its key mask) to its neighbour j -> j-1 at every step, through
``parallel.mesh.ppermute``, so at step t rank i holds the block of rank (i +
t) mod n. A running (max, denominator, weighted sum) triple in fp32 folds in
one block a step: the online softmax of flash attention across ranks. The
blocks are plain torch ops in fp32, as JAX's are ``jnp`` einsums, and
autograd differentiates the loop (``ppermute``'s backward sends the
cotangent back along the inverse permutation).

Semantics follow JAX's code:

- the scores are ``(q.float() * scale) @ k.float()ᵀ``; masked entries are
  ``NEG_INF`` (-1e30) and their ``exp`` is zeroed, so a row whose keys are
  all masked returns zeros (``o / max(l, 1e-30)``);
- causal masking compares global query and key positions;
- probability dropout multiplies the numerator only, by K1's hash
  (``ops.flash_attention.dropout_scale``) of the global (query, key)
  positions, the seed and ``batch * H + head``, where ``batch`` is the
  global row: inside JAX's ``shard_map`` the batch is whole, so the port
  adds the data axis's row offset, as K1's ``dropout_batch_offset`` does.
  The keep mask is K1's for the same seed;
- ``zigzag=True`` (causal only) gives rank i the chunks ``[i, 2n-1-i]`` of a
  2n-chunk split: at each step a rank computes the diagonal block, its
  queries against the visiting early chunk, or its late chunk against the
  visiting pair, half a block of live work a step on every rank.

``ring_attention`` takes the global (B, H, S, D) that every rank of a
sequence line holds, takes this rank's block of the sequence (its backward
gathers the blocks' cotangents), runs the ring and gathers the output blocks
(its backward keeps this rank's block): the transposes of JAX's ``in_specs``
and ``out_specs``. On an axis of one rank it is one block, with no
collective.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import (DATA_AXIS, SEQ_AXIS, Mesh, current_mesh,
                             gather_along, ppermute, shard_along)
from .flash_attention import dropout_scale

__all__ = ["NEG_INF", "ring_attention", "ring_attention_local"]

NEG_INF = -1e30


def _zigzag_positions(i: int, n: int, c: int, device) -> torch.Tensor:
    """Global positions of chunks ``[i, 2n-1-i]`` of length ``c``."""
    ar = torch.arange(c, device=device)
    return torch.cat([i * c + ar, (2 * n - 1 - i) * c + ar])


def ring_attention_local(q, k, v, key_mask=None, *, axis_name: str = SEQ_AXIS,
                         causal: bool = False, sm_scale: float | None = None,
                         dropout_rate: float = 0.0, dropout_seed: int = 0,
                         zigzag: bool = False, dropout_batch_offset: int = 0,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """The ring on this rank's blocks. q, k, v: (B, H, S_local, D), this
    rank's block of the sequence (the zigzag chunk pair with ``zigzag``);
    key_mask: (B, S_local), 1 = attend, rotated with K/V. Returns this
    rank's block of the output in q's dtype. ``dropout_batch_offset``: the
    global row of batch row 0 (the dropout hash's salt)."""
    mesh = mesh or current_mesh()
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    b, h, sl, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    dev = q.device
    if zigzag:
        if not causal:
            raise ValueError("zigzag layout only pays off for causal=True")
        if sl % 2:
            raise ValueError(f"zigzag needs an even local length, got {sl}")
        c = sl // 2
        qpos = _zigzag_positions(i, n, c, dev)
    else:
        qpos = i * sl + torch.arange(sl, device=dev)
    salt = None
    if dropout_rate > 0.0:
        salt = ((torch.arange(b, device=dev)[:, None] + dropout_batch_offset)
                * h + torch.arange(h, device=dev)[None, :])[..., None, None]

    def fold(o, m, l, s, v_sel, qp, kp, guard):
        """One online-softmax update of rows (o, m, l) with scores s;
        ``guard``: s may hold NEG_INF entries, whose exp is zeroed so that
        a row with nothing unmasked yet adds nothing."""
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if guard:
            p = torch.where(s > NEG_INF / 2, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if dropout_rate > 0.0:  # the numerator only
            p = p * dropout_scale(qp[:, None], kp[None, :], dropout_seed,
                                  salt, dropout_rate)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                v_sel.float())
        return o, m_new, l

    def scores(q_sel, k_sel, mask_sel):
        s = torch.einsum("bhqd,bhkd->bhqk", q_sel, k_sel.float())
        if mask_sel is not None:
            s = s.masked_fill(~mask_sel.bool()[:, None, None, :], NEG_INF)
        return s

    # rank j hands its block to j-1 each step: at step t rank i holds the
    # block of rank (i + t) % n
    perm = [(j, (j - 1) % n) for j in range(n)]
    o = torch.zeros((b, h, sl, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sl), dtype=torch.float32, device=dev)
    kv, maskt = torch.stack([k, v]), key_mask
    for t in range(n):
        src = (i + t) % n
        kt, vt = kv[0], kv[1]
        if not zigzag:
            kpos = src * sl + torch.arange(sl, device=dev)
            s = scores(qf, kt, maskt)
            if causal:
                s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
            o, m, l = fold(o, m, l, s, vt, qpos, kpos, True)
        else:
            kpos = _zigzag_positions(src, n, c, dev)
            if src == i:  # the home block: the causal mask in global positions
                s = scores(qf, kt, maskt)
                s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
                o, m, l = fold(o, m, l, s, vt, qpos, kpos, True)
            elif src < i:
                # both query chunks see only the visiting early chunk: all
                # queries x half the keys, no causal mask
                mh = None if maskt is None else maskt[:, :c]
                s = scores(qf, kt[:, :, :c], mh)
                o, m, l = fold(o, m, l, s, vt[:, :, :c], qpos, kpos[:c],
                               maskt is not None)
            else:
                # only the late query chunk sees the visiting pair, all of it:
                # half the queries x all the keys
                s = scores(qf[:, :, c:], kt, maskt)
                o2, m2, l2 = fold(o[:, :, c:], m[:, :, c:], l[:, :, c:], s, vt,
                                  qpos[c:], kpos, maskt is not None)
                o = torch.cat([o[:, :, :c], o2], dim=2)
                m = torch.cat([m[:, :, :c], m2], dim=2)
                l = torch.cat([l[:, :, :c], l2], dim=2)
        if t < n - 1:  # the n-th rotation would only bring the blocks home
            kv = ppermute(kv, axis_name, perm, mesh)
            if maskt is not None:
                maskt = ppermute(maskt, axis_name, perm, mesh)
    out = o / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


def _zigzag_order(s: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """JAX's static shuffle into the zigzag layout and its inverse."""
    c = s // (2 * n)
    idx = np.concatenate([
        np.concatenate([np.arange(i * c, (i + 1) * c),
                        np.arange((2 * n - 1 - i) * c, (2 * n - i) * c)])
        for i in range(n)])
    inv = np.empty_like(idx)
    inv[idx] = np.arange(s)
    return idx, inv


def ring_attention(q, k, v, key_mask=None, *, mesh: Mesh | None = None,
                   causal: bool = False, sm_scale: float | None = None,
                   axis_name: str = SEQ_AXIS, dropout_rate: float = 0.0,
                   dropout_seed: int = 0, zigzag: bool = False) -> torch.Tensor:
    """Ring attention on the global (B, H, S, D) q, k, v that every rank of
    a sequence line holds (S divisible by the axis's size), with this rank's
    rows of the data axis: the global attention's output, on every rank of
    the line. ``mesh=None`` uses the current mesh. ``zigzag=True`` (causal
    only, S divisible by 2n) shuffles the sequence into the zigzag layout,
    runs the half-FLOPs ring and unshuffles the output: the same numbers as
    ``zigzag=False``."""
    mesh = mesh or current_mesh()
    n = mesh.size(axis_name)
    s = q.shape[-2]
    if s % n:
        raise ValueError(f"seq len {s} not divisible by {axis_name}={n}")
    inv = None
    if zigzag:
        if not causal:
            raise ValueError("zigzag layout only pays off for causal=True")
        if s % (2 * n):
            raise ValueError(f"zigzag needs seq len divisible by 2n={2 * n}")
        idx, inv = _zigzag_order(s, n)
        idx = torch.as_tensor(idx, device=q.device)
        q, k, v = (x[:, :, idx] for x in (q, k, v))
        if key_mask is not None:
            key_mask = key_mask[:, idx]
    qs, ks, vs = shard_along((q, k, v), axis_name, 2, mesh)
    ms = None if key_mask is None else shard_along(key_mask, axis_name, 1, mesh)
    out = ring_attention_local(
        qs, ks, vs, ms, axis_name=axis_name, causal=causal, sm_scale=sm_scale,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed, zigzag=zigzag,
        dropout_batch_offset=mesh.index(DATA_AXIS) * q.shape[0], mesh=mesh)
    out = gather_along(out, axis_name, 2, mesh)
    if inv is not None:
        out = out[:, :, torch.as_tensor(inv, device=out.device)]
    return out
