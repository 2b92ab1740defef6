"""Embedding row gather: the CUDA kernel K4, its plain version, and the
embedding lookup DLRM trains through.

Port of ``deeplearningexamples_tpu/ops/embedding.py``. ``gather_rows`` is
``table[idx]`` with ``jnp.take``'s semantics: an index in [-V, 0) wraps to
row V + idx, any other index outside [0, V) gives a row of NaN. On CUDA
tensors it launches the hand-written Hopper kernel in ``csrc/gather_rows.cu``,
which replaces the TPU kernel ``pallas_gather_rows`` (``_gather_kernel``), or
raises; on CPU tensors it runs ``gather_rows_reference``, the plain PyTorch
version and the kernel's oracle.

``embedding_lookup`` is a ``torch.autograd.Function`` whose forward is that
gather. Its backward is plain PyTorch in either mode, as neither was a Pallas
kernel in JAX:

- ``"scatter"`` (``DlrmConfig.embedding_grad``'s default): the gradient of
  ``jnp.take``, a dense (V, D) table summed at the wrapped indices,
  out-of-range rows dropped: what XLA's scatter-add computes;
- ``"sorted"``: JAX ``embedding_lookup``'s custom VJP, the segment sum of
  the cotangent rows at the indices as they are. As JAX's
  ``segment_sum``, it drops every index outside [0, V), negative ones
  included, so a wrapped index gets no gradient there.

Both sum in fp32 and cast once to the table's dtype, through one segment
sum in a fixed order (``_segment_sum``): the indices are sorted (stable),
and each row's run of equal indices is added up in its order in the batch
and written once. No atomics, so two runs on the card give the same bits,
as JAX's scatter-add and segment sum do.

``hot_gather`` (the CUDA kernel K6, also in ``csrc/gather_rows.cu``) is the
row gather of ``perf/dlrm_hotrow.py``'s probe, which replaces its TPU kernel
``_hot_kernel``: the head (``k_hot`` rows) of each table of the joint table
is read from a separate ``hot`` buffer, the other rows from the table.
``hot_gather_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["embedding_lookup", "gather_rows", "gather_rows_reference",
           "hot_gather", "hot_gather_reference", "launches", "launches_hot"]

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the count was last set to 0 (K4, K6). Only the CUDA
# launches add to them.
launches = 0
launches_hot = 0
_count_lock = threading.Lock()


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``table[idx]`` with ``jnp.take``'s edges: (N, D) in the
    table's dtype for int (N,) indices."""
    v = table.shape[0]
    idx = idx.long()
    wrapped = torch.where(idx < 0, idx + v, idx)
    valid = (wrapped >= 0) & (wrapped < v)
    out = table.index_select(0, torch.where(valid, wrapped, 0))
    return out.masked_fill(~valid[:, None], float("nan"))


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be 2-d and idx 1-d, got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if table.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"table dtype {table.dtype} not in {SUPPORTED_DTYPES}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table and idx must be on one device, got "
                         f"{table.device} and {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.shape[0] == 0:
        raise ValueError("empty table")


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from ._build import load

        fn = load().dlx_gather_rows
        # table, idx, out, n, v, row_bytes, is_bf16, stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    n, (v, d) = idx.shape[0], table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, v,
                        d * table.element_size(),
                        int(table.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: table (V, D) fp32 or bf16, idx int32 (N,) -> (N, D) in
    the table's dtype. The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    _check(table, idx)
    if table.device.type == "cuda":
        return _gather_cuda(table, idx)
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    raise ValueError(f"no row gather for device {table.device}")


def _check_hot(table, hot, ids, rows_per_table, k_hot) -> None:
    _check(table, ids)
    v, d = table.shape
    if not 0 < k_hot <= rows_per_table < 2**31 or v % rows_per_table:
        raise ValueError(f"need 0 < k_hot <= rows_per_table < 2^31 dividing "
                         f"V={v}, got k_hot={k_hot}, rows_per_table="
                         f"{rows_per_table}")
    want = (v // rows_per_table * k_hot, d)
    if tuple(hot.shape) != want or hot.dtype != table.dtype:
        raise ValueError(f"hot must be {want} {table.dtype}, got "
                         f"{tuple(hot.shape)} {hot.dtype}")
    if hot.device != table.device or not hot.is_contiguous():
        raise ValueError(f"hot must be contiguous on {table.device}")


def hot_gather_reference(table: torch.Tensor, hot: torch.Tensor,
                         ids: torch.Tensor, rows_per_table: int = 100_000,
                         k_hot: int = 256) -> torch.Tensor:
    """Plain PyTorch hot/cold gather: row r of the joint table, in table
    t = r // rows_per_table at within = r % rows_per_table, comes from
    ``hot[t * k_hot + within]`` if within < k_hot, else from ``table[r]``;
    an id outside [0, V) gives a row of NaN."""
    v = table.shape[0]
    ids = ids.long()
    valid = (ids >= 0) & (ids < v)
    r = torch.where(valid, ids, 0)
    t, within = r // rows_per_table, r % rows_per_table
    is_hot = within < k_hot
    out = torch.where(is_hot[:, None],
                      hot.index_select(0, torch.where(is_hot, t * k_hot + within, 0)),
                      table.index_select(0, r))
    return out.masked_fill(~valid[:, None], float("nan"))


_hot_fn = None


def _hot_kernel():
    global _hot_fn
    if _hot_fn is None:
        from ._build import load

        fn = load().dlx_hot_gather
        # table, hot, idx, out, n, v, rows_per_table, k_hot, row_bytes,
        # is_bf16, stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _hot_fn = fn
    return _hot_fn


def hot_gather(table: torch.Tensor, hot: torch.Tensor, ids: torch.Tensor,
               rows_per_table: int = 100_000, k_hot: int = 256) -> torch.Tensor:
    """The probe's hot/cold gather: table (V, D) fp32 or bf16, hot
    (V / rows_per_table * k_hot, D) in its dtype, ids int32 (N,) in [0, V)
    -> (N, D). Any N. The ids are not checked against V (that would cost a
    host sync): one outside [0, V) gives a NaN row and reads nothing. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    global launches_hot
    _check_hot(table, hot, ids, rows_per_table, k_hot)
    if table.device.type == "cpu":
        return hot_gather_reference(table, hot, ids, rows_per_table, k_hot)
    if table.device.type != "cuda":
        raise ValueError(f"no hot gather for device {table.device}")
    n, (v, d) = ids.shape[0], table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0:
        return out
    with torch.cuda.device(table.device):
        err = _hot_kernel()(table.data_ptr(), hot.data_ptr(), ids.data_ptr(),
                            out.data_ptr(), n, v, rows_per_table, k_hot,
                            d * table.element_size(),
                            int(table.dtype == torch.bfloat16),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hot_gather kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches_hot += 1
    return out


def _segment_sum(g: torch.Tensor, idx: torch.Tensor, v: int) -> torch.Tensor:
    """Dense (V, D) fp32: row i holds the sum of g's rows whose index is i,
    added in their order in g; rows of indices outside [0, V) are dropped.

    A stable sort brings equal indices together in their order (the dropped
    ones, keyed V, last); ``searchsorted`` gives each row i its run [off[i],
    off[i + 1]) of the sorted rows, empty where no lookup hit it; and
    ``segment_reduce`` adds each run in order (one thread per row and
    column) and writes every row of the result once, 0 for an empty run.
    No atomics and no host sync: two runs give the same bits."""
    valid = (idx >= 0) & (idx < v)
    key, order = torch.sort(torch.where(valid, idx, v), stable=True)
    offsets = torch.searchsorted(
        key, torch.arange(v + 1, device=g.device, dtype=key.dtype))
    return torch.segment_reduce(g[order].float(), "sum", offsets=offsets,
                                axis=0, unsafe=True)


class _EmbeddingLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, flat_idx, grad, valid):
        idx = flat_idx.reshape(-1).to(torch.int32)
        if valid is not None:  # masked ids read row 0, then give zero rows
            keep = valid.reshape(-1)
            idx = torch.where(keep, idx, 0)
        out = gather_rows(table, idx.contiguous())
        if valid is not None:
            out = torch.where(keep[:, None], out, 0)
            # ... and no gradient: index V, which the segment sum drops
            idx = torch.where(keep, idx, table.shape[0])
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype, ctx.grad = tuple(table.shape), table.dtype, grad
        return out.view(*flat_idx.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        v, d = ctx.shape
        g = g.reshape(-1, d)
        idx = idx.long()
        if ctx.grad == "scatter":  # jnp.take's gradient: [-V, 0) wraps
            idx = torch.where(idx < 0, idx + v, idx)
        return _segment_sum(g, idx, v).to(ctx.dtype), None, None, None


def embedding_lookup(table: torch.Tensor, flat_idx: torch.Tensor,
                     grad: str = "scatter",
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, D); flat_idx (...,) int -> (..., D) in the table's dtype,
    differentiable in the table. ``grad``: ``"scatter"`` or ``"sorted"``.
    ``valid`` (flat_idx's shape, bool): where False the row is 0 and takes
    no gradient, whatever the id (a row-sharded table's lookup of the ids
    another rank owns); the kernel reads row 0 there, never an id out of
    range."""
    if grad not in ("scatter", "sorted"):
        raise ValueError(f"unknown embedding grad {grad!r}")
    return _EmbeddingLookup.apply(table, flat_idx, grad, valid)
