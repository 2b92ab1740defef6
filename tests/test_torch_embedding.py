"""Port parity: the embedding row gather (K4's plain version), the embedding
lookup's two backwards and the dot interaction, against the JAX package.

The same numpy inputs go to ``jnp.take`` / JAX ``embedding_lookup`` /
JAX ``dot_interaction`` on the CPU and to the port's CPU paths (the plain
versions the card's kernel is held against).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.ops.dot_interaction import (
    dot_interaction as jax_dot_interaction,
)
from deeplearningexamples_tpu.ops.embedding import (
    embedding_lookup as jax_embedding_lookup,
)
from deeplearningexamples_tpu_torch.ops import embedding as emb
from deeplearningexamples_tpu_torch.ops.dot_interaction import (
    dot_interaction,
    dot_interaction_reference,
    interaction_output_dim,
)
from torch_threads import torch_one_thread  # noqa: F401

V, D = 50, 8
# indices in range, in [-V, 0) (wrap), below -V and at or past V (NaN rows)
EDGE = np.array([0, 3, V - 1, -1, -V, -V - 1, V, V + 7, 2**31 - 1, -2**31, 3],
                np.int32)


def _table(dtype, seed=0, v=V, d=D):
    t = np.random.default_rng(seed).normal(size=(v, d)).astype(np.float32)
    return t, torch.from_numpy(t).to(dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gather_reference_matches_jnp_take(dtype):
    """Bitwise equal on every row jnp.take fills from the table, NaN rows in
    the same places: a gather is a copy."""
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    table, t = _table(tdt)
    idx = np.concatenate([np.random.default_rng(1).integers(0, V, 200), EDGE]
                         ).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table, jdt), idx, axis=0)
                      ).astype(np.float32)
    before = emb.launches
    got = emb.gather_rows(t, torch.from_numpy(idx))
    assert emb.launches == before  # a CPU tensor never reaches the kernel
    assert got.dtype == tdt and got.shape == (idx.size, D)
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any(axis=1).sum() == 5
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    np.testing.assert_array_equal(
        emb.gather_rows_reference(t, torch.from_numpy(idx)).float().numpy(), got)


def test_gather_rows_raises_on_what_it_does_not_take():
    _, t = _table(torch.float32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        emb.gather_rows(t, idx.long())
    with pytest.raises(ValueError, match="dtype"):
        emb.gather_rows(t.half(), idx)
    with pytest.raises(ValueError, match="2-d"):
        emb.gather_rows(t[None], idx)
    with pytest.raises(ValueError, match="contiguous"):
        emb.gather_rows(t.t(), idx)
    with pytest.raises(ValueError, match="empty"):
        emb.gather_rows(t[:0], idx)
    with pytest.raises(ValueError, match="unknown embedding grad"):
        emb.embedding_lookup(t, idx, grad="dense")


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
def test_embedding_lookup_grads_match_jax(mode):
    """``scatter`` against ``jax.grad`` of ``jnp.take`` (negative indices
    wrap, out-of-range rows are dropped); ``sorted`` against JAX
    ``embedding_lookup``'s custom VJP (its segment sum drops every index
    outside [0, V), negative ones too). fp32 sums of at most a few terms per
    row, in another order: 1e-6."""
    table, t = _table(torch.float32)
    rng = np.random.default_rng(2)
    # rows 0 and V - 1 are reached only through the wrapped -V and -1
    idx = rng.integers(1, V - 1, (16, 3)).astype(np.int32)
    idx[5] = EDGE[3:6]  # -1, -V, -V - 1
    idx[9] = EDGE[6:9]  # V, V + 7, 2**31 - 1
    cot = rng.normal(size=(16, 3, D)).astype(np.float32)
    jlookup = (lambda tb: jnp.take(tb, idx, axis=0)) if mode == "scatter" \
        else (lambda tb: jax_embedding_lookup(tb, idx))
    out_j, vjp = jax.vjp(jlookup, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))

    t.requires_grad_()
    out = emb.embedding_lookup(t, torch.from_numpy(idx), grad=mode)
    assert out.shape == (16, 3, D)
    np.testing.assert_array_equal(np.isnan(out.detach().numpy()),
                                  np.isnan(np.asarray(out_j)))
    out.backward(torch.from_numpy(cot))
    assert t.grad.dtype == torch.float32
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the two modes part on the rows that only negative indices reach
    reached = float(np.abs(np.asarray(want)[[0, V - 1]]).sum()) > 0
    assert reached == (mode == "scatter")


def test_embedding_lookup_grad_of_a_bf16_table_is_bf16():
    _, t = _table(torch.bfloat16)
    t.requires_grad_()
    idx = torch.tensor([[1, 1, 2]], dtype=torch.int32)
    emb.embedding_lookup(t, idx).float().sum().backward()
    assert t.grad.dtype == torch.bfloat16
    assert float(t.grad[1].float().mean()) == 2.0
    assert float(t.grad[2].float().mean()) == 1.0
    assert float(t.grad[0].float().abs().sum()) == 0.0


def test_dot_interaction_matches_jax_and_the_oracle():
    """480 wide at F=27, D=128 (128 + 351 + 1 pad). fp32 on both sides, JAX
    at "highest": only the 128-term sums' order differs (1e-4 on values of
    size ~10), as the JAX package's own oracle test allows."""
    rng = np.random.default_rng(0)
    b, f, d = 8, 27, 128
    bottom = rng.normal(size=(b, d)).astype(np.float32)
    embs = rng.normal(size=(b, f - 1, d)).astype(np.float32)
    assert interaction_output_dim(f, d) == 480
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_dot_interaction(jnp.asarray(bottom),
                                              jnp.asarray(embs)))
    tb = torch.from_numpy(bottom).requires_grad_()
    te = torch.from_numpy(embs).requires_grad_()
    got = dot_interaction(tb, te)
    assert got.shape == (b, 480) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(),
                               dot_interaction_reference(bottom, embs),
                               rtol=1e-5, atol=1e-4)
    assert float(got.detach()[:, -1].abs().max()) == 0.0  # the pad column

    cot = rng.normal(size=(b, 480)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jax_dot_interaction, jnp.asarray(bottom),
                         jnp.asarray(embs))
        gb, ge = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    for g, w in ((tb.grad, gb), (te.grad, ge)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_dot_interaction_bf16_keeps_the_dtype():
    rng = np.random.default_rng(1)
    bottom = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    embs = torch.from_numpy(rng.normal(size=(4, 3, 16)).astype(np.float32))
    got = dot_interaction(bottom.bfloat16(), embs.bfloat16())
    want = dot_interaction(bottom.bfloat16().float(), embs.bfloat16().float())
    assert got.dtype == torch.bfloat16
    assert got.shape == (4, interaction_output_dim(4, 16)) == (4, 24)
    # products of bf16 inputs summed in fp32, then rounded once to bf16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)
