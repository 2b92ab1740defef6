"""Port parity: the torch flash attention against the JAX package's kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, which takes
the dropout-hash path; the torch side runs its plain version, which is what
the CUDA kernel is checked against on the card. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.ops.flash_attention import (
    _dropout_scale,
    _fwd,
    flash_attention as jax_flash_attention,
)
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from torch_threads import torch_one_thread  # noqa: F401

# fp32 tolerances as tests/test_flash_attention.py:25; lse is one log away
# from the row sums, so it is held tighter
ATOL_F32, ATOL_LSE = 2e-5, 1e-5
# bf16: P and the output round to bf16 at different points of the two sums,
# as tests/test_flash_attention.py:69-76
ATOL_BF16 = 3e-2


def _inputs(layout, b=2, h=2, s=64, d=64, seed=0, dead=0):
    """q, k, v and a key mask whose last batch row has every key masked;
    ``dead`` masks the first keys of row 0 too, so that under causal masking
    its first ``dead`` queries see no key."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, s - 13:] = 0
    mask[0, :dead] = 0
    mask[-1] = 0
    return q, k, v, mask


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _np(t):
    return t.float().numpy()


# D=64 with H=2 reaches the JAX _fwd_bshd kernel (two heads fill 128 lanes);
# D=32 with H=2 cannot fold and falls back to the (B,H,S,D) _fwd kernel;
# D=128 takes one head a block. S=130 is ragged against the CUDA kernels'
# 64-row tiles, and a masked key prefix leaves causal rows with no key.
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("d, s, dead", [(64, 64, 0), (32, 64, 0), (128, 64, 0),
                                        (64, 130, 0), (64, 130, 70)],
                         ids=["64", "32", "128", "64-s130", "64-s130-dead70"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_fp32(layout, d, s, dead, causal):
    q, k, v, mask = _inputs(layout, s=s, d=d, dead=dead)
    scale = 1.0 / np.sqrt(d)
    want_out, want_lse = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal, scale, 512,
                              bshd=layout == "bshd")
    public = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(mask), causal=causal, layout=layout)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, tm, causal=causal,
                                           layout=layout)
    assert out.shape == q.shape and lse.shape == (2, 2, s)
    np.testing.assert_allclose(_np(out), np.asarray(public), atol=ATOL_F32,
                               rtol=ATOL_F32)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), atol=ATOL_F32,
                               rtol=ATOL_F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=ATOL_LSE, rtol=ATOL_LSE)
    # the row with every key masked averages V uniformly, as mha_reference
    if not causal:
        v_last = v[-1] if layout == "bhsd" else v[-1].transpose(1, 0, 2)
        out_last = _np(out)[-1] if layout == "bhsd" else \
            _np(out)[-1].transpose(1, 0, 2)
        np.testing.assert_allclose(
            out_last, np.broadcast_to(v_last.mean(1, keepdims=True),
                                      out_last.shape), atol=ATOL_F32)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_plain_matches_jax_bf16(layout):
    q, k, v, mask = _inputs(layout, seed=1)
    want = jax_flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask),
        layout=layout)
    tq, tk, tv, tm = _torch(q, k, v, mask, dtype=torch.bfloat16)
    out = fa.flash_attention(tq, tk, tv, tm, layout=layout)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(want, np.float32),
                               atol=ATOL_BF16, rtol=ATOL_BF16)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_dropout_matches_jax(layout):
    """rate 0.1 with a negative seed: the hash keeps the same probabilities
    on both sides, so the outputs agree to fp32 rounding."""
    q, k, v, mask = _inputs(layout, seed=2)
    seed, rate = -123457, 0.1
    scale = 1.0 / np.sqrt(64)
    want_out, want_lse = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), False, scale, 512,
                              bshd=layout == "bshd", rate=rate, seed=seed)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, tm, layout=layout,
                                           dropout_rate=rate,
                                           dropout_seed=seed)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), atol=ATOL_F32,
                               rtol=ATOL_F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=ATOL_LSE, rtol=ATOL_LSE)
    plain = fa.flash_attention(tq, tk, tv, tm, layout=layout)
    assert not torch.allclose(out, plain)  # dropout did drop


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_hash_matches_jax_bit_for_bit(rate):
    rows = np.concatenate([np.arange(48), [1000, 2**20 + 3, 2**31 - 1]])
    cols = np.concatenate([np.arange(40), [777, 2**24, 2**31 - 2]])
    r2, c2 = np.meshgrid(rows.astype(np.int32), cols.astype(np.int32),
                         indexing="ij")
    for seed in (-2**31, -12345, 0, 7, 2**31 - 1):
        for salt in (-3, 0, 5, 2**20 + 1, 2**31 - 1):
            want = np.asarray(_dropout_scale(jnp.asarray(r2), jnp.asarray(c2),
                                             jnp.int32(seed), salt, rate))
            got = fa.dropout_scale(torch.from_numpy(r2), torch.from_numpy(c2),
                                   seed, salt, rate).numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"seed {seed} salt {salt}")
    kept = float((got > 0).mean())
    assert abs(kept - (1.0 - rate)) < 0.05


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_dropout_batch_offset_takes_rows_of_the_global_batch(layout):
    """A data rank's rows k.. of a batch, with ``dropout_batch_offset=k``,
    draw JAX's one-device mask for those rows (its hash salt (k + b) H + h):
    the forward against JAX's ``_fwd`` on the whole batch, the plain
    backward against the whole batch's rows."""
    q, k, v, mask = _inputs(layout, b=4, seed=3)
    mask[-1] = 1  # every row attends somewhere
    seed, rate, off = 99173, 0.2, 2
    scale = 1.0 / np.sqrt(64)
    want_out, want_lse = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), False, scale, 512,
                              bshd=layout == "bshd", rate=rate, seed=seed)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    part = [t[off:].clone().requires_grad_(t.is_floating_point())
            for t in (tq, tk, tv, tm)]
    out, lse = fa.flash_attention_with_lse(*part, layout=layout,
                                           dropout_rate=rate, dropout_seed=seed,
                                           dropout_batch_offset=off)
    np.testing.assert_allclose(_np(out.detach()), np.asarray(want_out)[off:],
                               atol=ATOL_F32, rtol=ATOL_F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[off:, ..., 0],
                               atol=ATOL_LSE, rtol=ATOL_LSE)
    unshifted = fa.flash_attention(*part, layout=layout, dropout_rate=rate,
                                   dropout_seed=seed)
    assert not torch.allclose(out, unshifted)  # row 0's mask is not row 2's
    whole = [t.clone().requires_grad_(t.is_floating_point())
             for t in (tq, tk, tv, tm)]
    dout = torch.from_numpy(np.random.default_rng(4).normal(
        size=out.shape).astype(np.float32))
    full = fa.flash_attention(*whole, layout=layout, dropout_rate=rate,
                              dropout_seed=seed)
    full.backward(torch.cat([torch.zeros_like(dout)[:off], dout]))
    out.backward(dout)
    for p, w in zip(part[:3], whole[:3]):
        torch.testing.assert_close(p.grad, w.grad[off:], rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask = _torch(*_inputs("bshd", s=16))
    before = fa.launches
    out = fa.flash_attention(q, k, v, mask, layout="bshd")
    want, _ = fa.mha_reference(q, k, v, mask, layout="bshd")
    assert fa.launches == before
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout"):
        fa.flash_attention(q, k, v, layout="sbhd")
    meta = q.to("meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(meta, meta, meta, layout="bshd")

