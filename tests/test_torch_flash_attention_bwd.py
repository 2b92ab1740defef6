"""Port parity: the flash-attention backward in torch against ``jax.vjp``
through the JAX package's ``flash_attention``.

The JAX side runs its Pallas kernels in interpret mode on the CPU (the
dropout-hash path); the torch side runs the autograd function's CPU path,
``mha_backward_reference``, which is what the CUDA kernels are held to on the
card. Inputs and the output cotangent come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from torch_threads import torch_one_thread  # noqa: F401

B, H, S, D = 2, 2, 64, 64
# fp32 on both sides, as tests/test_flash_attention.py:51-54 compares grads:
# only the order of the fp32 sums differs
TOL_F32 = 5e-4
# bf16: the forward's out and lse already differ by an ulp between the two
# frameworks, and dS is rounded to bf16 from those slightly different fp32
# values before the dQ and dK sums, so single entries move by a bf16 ulp of
# dS times |k| summed over 64 keys
TOL_BF16 = 3e-2

CASES = {
    # bshd with D=64 reaches _bwd_bshd; the last batch row has every key masked
    "bshd-masked": dict(layout="bshd", masked=True),
    # bhsd reaches _bwd
    "bhsd-masked": dict(layout="bhsd", masked=True),
    "bshd-causal-masked": dict(layout="bshd", masked=True, causal=True),
    # block_k reaches the K-blocked _bwd_kblk (its dq and dk/dv kernels)
    "bhsd-causal-kblocked": dict(layout="bhsd", causal=True,
                                 jax_kw=dict(block_q=16, block_k=16)),
    "bshd-dropout": dict(layout="bshd", masked=True, rate=0.1, seed=-1234567),
    # ragged against the CUDA kernels' 64-row tiles; D=128; causal rows whose
    # every key is masked (a masked key prefix)
    "bshd-s130-masked": dict(layout="bshd", masked=True, s=130),
    "bshd-d128-masked": dict(layout="bshd", masked=True, d=128),
    "bhsd-causal-dead-rows": dict(layout="bhsd", masked=True, causal=True,
                                  s=130, dead=70),
}


def _inputs(layout, masked, seed=0, s=S, d=D, dead=0):
    rng = np.random.default_rng(seed)
    shape = (B, s, H, d) if layout == "bshd" else (B, H, s, d)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, s), np.int32)
        mask[0, s - 13:] = 0
        mask[0, :dead] = 0  # under causal masking, rows with no key
        mask[-1] = 0  # every key of the last batch row masked
    return q, k, v, g, mask


def _jax_grads(q, k, v, g, mask, case, dtype):
    kw = dict(causal=case.get("causal", False), layout=case["layout"],
              dropout_rate=case.get("rate", 0.0),
              dropout_seed=case.get("seed", 0), **case.get("jax_kw", {}))
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit  # one compile of the interpret-mode kernels runs faster than eager
    def f(q, k, v, g):
        out, vjp = jax.vjp(
            lambda q, k, v: jax_flash_attention(q, k, v, jm, **kw), q, k, v)
        return out, vjp(g)

    args = [jnp.asarray(x, dtype) for x in (q, k, v, g)]
    with jax.default_matmul_precision("highest"):
        out, grads = f(*args)
    return np.asarray(out.astype(jnp.float32)), [
        np.asarray(x.astype(jnp.float32)) for x in grads]


def _torch_grads(q, k, v, g, mask, case, dtype):
    tq, tk, tv = (torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention(tq, tk, tv, tm, causal=case.get("causal", False),
                             layout=case["layout"],
                             dropout_rate=case.get("rate", 0.0),
                             dropout_seed=case.get("seed", 0))
    out.backward(torch.tensor(g, dtype=dtype))
    return out, [t.grad for t in (tq, tk, tv)]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_backward_matches_jax(name, precision):
    case = CASES[name]
    jdtype, tdtype, tol = {"fp32": (jnp.float32, torch.float32, TOL_F32),
                           "bf16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}[precision]
    q, k, v, g, mask = _inputs(case["layout"], case.get("masked", False),
                               s=case.get("s", S), d=case.get("d", D),
                               dead=case.get("dead", 0))
    want_out, want = _jax_grads(q, k, v, g, mask, case, jdtype)
    out, got = _torch_grads(q, k, v, g, mask, case, tdtype)
    np.testing.assert_allclose(out.detach().float().numpy(), want_out,
                               atol=tol, rtol=tol)
    for n, a, w in zip("qkv", got, want):
        assert a.dtype == tdtype and a.shape == q.shape
        np.testing.assert_allclose(a.float().numpy(), w, atol=tol, rtol=tol,
                                   err_msg=f"d{n}")


def test_fully_masked_row_takes_p_one_on_every_key():
    """lse of a row with every key masked is -1e30 in fp32, so exp(s - lse)
    is 1, not 1/S: the backward of that row sums over every key unscaled."""
    q, k, v, g, mask = _inputs("bhsd", masked=True)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = fa.mha_reference(tq, tk, tv, tm)
    assert bool((lse[-1] == fa.NEG_INF).all())
    dq, dk, dv = fa.mha_backward_reference(tq, tk, tv, tm, out, lse, tg)
    torch.testing.assert_close(dv[-1], tg[-1].sum(1, keepdim=True).expand(
        H, S, D), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_autograd_function_runs_the_plain_backward_on_cpu(layout):
    case = dict(layout=layout, causal=True, rate=0.2, seed=77)
    q, k, v, g, mask = _inputs(layout, masked=True, seed=1)
    out, got = _torch_grads(q, k, v, g, mask, case, torch.float32)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    ref_out, lse = fa.mha_reference(tq, tk, tv, tm, True, layout=layout,
                                    dropout_rate=0.2, dropout_seed=77)
    want = fa.mha_backward_reference(tq, tk, tv, tm, ref_out, lse, tg, True,
                                     layout=layout, dropout_rate=0.2,
                                     dropout_seed=77)
    torch.testing.assert_close(out.detach(), ref_out, rtol=0, atol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert fa.launches_bwd_dq == 0 and fa.launches_bwd_dkv == 0
