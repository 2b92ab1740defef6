"""Port parity: int8 quantization in torch against the JAX package.

Weight quantization, dequantization and both fake-quants must equal JAX's bit
for bit, gradients included. Stochastic rounding cannot share JAX's bits (its
CPU path draws from ``jax.random``, its TPU path from the hardware PRNG, the
port from Philox), so the port's rounding is fed JAX's own uniforms and must
then give JAX's q exactly, and the port's Philox draws are held to the
statistics ``tests/test_quantization.py`` asks of JAX's. On the CPU the port
runs its plain versions; the CUDA kernel is held to them on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.ops import quantization as jq
from deeplearningexamples_tpu_torch.ops import quantization as tq
from torch_threads import torch_one_thread  # noqa: F401


def _weights():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(64, 32)) * np.linspace(0.1, 2.0, 32)).astype(np.float32)


def _conv_weights():
    return np.random.default_rng(0).normal(size=(3, 3, 8, 16)).astype(np.float32)


def _acts(seed=1, shape=(128, 128)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", ["2d-axis1", "2d-axis0", "4d-axis3"])
def test_per_channel_quant_and_dequant_equal_jax(case):
    w, axis = {"2d-axis1": (_weights(), 1), "2d-axis0": (_weights(), 0),
               "4d-axis3": (_conv_weights(), 3)}[case]
    jqw, js = jq.quantize_per_channel(jnp.asarray(w), axis=axis)
    tqw, ts = tq.quantize_per_channel(torch.from_numpy(w), axis=axis)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.dequantize(tqw, ts).numpy(),
                                  np.asarray(jq.dequantize(jqw, js)))


@pytest.mark.parametrize("kind", ["per_channel", "per_tensor"])
def test_fake_quant_and_its_gradient_equal_jax(kind):
    """Forward bit for bit; the straight-through gradient under a random
    cotangent and under ones, where the absmax elements tie with the clip
    bound and take 0.5, as jnp.clip gives."""
    w = _conv_weights()
    jfn = (lambda x: jq.fake_quantize(x, -1)) if kind == "per_channel" \
        else jq.fake_quantize_per_tensor
    tfn = (lambda x: tq.fake_quantize(x, -1)) if kind == "per_channel" \
        else tq.fake_quantize_per_tensor
    cots = [np.ones_like(w),
            np.random.default_rng(5).normal(size=w.shape).astype(np.float32)]
    for cot in cots:
        want_y, vjp = jax.vjp(jfn, jnp.asarray(w))
        (want_g,) = vjp(jnp.asarray(cot))
        x = torch.from_numpy(w).requires_grad_()
        y = tfn(x)
        y.backward(torch.from_numpy(cot))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want_g))
    g = x.grad.numpy() / cots[-1]
    assert np.isclose(g, 0.5).sum() == (16 if kind == "per_channel" else 1)
    assert np.isclose(g, 1.0).sum() == g.size - np.isclose(g, 0.5).sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_round_equals_jax_given_its_uniforms(dtype):
    x = jnp.asarray(_acts(), dtype)
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    for seed in range(4):
        want_q, want_scale = jq.quantize_activations(x, seed)
        noise = jax.random.uniform(jax.random.key(jnp.asarray(seed, jnp.uint32)),
                                   x.shape)
        scale = tq._scale(xt)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
        q = tq.stochastic_round(xt, scale, torch.tensor(np.asarray(noise)))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))


def test_philox_matches_random123_known_answers():
    """Philox4x32-10 against the known-answer vectors of Random123, whose
    generator the kernel and the plain version both write out."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = tq.philox4x32_10(tuple(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want


def test_philox_uniforms_grid_range_and_moments():
    n = 1_000_003
    u = tq.philox_uniform(7, n)
    assert u.dtype == torch.float32 and u.shape == (n,)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    k = u.double() * 2**23
    assert torch.equal(k, torch.floor(k))  # on the 2^-23 grid
    # mean 1/2 and variance 1/12 of U[0, 1), to about 5 standard errors
    assert abs(float(u.double().mean()) - 0.5) < 5 * (1 / 12 / n) ** 0.5
    assert abs(float(u.double().var()) - 1 / 12) < 5 * (1 / 180 / n) ** 0.5
    # keyed on (seed, element index): a prefix draws the same numbers, and the
    # high word of a 64-bit seed is part of the key
    assert torch.equal(tq.philox_uniform(7, 1001), u[:1001])
    assert not torch.equal(tq.philox_uniform(7 + 2**32, 1001), u[:1001])
    assert not torch.equal(tq.philox_uniform(8, 1001), u[:1001])


def test_activation_quant_unbiased_over_seeds():
    """tests/test_quantization.py's statistics, on the port's draws: the mean
    of 16 dequantized draws is closer to x than one draw; every draw is
    within one step of x, but for fp32's rounding (where x / scale + u
    rounds up to the next integer, q lands a step and up to an ulp of
    x / scale away, as it does in JAX)."""
    x = torch.from_numpy(_acts())
    acc = torch.zeros(x.shape, dtype=torch.float64)
    n = 16
    for s in range(n):
        q, scale = tq.quantize_activations(x, seed=s)
        assert q.dtype == torch.int8 and q.shape == x.shape and scale.dim() == 0
        deq = q.double() * float(scale)
        assert float((deq - x.double()).abs().max()) <= float(scale) * (1 + 2**-16)
        acc += deq
    q0, s0 = tq.quantize_activations(x, 0)
    single_err = float((q0.double() * float(s0) - x.double()).abs().mean())
    bias = float((acc / n - x.double()).abs().mean())
    assert bias < single_err / 2
    assert tq.launches == 0  # CPU tensors never reach the kernel


def test_int8_matmul_equals_jax_given_the_same_q(monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.1).astype(np.float32)
    jw_q, jw_s = jq.quantize_per_channel(jnp.asarray(w), axis=1)
    jw_s = jw_s[0][None, :]
    want = jq.int8_matmul(jnp.asarray(x), jw_q, jw_s, seed=3)
    # the port given JAX's quantized activations and scale
    jx_q, jx_s = jq.quantize_activations(jnp.asarray(x), 3)
    with monkeypatch.context() as m:
        m.setattr(tq, "quantize_activations", lambda x, seed: (
            torch.tensor(np.asarray(jx_q)), torch.tensor(np.asarray(jx_s))))
        got = tq.int8_matmul(torch.from_numpy(x), torch.tensor(np.asarray(jw_q)),
                             torch.tensor(np.asarray(jw_s)), seed=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and with its own draws, within the JAX test's 2% of the fp32 product
    w_q, w_s = tq.quantize_per_channel(torch.from_numpy(w), axis=1)
    out = tq.int8_matmul(torch.from_numpy(x), w_q, w_s[0][None, :], seed=3)
    ref = torch.from_numpy(x) @ torch.from_numpy(w)
    assert out.dtype == torch.float32 and out.shape == (32, 48)
    assert float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref)) < 0.02
    with pytest.raises(ValueError, match="int8"):
        tq.int8_matmul(torch.from_numpy(x), w_q.float(), w_s)
    with pytest.raises(ValueError, match="dtype"):
        tq.quantize_activations(torch.zeros(4, 4, dtype=torch.float16))
