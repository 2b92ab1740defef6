"""The port's CUDA kernels against their plain versions, on the card: the
flash-attention forward (K1) and backward (K2) and the flat LAMB passes (K3).

Every test here needs a CUDA card and skips without one. The file imports no
JAX, so that a CUDA host without JAX runs it on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from deeplearningexamples_tpu_torch.core import flat
from deeplearningexamples_tpu_torch.ops import flash_attention as fa

# kernel vs plain: the online softmax sums in another order (fp32); P rounds
# to bf16 against another running maximum (bf16); lse stays fp32 on both
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}

CASES = [
    dict(layout="bshd", d=64, s=384),
    dict(layout="bhsd", d=64, s=200),
    dict(layout="bshd", d=32, s=130),
    dict(layout="bshd", d=128, s=96),
    dict(layout="bshd", d=64, s=300, causal=True),
    dict(layout="bhsd", d=64, s=256, rate=0.1, seed=-99),
]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(layout, b, h, s, d, dtype, device, seed=0):
    """q, k, v and a key mask whose last batch row has every key masked."""
    rng = np.random.default_rng(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[0, s - 13:] = 0
    mask[-1] = 0
    return q, k, v, mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_flash_fwd_matches_plain(cuda, dtype, case):
    q, k, v, mask = _inputs(case["layout"], 2, 4, case["s"], case["d"], dtype,
                            cuda)
    kw = dict(causal=case.get("causal", False), layout=case["layout"],
              dropout_rate=case.get("rate", 0.0),
              dropout_seed=case.get("seed", 0))
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref, ref_lse = fa.mha_reference(q, k, v, mask, kw["causal"],
                                    layout=kw["layout"],
                                    dropout_rate=kw["dropout_rate"],
                                    dropout_seed=kw["dropout_seed"])
    tol_out, tol_lse = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol_out, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=tol_lse, rtol=0)


@pytest.mark.cuda
def test_flash_fwd_raises_on_what_it_does_not_take(cuda):
    q, k, v, mask = _inputs("bshd", 2, 4, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48], layout="bshd")
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half(), layout="bshd")
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(-1, -2)
        fa.flash_attention(t, t, t, layout="bshd")
    with pytest.raises(ValueError, match="dropout rate"):
        fa.flash_attention(q, k, v, mask, layout="bshd", dropout_rate=1.0)


# Backward against the plain backward, relative to the gradients' largest
# entry. fp32: the sums run in another order. bf16: dS and P are rounded to
# bf16 from fp32 values that differ in the last bits between the two, so an
# entry can move by one bf16 ulp before the dQ/dK/dV sums.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

BWD_CASES = [
    dict(layout="bshd", d=64, s=128),
    dict(layout="bhsd", d=64, s=200),
    dict(layout="bshd", d=32, s=130),
    dict(layout="bshd", d=128, s=96),
    dict(layout="bshd", d=64, s=300, causal=True),
    dict(layout="bhsd", d=64, s=2048, causal=True, masked=False, b=1, h=2),
    dict(layout="bshd", d=64, s=256, rate=0.1, seed=-99),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_flash_bwd_matches_plain(cuda, dtype, case):
    q, k, v, mask = _inputs(case["layout"], case.get("b", 2), case.get("h", 4),
                            case["s"], case["d"], dtype, cuda)
    if not case.get("masked", True):
        mask = None
    kw = dict(causal=case.get("causal", False), layout=case["layout"],
              dropout_rate=case.get("rate", 0.0),
              dropout_seed=case.get("seed", 0))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda, dtype)
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 1,
                                                         before[1] + 1)
    want = fa.mha_backward_reference(
        q.detach(), k.detach(), v.detach(), mask, out.detach(), lse, dout,
        kw["causal"], layout=kw["layout"], dropout_rate=kw["dropout_rate"],
        dropout_seed=kw["dropout_seed"])
    for name, got, ref in zip("qkv", (q.grad, k.grad, v.grad), want):
        assert got.dtype == dtype and got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        assert err <= TOL_BWD[dtype] * scale, f"d{name}: {err} vs {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_flat_lamb_kernels_match_plain(cuda, moments):
    """Three steps of both passes on the card against the plain versions on
    the same card."""
    layout = flat.make_layout_blocked(
        [("w", (1024, 1000)), ("b", (1000,)), ("e", (3000, 64))])
    rows = layout.total // flat.LANES
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(rows, flat.LANES, generator=gen).to(cuda)
    m = torch.zeros(rows, flat.LANES, dtype=moments, device=cuda)
    v = torch.zeros_like(m)
    state = {"kernel": [p.clone(), m.clone(), v.clone()],
             "plain": [p.clone(), m.clone(), v.clone()]}
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32, device=cuda)
    wd = torch.tensor([0.01, 0.0, 0.01], device=cuda)
    for t in range(1, 4):
        g = torch.randn(rows, flat.LANES, generator=gen).to(cuda)
        hyp = torch.tensor([0.9, 0.999, 1e-6, 1 - 0.9**t, 1 - 0.999**t, 0.7],
                           device=cuda)
        scale = torch.tensor([0.01, 0.02, 0.03], device=cuda)
        kp, km, kv = state["kernel"]
        before = (flat.launches_moments, flat.launches_apply)
        part_k = flat.flat_lamb_moments(g, kp, km, kv, seg, wd, hyp)
        flat.flat_lamb_apply(kp, km, kv, seg, wd, hyp, scale)
        assert (flat.launches_moments, flat.launches_apply) == (
            before[0] + 1, before[1] + 1)
        pp, pm, pv = state["plain"]
        part_p = flat._moments_plain(g, pp, pm, pv, seg, wd, hyp)
        flat._apply_plain(pp, pm, pv, seg, wd, hyp, scale)
        torch.cuda.synchronize()
        # the kernel may fuse b1*m + (1-b1)*g into one rounding: an fp32 ulp,
        # and a bf16 moment one ulp apart where that ulp crosses a boundary
        # (and where b1*m and (1-b1)*g nearly cancel, that ulp of theirs is
        # large against the result: hence atol against the moments' scale)
        mt = 1e-6 if moments == torch.float32 else 8e-3
        for got, want in ((km, pm), (kv, pv)):
            torch.testing.assert_close(got.float(), want.float(), rtol=mt,
                                       atol=1e-6 * float(want.float().abs().max()))
        torch.testing.assert_close(part_k, part_p, rtol=1e-4, atol=0)
        # a bf16 moment one ulp apart moves u by 2**-8 of itself, times scale
        torch.testing.assert_close(kp, pp, rtol=1e-5,
                                   atol=1e-5 if moments == torch.float32 else 3e-4)
