"""The port's CUDA kernels against their plain versions, on the card: the
flash-attention forward (K1) and backward (K2), the flat LAMB passes (K3, at
the flat layout's 64 x 1024 blocks and the fused LAMB's 8 x 1024), the
embedding row gather (K4), the int8 activation quantization (K5) and the
hot-row gather (K6), and the data plane's resample kernel with nvJPEG.

Every test here needs a CUDA card and skips without one. The file imports no
JAX, so that a CUDA host without JAX runs it on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from deeplearningexamples_tpu_torch.core import flat
from deeplearningexamples_tpu_torch.ops import embedding as emb
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.ops import fused_lamb as fused
from deeplearningexamples_tpu_torch.ops import quantization as quant

# kernel vs plain: the online softmax sums in another order (fp32); P rounds
# to bf16 against another running maximum (bf16); lse stays fp32 on both
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}

# The bf16 kernels tile by 64 queries and 64 keys on the tensor cores, 16
# rows a warp: ragged S, D=128, a causal dead row (a masked key prefix), the
# dropout hash, Sk != Sq and one live query row (Sq = 1) test that tiling. Every case's last batch row has
# every key masked.
CASES = [
    dict(layout="bshd", d=64, s=384),
    dict(layout="bhsd", d=64, s=200),
    dict(layout="bshd", d=32, s=130),
    dict(layout="bshd", d=128, s=96),
    dict(layout="bshd", d=64, s=300, causal=True),
    dict(layout="bhsd", d=64, s=256, rate=0.1, seed=-99),
    dict(layout="bshd", d=64, s=130),
    dict(layout="bshd", d=64, s=520),
    dict(layout="bshd", d=128, s=300),
    dict(layout="bhsd", d=64, s=300, causal=True, dead=70),
    dict(layout="bshd", d=64, s=130, rate=0.1, seed=12345),
    dict(layout="bshd", d=64, s=96, sk=200),
    dict(layout="bhsd", d=128, s=200, sk=96, causal=True, dead=40),
    # the encoder-decoder models: a decoder's causal S=63, cross-attention
    # at Sq=63 against Sk=64, and at Sq=1 (each cached decode step)
    dict(layout="bshd", d=64, s=63, causal=True, masked=False),
    dict(layout="bshd", d=64, s=63, sk=64),
    dict(layout="bshd", d=64, s=1, sk=64),
    dict(layout="bshd", d=64, s=1, sk=1024, h=16),
    # head dims off the tile widths run the next width with narrower copies:
    # BERT's 4l-312 student (26: 52-byte heads, 4-byte copies), 80 (8-byte
    # copies at h=3) and 1
    dict(layout="bshd", d=26, s=128, h=12, rate=0.1, seed=5),
    dict(layout="bhsd", d=26, s=200, causal=True, dead=70),
    dict(layout="bshd", d=80, s=130, h=3),
    dict(layout="bshd", d=1, s=96, sk=130),
    # the binned pretraining loader's bucket lengths at BERT-Large's heads
    dict(layout="bshd", d=64, s=64, h=16),
    dict(layout="bshd", d=64, s=192, h=16),
    dict(layout="bshd", d=64, s=448, h=16),
    # the speech models: FastPitch's one head of 64 over 900 mel frames with
    # attention dropout, its 32-symbol encoder, and wav2vec2's unmasked
    # 12 heads over one second's 49 frames
    dict(layout="bshd", d=64, s=900, h=1, rate=0.1, seed=-7),
    dict(layout="bshd", d=64, s=32, h=1, rate=0.1, seed=3),
    dict(layout="bhsd", d=64, s=49, h=12, masked=False),
    # a data rank's rows: the dropout hash's batch row is offset + b
    dict(layout="bshd", d=64, s=128, b=4, h=16, rate=0.1, seed=-3, offset=32),
    dict(layout="bhsd", d=26, s=130, b=3, rate=0.1, seed=9, offset=7),
]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(layout, b, h, s, d, dtype, device, seed=0, sk=None, dead=0):
    """q, k, v and a key mask whose last batch row has every key masked;
    ``dead`` masks the first keys of batch row 0 as well, so that under
    causal masking its first ``dead`` query rows see no key."""
    sk = sk or s
    rng = np.random.default_rng(seed)

    def shape(n):
        return (b, n, h, d) if layout == "bshd" else (b, h, n, d)

    q, k, v = (torch.from_numpy(rng.normal(size=shape(n)).astype(np.float32))
               .to(device, dtype) for n in (s, sk, sk))
    mask = torch.ones((b, sk), dtype=torch.int32)
    mask[0, sk - 13:] = 0
    mask[0, :dead] = 0
    mask[-1] = 0
    return q, k, v, mask.to(device)


def _case_inputs(case, dtype, device):
    q, k, v, mask = _inputs(case["layout"], case.get("b", 2), case.get("h", 4),
                            case["s"], case["d"], dtype, device,
                            sk=case.get("sk"), dead=case.get("dead", 0))
    kw = dict(causal=case.get("causal", False), layout=case["layout"],
              dropout_rate=case.get("rate", 0.0),
              dropout_seed=case.get("seed", 0),
              dropout_batch_offset=case.get("offset", 0))
    return q, k, v, (mask if case.get("masked", True) else None), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_flash_fwd_matches_plain(cuda, dtype, case):
    q, k, v, mask, kw = _case_inputs(case, dtype, cuda)
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref, ref_lse = fa.mha_reference(q, k, v, mask, kw["causal"],
                                    layout=kw["layout"],
                                    dropout_rate=kw["dropout_rate"],
                                    dropout_seed=kw["dropout_seed"],
                                    dropout_batch_offset=kw[
                                        "dropout_batch_offset"])
    tol_out, tol_lse = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol_out, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=tol_lse, rtol=0)


@pytest.mark.cuda
def test_flash_fwd_raises_on_what_it_does_not_take(cuda):
    q, k, v, mask = _inputs("bshd", 2, 4, 64, 64, torch.bfloat16, cuda)
    wide = torch.zeros((2, 64, 4, 136), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(wide, wide, wide, layout="bshd")
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
    dict(layout="bshd", d=64, s=130),
    dict(layout="bshd", d=64, s=520),
    dict(layout="bshd", d=128, s=300),
    dict(layout="bhsd", d=64, s=300, causal=True, dead=70),
    dict(layout="bshd", d=64, s=130, rate=0.1, seed=12345),
    dict(layout="bshd", d=64, s=96, sk=200),
    dict(layout="bhsd", d=128, s=200, sk=96, causal=True, dead=40),
    dict(layout="bshd", d=64, s=63, causal=True, masked=False),
    dict(layout="bshd", d=64, s=63, sk=64),
    dict(layout="bshd", d=64, s=1, sk=64),
    dict(layout="bshd", d=26, s=128, h=12, rate=0.1, seed=5),
    dict(layout="bhsd", d=26, s=200, causal=True, dead=70),
    dict(layout="bshd", d=80, s=130, h=3),
    dict(layout="bshd", d=1, s=96, sk=130),
    dict(layout="bshd", d=64, s=64, h=16),
    dict(layout="bshd", d=64, s=448, h=16),
    dict(layout="bshd", d=64, s=900, h=1, rate=0.1, seed=-7),
    dict(layout="bshd", d=64, s=32, h=1, rate=0.1, seed=3),
    dict(layout="bhsd", d=64, s=49, h=12, masked=False),
    # a data rank's rows: the dropout hash's batch row is offset + b
    dict(layout="bshd", d=64, s=128, b=4, h=16, rate=0.1, seed=-3, offset=32),
    dict(layout="bhsd", d=26, s=130, b=3, rate=0.1, seed=9, offset=7),
]


def _backward(q, k, v, mask, kw, dout):
    """One forward and backward through the autograd function; returns
    (out, lse, dq, dk, dv)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 1,
                                                         before[1] + 1)
    return out.detach(), lse, q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_flash_bwd_matches_plain(cuda, dtype, case):
    q, k, v, mask, kw = _case_inputs(case, dtype, cuda)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda, dtype)
    out, lse, *grads = _backward(q, k, v, mask, kw, dout)
    want = fa.mha_backward_reference(
        q, k, v, mask, out, lse, dout, kw["causal"], layout=kw["layout"],
        dropout_rate=kw["dropout_rate"], dropout_seed=kw["dropout_seed"],
        dropout_batch_offset=kw["dropout_batch_offset"])
    for name, got, ref in zip("qkv", grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        assert err <= TOL_BWD[dtype] * scale, f"d{name}: {err} vs {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(cuda, dtype):
    """Each dq, dk and dv element is written by one block from sums in a
    fixed order, so two runs on the same inputs agree bit for bit."""
    case = dict(layout="bshd", d=64, s=300, causal=True, dead=70, rate=0.1,
                seed=7)
    q, k, v, mask, kw = _case_inputs(case, dtype, cuda)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(
        cuda, dtype)
    first = _backward(q, k, v, mask, kw, dout)[2:]
    second = _backward(q, k, v, mask, kw, dout)[2:]
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name} differs between two runs"


@pytest.mark.cuda
def test_flash_misaligned_views_and_sliced_head_dims_match_plain(cuda):
    """Views whose start or head stride is not whole 16 bytes, and a head
    dim sliced out of a wider one, are read in place with narrower copies
    (2 bytes off a 16-byte start, 8 at a head stride of 68 bf16), forward
    and backward, in bf16 and fp32, and agree with the plain versions; only
    a head dim above 128 raises, before any launch."""
    b, s, h, d = 2, 64, 4, 64
    flat_buf = torch.randn(b * s * h * d + 1, device=cuda)
    wide = torch.randn(b, s, h, d + 4, device=cuda)
    views = {"offset": lambda t: t[1:].view(b, s, h, d),
             "head stride": lambda t: t[..., :d],
             "head dim 40 of 68": lambda t: t[..., :40]}
    for what, view in views.items():
        src = flat_buf if what == "offset" else wide
        for dtype in (torch.bfloat16, torch.float32):
            q = view(src.to(dtype)).detach().requires_grad_()
            good = torch.randn(q.shape, device=cuda, dtype=dtype)
            good.requires_grad_()
            out = fa.flash_attention(q, good, good, layout="bshd")
            want, lse = fa.mha_reference(q.detach(), good.detach(),
                                         good.detach(), layout="bshd")
            torch.testing.assert_close(out.float(), want.float(),
                                       atol=TOL[dtype][0], rtol=0)
            dout = view(src.to(dtype))
            out.backward(dout)
            ref = fa.mha_backward_reference(q.detach(), good.detach(),
                                            good.detach(), None, want, lse,
                                            dout, layout="bshd")
            got = (q.grad, good.grad)
            for name, g, r in (("dq", got[0], ref[0]),
                               ("dk + dv", got[1],
                                ref[1].float() + ref[2].float())):
                err = float((g.float() - r.float()).abs().max())
                scale = float(r.float().abs().max())
                assert err <= 2 * TOL_BWD[dtype] * scale, f"{what} {name}"
    big = torch.zeros((b, s, h, 136), device=cuda, dtype=torch.bfloat16)
    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(big, big, big, layout="bshd")
    assert (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv) == before


@pytest.mark.cuda
@pytest.mark.parametrize("block", flat.BLOCKS)
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_flat_lamb_kernels_match_plain(cuda, moments, block):
    """Three steps of both passes on the card against the plain versions on
    the same card, at either block size."""
    layout = flat.make_layout_blocked(
        [("w", (1024, 1000)), ("b", (1000,)), ("e", (3000, 64))], block)
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
        part_k = flat.flat_lamb_moments(g, kp, km, kv, seg, wd, hyp, block)
        flat.flat_lamb_apply(kp, km, kv, seg, wd, hyp, scale, block)
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


@pytest.mark.cuda
def test_fused_lamb_k3_at_8k_blocks_matches_the_plain_pair(cuda):
    """The fused LAMB's passes on the card, K3 at 8 x 1024-element blocks,
    against JAX's pair as written (u stored between the passes) on the same
    card: the kernel may fuse a multiply-add that the plain version rounds
    twice, an fp32 ulp in m and v, and the norms sum in another order."""
    layout = flat.make_layout_blocked(
        [("w", (1024, 1000)), ("b", (1000,)), ("e", (3000, 64)), ("s", ())],
        fused.BLOCK)
    rows = layout.total // flat.LANES
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(rows, flat.LANES, generator=gen).to(cuda)
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32, device=cuda)
    wd = torch.tensor([0.01, 0.0, 0.01, 0.01], device=cuda)
    index = torch.as_tensor(flat.leaf_index(layout), device=cuda)
    out = {}
    for name, passes in (("kernel", fused.passes_kernel),
                         ("plain", fused.passes_plain)):
        p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        g_gen = torch.Generator().manual_seed(1)
        before = (flat.launches_moments, flat.launches_apply)
        for t in range(1, 4):
            g = torch.randn(rows, flat.LANES, generator=g_gen).to(cuda)
            hyp = flat.step_hyp(0.9, 0.999, 1e-6, t, [g], 1.0)
            passes(g, p, m, v, seg, wd, hyp, 1e-2 * t, index)
        torch.cuda.synchronize()
        launched = (flat.launches_moments - before[0],
                    flat.launches_apply - before[1])
        assert launched == ((3, 3) if name == "kernel" else (0, 0))
        out[name] = (p, m, v)
    (kp, km, kv), (pp, pm, pv) = out["kernel"], out["plain"]
    for got, want in ((km, pm), (kv, pv)):
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
    torch.testing.assert_close(kp, pp, rtol=1e-5, atol=1e-5)


# K5 against its plain version: the same Philox words, the same IEEE fp32
# division, floor and clip, so q is equal bit for bit. Shapes not a multiple
# of a thread's 4 (fp32) or 8 (bf16) elements take the ragged path.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (3, 5), (17, 33), (1000, 1003),
                                   (3072, 1024)])
def test_quantize_activations_matches_plain(cuda, dtype, shape):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=gen) * 3).to(cuda, dtype)
    for seed in (0, 12345, 2**40 + 7, -1):
        before = quant.launches
        q, scale = quant.quantize_activations(x, seed)
        torch.cuda.synchronize()
        assert quant.launches == before + 1
        want_q, want_scale = quant.quantize_activations_reference(x, seed)
        assert q.dtype == torch.int8 and q.shape == x.shape
        assert torch.equal(scale, want_scale)
        assert torch.equal(q, want_q), f"seed {seed}: {(q != want_q).sum()} differ"


@pytest.mark.cuda
def test_quantize_unaligned_input_and_int8_matmul(cuda):
    """An x 4 bytes into its storage takes the element-wise path; the int8
    GEMM equals the plain product of the plain q, is within the JAX test's
    2% of fp32, and raises on shapes the card's int8 GEMM refuses."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4097, generator=gen).to(cuda)[1:]
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    assert torch.equal(quant.quantize_activations(x, 3)[0],
                       quant.quantize_activations_reference(x, 3)[0])
    xm = torch.randn(32, 64, generator=gen).to(cuda)
    w_q, w_s = quant.quantize_per_channel(torch.randn(64, 48, generator=gen).to(cuda)
                                          * 0.1, axis=1)
    w_s = w_s[0][None, :]
    out = quant.int8_matmul(xm, w_q, w_s, seed=5)
    q, s = quant.quantize_activations_reference(xm, 5)
    assert torch.equal(out, torch._int_mm(q, w_q).float() * s * w_s)
    ref = xm @ quant.dequantize(w_q, w_s)
    assert float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref)) < 0.02
    with pytest.raises(ValueError, match="M > 16"):
        quant.int8_matmul(xm[:16], w_q, w_s)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(xm[:, :60], w_q[:60], w_s)


# K4 against its plain version: a gather is a copy, so rows from the table
# are bitwise equal and the NaN rows (indices outside [-V, V)) fall in the
# same places. D=6 (fp32 24-byte rows) and D=100 in bf16 (200 bytes) take the
# kernel's 4- and 2-byte path, the others its 16-byte path.
def _gather_case(device, dtype, v, d, n, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(
        device, dtype)
    idx = rng.integers(-v, v, n).astype(np.int32)
    edge = np.array([-v - 1, v, v + 9, 2**31 - 1, -2**31], np.int32)
    idx[rng.choice(n, size=min(n, 5), replace=False)] = edge[:min(n, 5)]
    return table, torch.from_numpy(idx).to(device)


def _assert_same_rows(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 128, 6, 100])
@pytest.mark.parametrize("n", [1, 4097, 100003])
def test_gather_rows_matches_plain(cuda, dtype, d, n):
    table, idx = _gather_case(cuda, dtype, 1000, d, n)
    before = emb.launches
    got = emb.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert emb.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    _assert_same_rows(got, emb.gather_rows_reference(table, idx))


@pytest.mark.cuda
def test_gather_rows_unaligned_table_and_cpu_tensors(cuda):
    """A table that starts 4 bytes into its storage takes the unit path; a
    CPU tensor never reaches the kernel; nothing launches for N=0."""
    base, idx = _gather_case(cuda, torch.float32, 1001, 8, 5000)
    table = base.view(-1)[1:1 + 1000 * 8].view(1000, 8)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    _assert_same_rows(emb.gather_rows(table, idx),
                      emb.gather_rows_reference(table, idx))
    before = emb.launches
    emb.gather_rows(table.cpu(), idx.cpu())
    assert emb.gather_rows(table, idx[:0]).shape == (0, 8)
    assert emb.launches == before
    with pytest.raises(ValueError, match="device"):
        emb.gather_rows(table, idx.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scatter", "sorted"])
def test_embedding_lookup_on_the_card_matches_the_cpu(cuda, mode):
    """Forward through K4, backward by index_add_: fp32 atomics add in no
    fixed order, so a row that several lookups hit may differ in its last
    bits (1e-6 of the largest entry)."""
    table, idx = _gather_case("cpu", torch.float32, 3000, 32, 6000)
    idx = idx.clamp(-3000, 2999).view(2000, 3)
    cot = torch.randn(2000, 3, 32, generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        t = table.detach().to(dev).requires_grad_()
        y = emb.embedding_lookup(t, idx.to(dev), grad=mode)
        y.backward(cot.to(dev))
        out[str(dev)] = (y.detach().cpu(), t.grad.cpu())
    (y_cpu, g_cpu), (y_gpu, g_gpu) = out["cpu"], out[str(cuda)]
    assert torch.equal(y_gpu, y_cpu)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-6 * float(g_cpu.abs().max()))


# K6 against its plain version: a copy from one of two sources, so rows are
# bitwise equal and ids outside [0, V) give NaN rows in the same places.
# D=6 fp32 and D=100 bf16 take the 4- and 2-byte path.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 128, 6, 100])
@pytest.mark.parametrize("n", [1, 4097, 100003])
def test_hot_gather_matches_plain(cuda, dtype, d, n):
    rpt, k_hot, tables = 1000, 64, 4
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(tables * rpt, d)).astype(
        np.float32)).to(cuda, dtype)
    hot = torch.from_numpy(rng.normal(size=(tables * k_hot, d)).astype(
        np.float32) + 100).to(cuda, dtype)  # not the table's head
    ids = rng.integers(-2, tables * rpt + 2, n).astype(np.int32)
    ids[:min(n, 3)] = [0, tables * rpt - 1, 2**31 - 1][:min(n, 3)]
    ids = torch.from_numpy(ids).to(cuda)
    before = emb.launches_hot
    got = emb.hot_gather(table, hot, ids, rpt, k_hot)
    torch.cuda.synchronize()
    assert emb.launches_hot == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    _assert_same_rows(got, emb.hot_gather_reference(table, hot, ids, rpt, k_hot))


@pytest.mark.cuda
def test_hot_gather_unaligned_table(cuda):
    """A table 4 bytes into its storage takes the unit path."""
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.normal(size=(2001, 8)).astype(np.float32)).to(cuda)
    table = base.view(-1)[1:1 + 2000 * 8].view(2000, 8)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    hot = torch.from_numpy(rng.normal(size=(2 * 16, 8)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 2000, 5000).astype(np.int32)).to(cuda)
    _assert_same_rows(emb.hot_gather(table, hot, ids, 1000, 16),
                      emb.hot_gather_reference(table, hot, ids, 1000, 16))


# The data plane's resample kernel against its plain version: the same fp32
# operations in the same order (no FMA contraction in the kernel), so the
# outputs are equal bit for bit; gray and RGB images, 1/d of 1 to 8, flips,
# an image that failed (width 0).
@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [7, 64, 224])
def test_resample_normalize_matches_plain(cuda, out_size):
    from deeplearningexamples_tpu_torch.native import MEAN, STD
    from deeplearningexamples_tpu_torch.ops import resample

    rng = np.random.default_rng(out_size)
    dims = [(64, 48, 3, 1), (48, 64, 1, 1), (300, 200, 3, 2), (257, 131, 3, 4),
            (500, 375, 3, 8), (0, 0, 0, 0), (33, 17, 1, 2)]
    sizes = [w * h * c for w, h, c, _ in dims]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    src = rng.integers(0, 256, sum(sizes), dtype=np.uint8)
    n = len(dims)
    crops = np.stack([rng.uniform(0, .3, n), rng.uniform(0, .3, n),
                      rng.uniform(.3, .7, n), rng.uniform(.3, .7, n)], 1)
    args = [torch.from_numpy(a).to(cuda) for a in (
        src, offsets.astype(np.int64), np.asarray(dims, np.int32),
        crops.astype(np.float32), (np.arange(n) % 2).astype(np.int32))]
    before = resample.launches
    got = resample.resample_normalize(*args, out_size, MEAN, STD)
    torch.cuda.synchronize()
    assert resample.launches == before + 1
    want = resample.resample_normalize_reference(*args, out_size, MEAN, STD)
    assert got.shape == (n, out_size, out_size, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not got[5].any()


# The card's data plane (nvJPEG, then the kernel) on the repository's JPEG
# fixtures against JAX's plane (expected.npz): chip_smoke.py's TOL_DECODE in
# pixel levels, the cut file zero-filled with a warning.
@pytest.mark.cuda
def test_card_data_plane_decodes_the_fixtures(cuda):
    from pathlib import Path

    from deeplearningexamples_tpu_torch.native import STD, DataPlane

    root = Path(__file__).resolve().parent / "data" / "jpeg"
    e = np.load(root / "expected.npz")
    blobs = [(root / f"{n}.jpg").read_bytes() for n in e["names"]]
    with pytest.warns(UserWarning, match="1 images failed to decode"):
        got = DataPlane(4, "cuda").decode_batch(blobs, e["crops"], e["flips"],
                                                int(e["out_size"]))
    assert got.device.type == "cuda"
    levels = np.abs(got.cpu().numpy() - e["images"]) * np.float32(STD) * 255
    assert levels.max() <= 8.0 and levels.mean() <= 1.5
