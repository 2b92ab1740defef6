"""Port parity: the tree LAMB, the flat layout and the flat fused LAMB against
the JAX package.

The tree LAMB (``ops/lamb.py``) is fed the same gradients as JAX's
``ops.lamb.lamb``; the flat LAMB trains the same small model as JAX's
``core.flat.flatten_train`` + ``make_train_step``, whose Pallas kernels run in
interpret mode on the CPU, while the port runs the plain versions of its two
CUDA passes. Everything comes from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from deeplearningexamples_tpu.core.flat import (
    _make_layout_blocked,
    flatten_train as jax_flatten_train,
    unflatten as jax_unflatten,
)
from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.ops.lamb import lamb as jax_lamb
from deeplearningexamples_tpu_torch.core import flat
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deeplearningexamples_tpu_torch.ops.lamb import lamb
from deeplearningexamples_tpu_torch.utils.jax_bridge import bert_pretrain_jax_order

# fp32 moments: the same fp32 arithmetic, but the norms sum in another order
# and torch may fuse a multiply-add that XLA rounds twice
RTOL_F32, ATOL_F32 = 2e-5, 1e-6
# bf16 moments: an fp32 moment one ulp away from a bf16 rounding boundary
# rounds the other way, which moves u by a bf16 ulp (2**-8) for that element
RTOL_BF16, ATOL_BF16 = 2e-5, 5e-5

SHAPES = {"dense": {"kernel": (64, 32), "bias": (32,)},
          "ln": {"scale": (64,), "bias": (64,)}}
# the port's names: a LayerNorm module holds what JAX calls ln/scale, bias
PORT = {("dense", "kernel"): "dense.kernel", ("dense", "bias"): "dense.bias",
        ("ln", "scale"): "LayerNorm.scale", ("ln", "bias"): "LayerNorm.bias"}
JAX_ORDER = ["dense.bias", "dense.kernel", "LayerNorm.bias", "LayerNorm.scale"]


def _arrays(rng, scale=1.0):
    return {a: {b: (rng.normal(size=s) * scale).astype(np.float32)
                for b, s in leaves.items()} for a, leaves in SHAPES.items()}


def _port(tree):
    return {PORT[(a, b)]: torch.tensor(v) for a, leaves in tree.items()
            for b, v in leaves.items()}


def _assert_tree_close(port_params, jax_tree, rtol, atol):
    for (a, b), name in PORT.items():
        np.testing.assert_allclose(port_params[name].detach().numpy(),
                                   np.asarray(jax_tree[a][b]), rtol=rtol,
                                   atol=atol, err_msg=name)


TREE_CASES = {
    "fp32-clip-mask-schedule": dict(moments="fp32", clip=1.0, mask=True,
                                    schedule=True, nvlamb=False),
    "fp32-noclip-nvlamb": dict(moments="fp32", clip=None, mask=False,
                               schedule=False, nvlamb=True),
    "bf16-clip-mask-nvlamb": dict(moments="bf16", clip=1.0, mask=True,
                                  schedule=True, nvlamb=True),
    "bf16-noclip-mask": dict(moments="bf16", clip=None, mask=True,
                             schedule=False, nvlamb=False),
}


@pytest.mark.parametrize("name", list(TREE_CASES))
def test_tree_lamb_matches_jax(name):
    c = TREE_CASES[name]
    rng = np.random.default_rng(0)
    params = _arrays(rng)
    grads = [_arrays(rng, scale=3.0) for _ in range(4)]  # global norm >> 1
    jdt, tdt, rtol, atol = {
        "fp32": (jnp.float32, torch.float32, RTOL_F32, ATOL_F32),
        "bf16": (jnp.bfloat16, torch.bfloat16, RTOL_BF16, ATOL_BF16)}[c["moments"]]
    lr = (lambda count: 0.01 * (count + 1)) if c["schedule"] else 0.02
    jmask = {"dense": {"kernel": True, "bias": False},
             "ln": {"scale": False, "bias": False}} if c["mask"] else None
    kw = dict(weight_decay=0.01, grad_clip_norm=c["clip"], use_nvlamb=c["nvlamb"])
    jtx = jax_lamb(lr, mask=jmask, moment_dtype=jdt, **kw)
    ttx = lamb(lr, mask={n: n == "dense.kernel" for n in PORT.values()}
               if c["mask"] else None, moment_dtype=tdt, **kw)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = _port(params)
    ts = ttx.init(tp)
    for g in grads:
        upd, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = ttx.update(_port(g), ts, tp)
        for n in tp:
            tp[n] = tp[n] + tu[n]
    _assert_tree_close(tp, jp, rtol, atol)
    assert ts.count == 4 and ts.mu["dense.kernel"].dtype == tdt


def test_flat_layout_equals_jax():
    """The port lays BERT's parameters out offset for offset as JAX's
    ``_make_layout_blocked`` does, in JAX's leaf order."""
    cfg = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=256, max_position_embeddings=64)
    task = JaxPretrainTask(JaxBertConfig(**cfg), dtype=jnp.float32)
    # the layout reads shapes only
    jparams, _ = jax.eval_shape(
        lambda key: task.init(key, seq_len=16, batch=1), jax.random.key(0))
    want = _make_layout_blocked(jparams)
    with torch.device("meta"):
        model = BertForPreTraining(BertConfig(**cfg))
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    order = bert_pretrain_jax_order(cfg["num_layers"])
    got = flat.make_layout_blocked([(n, shapes[n]) for n in order])
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_array_equal(got.seg_ids, want.seg_ids)
    assert got.total == want.total and got.n_leaves == want.n_leaves
    assert sorted(order) == sorted(shapes)


class _TreeModel(nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.dense = nn.ParameterDict(
            {k: nn.Parameter(torch.tensor(v)) for k, v in tree["dense"].items()})
        self.LayerNorm = nn.ParameterDict(
            {k: nn.Parameter(torch.tensor(v)) for k, v in tree["ln"].items()})


def _jax_loss(p, ms, batch, rng):
    y = jnp.tanh(batch["x"] * p["ln"]["scale"] + p["ln"]["bias"]) @ p["dense"]["kernel"]
    y = y + p["dense"]["bias"]
    return jnp.mean((y - batch["y"]) ** 2), (ms, {})


def _torch_loss(model, ms, batch, generator):
    ln, dense = model.LayerNorm, model.dense
    y = torch.tanh(batch["x"] * ln["scale"] + ln["bias"]) @ dense["kernel"]
    y = y + dense["bias"]
    return ((y - batch["y"]) ** 2).mean(), (ms, {})


def _run_flat(moments, lr, steps=3):
    rng = np.random.default_rng(3)
    tree = _arrays(rng)
    batch = {"x": rng.normal(size=(8, 64)).astype(np.float32),
             "y": rng.normal(size=(8, 32)).astype(np.float32)}
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[moments]
    with jax.default_matmul_precision("highest"):
        jloss, jtx, jflat = jax_flatten_train(
            _jax_loss, jax.tree_util.tree_map(jnp.asarray, tree), lr=lr,
            weight_decay=0.01, moment_dtype=jdt)
        jstep = jax_make_train_step(jloss, jtx)
        js = jax_create_train_state(jflat, jtx, jax.random.key(0))
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        jm = []
        for _ in range(steps):
            js, m = jstep(js, jb)
            jm.append({k: float(v) for k, v in m.items()})
    jparams = jax_unflatten(jloss.layout, js.params, jloss.dtypes)

    model = _TreeModel(tree)
    ttx, tflat, _ = flat.flatten_train(model, lr=lr, weight_decay=0.01,
                                       moment_dtype=tdt, order=JAX_ORDER)
    state = create_train_state(model, ttx, 0, params=tflat)
    step = make_train_step(_torch_loss, ttx)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm = []
    for _ in range(steps):
        state, m = step(state, tb)
        tm.append({k: float(v) for k, v in m.items()})
    return dict(model.named_parameters()), jparams, tm, jm, state


@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_flat_lamb_plain_matches_jax_kernels(moments):
    rtol, atol = {"fp32": (RTOL_F32, ATOL_F32),
                  "bf16": (RTOL_BF16, ATOL_BF16)}[moments]
    tp, jp, tm, jm, state = _run_flat(moments, lr=lambda c: 0.01 * c)
    _assert_tree_close(tp, jp, rtol, atol)
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
    # the parameters are views of the flat buffer the kernels update
    assert state.params.data_ptr() <= tp["dense.kernel"].data_ptr() \
        < state.params.data_ptr() + state.params.numel() * 4
    assert flat.launches_moments == 0 and flat.launches_apply == 0


def test_schedule_index_differs_between_tree_and_flat_lamb():
    """JAX's tree LAMB reads lr at the update count before the increment
    (optax.scale_by_schedule); its flat LAMB at the count after it
    (core/flat.py:303-305). The port keeps both: with lr(0) = 0 the tree
    LAMB's first update is a no-op and the flat LAMB's is not."""
    rng = np.random.default_rng(5)
    params, g = _arrays(rng), _arrays(rng)
    sched = lambda count: 0.01 * count  # noqa: E731

    ttx = lamb(sched)
    tp = _port(params)
    tu, _ = ttx.update(_port(g), ttx.init(tp), tp)
    assert all(float(u.abs().max()) == 0.0 for u in tu.values())
    jtx = jax_lamb(sched)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ju, _ = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jtx.init(jp), jp)
    assert all(float(jnp.abs(u).max()) == 0.0 for u in jax.tree_util.tree_leaves(ju))

    tp_flat, jp_flat, *_ = _run_flat("fp32", lr=sched, steps=1)
    moved = tp_flat["dense.kernel"].detach().numpy() - params["dense"]["kernel"]
    assert np.abs(moved).max() > 0.0
    _assert_tree_close(tp_flat, jp_flat, RTOL_F32, ATOL_F32)


def test_flat_passes_plain_versions_in_place():
    """The two passes write m, v and p into the buffers they are given."""
    rng = np.random.default_rng(7)
    layout = flat.make_layout_blocked([("a", (70000,)), ("b", (10, 10))])
    rows = layout.total // flat.LANES
    g, p = (torch.from_numpy(rng.normal(size=(rows, flat.LANES)).astype(np.float32))
            for _ in range(2))
    m = torch.zeros_like(p, dtype=torch.bfloat16)
    v = torch.zeros_like(p, dtype=torch.bfloat16)
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32)
    wd = torch.tensor([0.01, 0.0])
    hyp = torch.tensor([0.9, 0.999, 1e-6, 0.1, 0.001, 0.5])
    partial = flat.flat_lamb_moments(g, p, m, v, seg, wd, hyp)
    assert partial.shape == (len(layout.seg_ids), 2)
    torch.testing.assert_close(m.float(), (0.1 * 0.5 * g).bfloat16().float(),
                               rtol=1e-2, atol=0)
    np.testing.assert_allclose(partial[:, 0].sum(), (p * p).sum(), rtol=1e-5)
    before = p.clone()
    flat.flat_lamb_apply(p, m, v, seg, wd, hyp, torch.tensor([0.1, 0.2]))
    assert not torch.equal(p, before)


def test_cpu_norms_are_exact_at_bert_large_sizes():
    """The clip and the trust ratio read norms of tensors as large as
    BERT-Large's word table; on the CPU they must not drift with the size."""
    from deeplearningexamples_tpu_torch.ops.lamb import global_norm, norms

    rng = np.random.default_rng(8)
    t = torch.from_numpy((rng.normal(size=4_000_000) * 1e-3 + 2e-4)
                         .astype(np.float32))
    want = float(t.double().norm())
    # a plain fp32 sum of this many elements is further off than this
    assert abs(float(norms([t])[0]) / want - 1) < 1e-5
    both = float(global_norm([t, t.bfloat16()]))
    assert abs(both / float(torch.stack(
        [t.double().norm(), t.bfloat16().double().norm()]).norm()) - 1) < 1e-5
