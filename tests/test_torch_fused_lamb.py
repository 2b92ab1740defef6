"""Port parity: the fused LAMB transform (``ops/fused_lamb.py``) against the
JAX package's ``fused_lamb``, whose Pallas kernels run in interpret mode.

The layout and the packed buffers must equal JAX's element for element;
three updates must land within ``tests/test_fused_lamb.py``'s own tolerance
(the norms sum in another order); K3's passes at 8 x 1024-element blocks must
give what JAX's pair gives; and a 2-layer BERT trains along JAX's loss curve.
On the CPU the port runs the plain versions of its passes; the card holds the
CUDA kernels to them (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.ops import fused_lamb as jf
from deeplearningexamples_tpu_torch.core import flat
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.models.bert import BertConfig, BertPretrainTask
from deeplearningexamples_tpu_torch.ops import fused_lamb as tf
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_pretrain_jax_order,
    bert_pretrain_state_dict_from_jax,
)
from test_torch_bert_pretrain import P, S, SMALL, _batch, _port_model, _torch_batch
from torch_threads import torch_one_thread  # noqa: F401

# tests/test_fused_lamb.py's tolerance: the same fp32 arithmetic, the norms
# summed in another order
RTOL, ATOL = 2e-5, 2e-6


def _tree(seed=0):
    """tests/test_fused_lamb.py's tree, as numpy."""
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.normal(size=(64, 128)).astype(np.float32),
                      "bias": rng.normal(size=(128,)).astype(np.float32)},
            "emb": rng.normal(size=(100, 32)).astype(np.float32)}


def _port(tree):
    return {"dense.kernel": torch.tensor(tree["dense"]["kernel"]),
            "dense.bias": torch.tensor(tree["dense"]["bias"]),
            "emb": torch.tensor(tree["emb"])}


def _assert_close(port, jtree):
    for name, want in (("dense.kernel", jtree["dense"]["kernel"]),
                       ("dense.bias", jtree["dense"]["bias"]),
                       ("emb", jtree["emb"])):
        np.testing.assert_allclose(port[name].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_layout_pack_and_unpack_equal_jax():
    tree = _tree()
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jf.make_layout(jparams)
    got = tf.make_layout(_port(tree))
    assert got.names == ("dense.bias", "dense.kernel", "emb")
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_array_equal(got.seg_ids, want.seg_ids)
    assert (got.total, got.n_leaves) == (want.total, want.n_leaves)
    assert got.total % tf.BLOCK == 0
    buf = tf.pack(got, _port(tree))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jf.pack(want, jparams)))
    back = tf.unpack(got, buf, _port(tree))
    for name, t in _port(tree).items():
        assert torch.equal(back[name], t)
    assert tf.tree_order(["b.c", "a_c", "a.z", "a.b"]) == ["a.b", "a.z", "a_c", "b.c"]


CASES = {
    "clip-none": dict(clip=None, wd=0.01, mask=None),
    "clip-1": dict(clip=1.0, wd=0.01, mask=None),
    "mask-wd0.5": dict(clip=None, wd=0.5,
                       mask={"dense": {"kernel": True, "bias": False}, "emb": False}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_lamb_matches_jax_over_three_steps(name):
    c = CASES[name]
    params, grads = _tree(), _tree(seed=1)
    jtx = jf.fused_lamb(0.01, weight_decay=c["wd"], mask=c["mask"],
                        grad_clip_norm=c["clip"])
    ttx = tf.fused_lamb(0.01, weight_decay=c["wd"], grad_clip_norm=c["clip"],
                        mask=None if c["mask"] is None else
                        {"dense.kernel": True, "dense.bias": False, "emb": False})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = _port(params)
    ts = ttx.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda x: x * (1.0 + step), grads)
        upd, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = ttx.update(_port(g), ts, tp)
        assert set(tu) == set(tp) and tu["emb"].dtype == torch.float32
        tp = {n: tp[n] + tu[n] for n in tp}
    _assert_close(tp, jp)
    assert ts.count == 3 and int(js.count) == 3
    for got, want in ((ts.flat_m, js.flat_m), (ts.flat_v, js.flat_v)):
        np.testing.assert_allclose(got.view(-1).numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-9)
    assert flat.launches_moments == flat.launches_apply == 0  # CPU: no kernel


def test_k3_passes_at_8k_blocks_equal_the_plain_fused_pair():
    """K3's two passes (their plain versions here, at 8 x 1024-element
    blocks) against JAX's pair as written, which stores u between its passes:
    three steps from the same buffers."""
    layout = flat.make_layout_blocked(
        [("w", (96, 100)), ("b", (100,)), ("e", (70, 300)), ("s", ())], tf.BLOCK)
    rows = layout.total // tf.LANES
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(rows, tf.LANES, generator=gen)
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32)
    wd = torch.tensor([0.01, 0.0, 0.01, 0.01])
    index = torch.as_tensor(flat.leaf_index(layout))
    out = {}
    for name, passes in (("k3", tf.passes_kernel), ("pair", tf.passes_plain)):
        p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        g_gen = torch.Generator().manual_seed(1)
        for t in range(1, 4):
            g = torch.randn(rows, tf.LANES, generator=g_gen)
            hyp = flat.step_hyp(0.9, 0.999, 1e-6, t, [g], 1.0)
            passes(g, p, m, v, seg, wd, hyp, 1e-2 * t, index)
        out[name] = (p, m, v)
    for got, want in zip(out["k3"], out["pair"]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert not torch.equal(out["k3"][0], p0)
    with pytest.raises(ValueError, match="block"):
        flat.flat_lamb_moments(p0, p0, p0.clone(), p0.clone(), seg, wd,
                               torch.ones(6), block=4096)


@pytest.fixture(scope="module")
def jax_params():
    task = JaxPretrainTask(JaxBertConfig(**SMALL), dtype=jnp.float32,
                           max_predictions=P)
    params = jax.jit(lambda key: task.init(key, seq_len=S, batch=1)[0])(
        jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, params)


def test_bert_pretrain_loss_curve_matches_jax_fused_lamb(jax_params):
    """A 2-layer BERT, 3 steps of each package's fused_lamb (weight decay
    on matrices only, as the JAX CLI masks it), from bridged weights."""
    steps, lr = 3, 1e-2
    jtask = JaxPretrainTask(JaxBertConfig(**SMALL), dtype=jnp.float32,
                            max_predictions=P)
    with jax.default_matmul_precision("highest"):
        params = jax.tree_util.tree_map(jnp.asarray, jax_params)
        jtx = jf.fused_lamb(lr, weight_decay=0.01,
                            mask=jax.tree_util.tree_map(lambda p: p.ndim > 1, params))
        # no donation: JAX's fused_lamb.init gives m and v one zeros buffer
        jstep = jax_make_train_step(jtask.loss_fn, jtx, donate=False)
        jstate = jax_create_train_state(params, jtx, jax.random.key(1))
        batch = jax.tree_util.tree_map(jnp.asarray, _batch(2))
        want = []
        for _ in range(steps):
            jstate, m = jstep(jstate, batch)
            want.append(float(m["loss"]))
    want_params = bert_pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params))

    model = _port_model(jax_params)
    tparams = dict(model.named_parameters())
    tx = tf.fused_lamb(lr, weight_decay=0.01,
                       mask={n: p.ndim > 1 for n, p in tparams.items()},
                       order=bert_pretrain_jax_order(SMALL["num_layers"]))
    task = BertPretrainTask(BertConfig(**SMALL), torch.float32, max_predictions=P)
    state = create_train_state(model, tx, 1, params=tparams)
    step = make_train_step(task.loss_fn, tx)
    tbatch = _torch_batch(_batch(2))
    got = []
    for _ in range(steps):
        state, m = step(state, tbatch)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   atol=2e-4, rtol=2e-3, err_msg=name)
