"""The port's ``MoEFeedForward`` against the JAX package's on the CPU, and its
expert-sharded layer at ``model=2`` against the replicated one.

Weights (JAX's tree: ``router/kernel``, ``wi``, ``wo``) and inputs come from
numpy seeds, carried into the port by ``moe_state_dict_from_jax``. fp32 on both sides (JAX's einsums at "highest"): the
output within 1e-5 of JAX's and of both packages' ``moe_reference``, the aux
loss within 1e-6 relative, the gradients of ``mean(y^2) + 0.01 aux`` within
1e-5 of each tensor's largest entry (``tests/test_moe.py``'s limits). The
routing tensors equal JAX's ``_route_topk``'s. One spawn of four ranks
(``tests/torch_mesh_worker.py``) runs the layer on a (data 2, model 2) mesh,
4 of the 8 experts a rank, while this process runs JAX's side: equal to the
replicated layer within 1e-6, forward and gradients (the experts' gathered
whole).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.ops.moe import MoEConfig as JaxMoEConfig
from deeplearningexamples_tpu.ops.moe import MoEFeedForward as JaxMoE
from deeplearningexamples_tpu.ops.moe import _route_topk as jax_route_topk
from deeplearningexamples_tpu.ops.moe import moe_reference as jax_moe_reference
from deeplearningexamples_tpu_torch.ops.moe import (
    MoEConfig,
    MoEFeedForward,
    _route_top1,
    _route_topk,
    capacity,
    moe_reference,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import moe_state_dict_from_jax
from torch_mesh_worker import collect, spawn
from torch_threads import torch_one_thread  # noqa: F401

CFGS = {
    "top1": dict(d_model=16, d_ff=32, num_experts=8, capacity_factor=2.0),
    "top2": dict(d_model=16, d_ff=32, num_experts=8, capacity_factor=2.0,
                 router_top_k=2),
    # capacity ceil(24/8) * 0.5 * 2 = 3 slots: most assignments dropped
    "drop": dict(d_model=16, d_ff=32, num_experts=8, capacity_factor=0.5,
                 router_top_k=2),
}


def _x(seed: int, shape=(2, 24, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_params(cfg: dict, seed: int) -> dict:
    """JAX's param tree, drawn at lecun_normal's scale."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg["d_model"], cfg["d_ff"], cfg["num_experts"]

    def draw(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return {"router": {"kernel": draw((d, e), d)},
            "wi": draw((e, d, f), d), "wo": draw((e, f, d), f)}


def _port(cfg: dict, params) -> MoEFeedForward:
    layer = MoEFeedForward(MoEConfig(**cfg))
    layer.load_state_dict({k: torch.tensor(v) for k, v in
                           moe_state_dict_from_jax(params).items()})
    return layer


def _jax_side(cfg: dict, params, x):
    layer = JaxMoE(JaxMoEConfig(**cfg))

    def loss(p, x):
        y, aux = layer.apply({"params": p}, x)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    with jax.default_matmul_precision("highest"):
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (np.asarray(y), float(aux),
            moe_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           grads[0])),
            np.asarray(grads[1]))


def _port_side(layer: MoEFeedForward, x):
    xt = torch.tensor(x, requires_grad=True)
    y, aux = layer(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            {n: p.grad.numpy() for n, p in layer.named_parameters()},
            xt.grad.numpy())


def _scaled(got, want, tol: float, name: str = "") -> None:
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Each config's params and input; the four ranks started, JAX's layer
    and reference and the port's replicated layer computed while they run;
    then each rank's results."""
    cases = {name: (cfg, _jax_params(cfg, 20 + i), _x(10 + i))
             for i, (name, cfg) in enumerate(CFGS.items())}
    out = tmp_path_factory.mktemp("moe")
    procs = spawn("moe", {"cases": {
        name: {"cfg": cfg, "x": torch.tensor(x), "sd": {
            k: torch.tensor(v) for k, v in moe_state_dict_from_jax(p).items()}}
        for name, (cfg, p, x) in cases.items()}}, out)
    try:
        jax_side = {name: _jax_side(cfg, p, x)
                    for name, (cfg, p, x) in cases.items()}
        # JAX's reference works token by token, eagerly: one row
        refs = {name: np.asarray(jax_moe_reference(
                    jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x[:1]),
                    JaxMoEConfig(**cfg)))
                for name, (cfg, p, x) in cases.items()}
        replicated = {name: _port_side(_port(cfg, p), x)
                      for name, (cfg, p, x) in cases.items()}
    finally:
        ranks = collect(procs, out)
    return {"cases": cases, "jax": jax_side, "refs": refs, "ranks": ranks,
            "replicated": replicated}


@pytest.mark.parametrize("name", list(CFGS))
def test_layer_matches_jax_forward_aux_and_gradients(run, name):
    want_y, want_aux, want_g, want_dx = run["jax"][name]
    y, aux, g, dx = run["replicated"][name]
    np.testing.assert_allclose(y, want_y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    assert np.isfinite(aux) and aux > 0
    for n in want_g:
        _scaled(g[n], want_g[n], 1e-5, n)
    _scaled(dx, want_dx, 1e-5, "x")
    # the router takes gradient through the gates and the aux loss
    assert np.abs(g["router.weight"]).sum() > 0


@pytest.mark.parametrize("name", list(CFGS))
def test_layer_matches_both_references(run, name):
    cfg, params, x = run["cases"][name]
    layer = _port(cfg, params)
    y = run["replicated"][name][0]
    got = moe_reference(dict(layer.named_parameters()), torch.tensor(x),
                        MoEConfig(**cfg)).detach().numpy()
    np.testing.assert_allclose(y, got, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:1], run["refs"][name], rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,cap", [(1, 3), (2, 3), (2, 7), (3, 2)])
def test_routing_tensors_equal_jax(k, cap):
    """dispatch, combine and aux of one row's logits, with ties: the first
    maximum wins, as ``jnp.argmax``'s."""
    logits = np.random.default_rng(k * 10 + cap).standard_normal(
        (12, 4)).astype(np.float32)
    logits[3] = logits[5] = [0.5, 0.5, -1.0, 0.5]
    want = jax.jit(jax_route_topk, static_argnums=(1, 2))(
        jnp.asarray(logits), cap, k)
    got = _route_topk(torch.tensor(logits), cap, k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    if k == 1:
        for g, w in zip(_route_top1(torch.tensor(logits), cap), got):
            assert torch.equal(g, w)


def test_capacity_drops_overflow():
    """Identical tokens all choose one expert: capacity ceil(16/4) * 0.5 =
    2 keeps two rows, the rest are zero, as JAX's test holds."""
    cfg = dict(d_model=8, d_ff=16, num_experts=4, capacity_factor=0.5)
    x = np.tile(_x(2, (1, 1, 8)), (1, 16, 1))
    params = _jax_params(cfg, 3)
    assert capacity(MoEConfig(**cfg), 16) == 2
    with torch.no_grad():
        y = _port(cfg, params)(torch.tensor(x))[0].numpy()
    want = np.asarray(jax_moe_reference(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        JaxMoEConfig(**cfg)))
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)
    assert np.count_nonzero(np.abs(y[0]).sum(-1) > 1e-6) == 2


@pytest.mark.parametrize("name", list(CFGS))
def test_expert_sharded_layer_equals_replicated(run, name):
    y, aux, g, dx = run["replicated"][name]
    for res in run["ranks"]:
        got = res[name]
        assert got["experts"] == 4
        np.testing.assert_allclose(got["y"].numpy(), y, rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(got["aux"]), aux, rtol=1e-6)
        _scaled(got["dx"].numpy(), dx, 1e-6, "x")
        for n, t in got["grads"].items():
            _scaled(t.numpy(), g[n], 1e-6, n)


def test_state_dict_from_jax_round_trips_the_param_tree(run):
    """The bridge's names and layouts: back through the transposes it is
    JAX's tree (JAX's layer takes it: its init gives that structure), and
    the layer holds exactly those tensors."""
    cfg, params, x = run["cases"]["top2"]
    init = jax.eval_shape(JaxMoE(JaxMoEConfig(**cfg)).init, jax.random.key(0),
                          jnp.asarray(x))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, init) == \
        jax.tree_util.tree_map(np.shape, params)
    sd = moe_state_dict_from_jax(params)
    assert set(sd) == set(dict(MoEFeedForward(MoEConfig(**cfg)).named_parameters()))
    back = {"router": {"kernel": sd["router.weight"].T}, "wi": sd["wi"],
            "wo": sd["wo"]}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    layer = _port(cfg, params)
    assert layer.wi.shape == (8, 16, 32) and layer.wo.shape == (8, 32, 16)
    np.testing.assert_array_equal(layer.router.weight.detach().numpy(),
                                  params["router"]["kernel"].T)
