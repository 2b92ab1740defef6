"""Port parity: the SE(3)-Transformer and its equivariant basis, against
the JAX package, and the port's own equivariance checks.

- Clebsch-Gordan coefficients (every coupling of degrees 0-3) equal to
  JAX's, bit for bit (the port's numpy copy of its exact-factorial code).
- Real spherical harmonics up to degree 6 (vectors on both poles, the zero
  vector and the x axis among random ones) and ``se3_basis`` within 5e-6
  of JAX's largest entry (jitted: XLA fuses multiplies and adds; reading
  1.4e-6); the zero vector's values finite.
- Every layer (``RadialProfile``, ``LinearSE3``, ``NormSE3``, ``ConvSE3``
  pooled, unpooled and self-interacting, ``AttentionBlockSE3``) on padded
  molecules (the last atoms masked), JAX's parameters drawn in numpy and
  carried over with ``se3_state_dict_from_jax``: outputs within 1e-5 of
  JAX's largest entry.
- The whole model (one attention layer) with max and average pooling on
  padded molecules, fp32 on both sides (JAX at "highest", jitted once):
  the loss within 1e-5, and with max pooling (the configuration's) every
  gradient within 1e-3 of its own tensor's largest entry and 1e-5 of the
  largest entry of all; the trunk with type-0 and type-1 inputs and
  outputs within 1e-5.
- The port alone, as ``tests/test_se3.py`` holds JAX's: harmonics rotate by
  an orthogonal Wigner-D, the basis and the trunk are equivariant, pooled
  type-1 outputs co-rotate, type-0 outputs and the model's are invariant.
- ``se3-transformer`` through the CLI on the CPU: JAX's synthetic batches,
  and without ``--lr`` Adam at ``CommonConfig.lr`` (``cfg.lr or 3e-3``
  never falls back).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.models import se3_transformer as js
from deeplearningexamples_tpu.ops import se3 as jax_se3
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.models import se3_transformer as ts
from deeplearningexamples_tpu_torch.ops import se3
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    se3_state_dict_from_jax,
)
from torch_parity import draw, jit, load, raport_losses, rel, worst
from torch_threads import torch_one_thread  # noqa: F401

B, N = 2, 6
CFG = dict(num_layers=2, num_degrees=3, num_channels=8, num_heads=2,
           node_feature_dim=4)
PARITY = dict(CFG, num_layers=1)  # the model held against JAX
TOL_SH = 5e-6  # harmonics and basis, of JAX's largest entry (1.4e-6)
TOL_LAYER = 1e-5  # a layer's, the trunk's and the model's outputs and loss
TOL_GRAD = (1e-3, 1e-5)  # of a tensor's own largest entry, of all
TOL_EQUI = 2e-3  # equivariance, as tests/test_se3.py


@pytest.fixture(autouse=True)
def _exact_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _mol(seed: int, n: int = N, padded: int = 2) -> dict:
    """Molecules of ``n`` atoms at 2 N(0, 1), one-hot species, the last
    ``padded`` atoms of the second molecule masked, a scalar target."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, n, 3)).astype(np.float32) * 2
    species = np.eye(CFG["node_feature_dim"], dtype=np.float32)[
        rng.integers(0, CFG["node_feature_dim"], (B, n))]
    mask = np.ones((B, n), np.float32)
    mask[1, n - padded:] = 0.0
    return {"positions": pos, "species": species, "mask": mask,
            "target": rng.normal(size=B).astype(np.float32)}


# -- the basis ----------------------------------------------------------------


def test_clebsch_gordan_equals_jax_bitwise():
    n = 0
    for d_in in range(4):
        for d_out in range(4):
            for j in range(abs(d_in - d_out), d_in + d_out + 1):
                got = se3.clebsch_gordan_real(j, d_in, d_out)
                want = jax_se3.clebsch_gordan_real(j, d_in, d_out)
                assert got.dtype == want.dtype == np.float64
                np.testing.assert_array_equal(got, want)
                n += 1
    assert n == 44


def test_spherical_harmonics_and_basis_match_jax():
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(40, 3)).astype(np.float32)
    vec[:4] = [[0, 0, 2], [0, 0, -0.5], [0, 0, 0], [3, 0, 0]]
    got = se3.real_spherical_harmonics(_t(vec), 6)
    want = jit(lambda v: jax_se3.real_spherical_harmonics(v, 6))(vec)
    for l, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.shape == (40, 2 * l + 1)
        assert rel(g, w) <= TOL_SH, l
        assert torch.isfinite(g).all()
    rel_pos = vec[:, None] - vec[None, :12]  # zero on the diagonal
    got = se3.se3_basis(_t(rel_pos), 3)
    want = jit(lambda r: jax_se3.se3_basis(r, 3))(rel_pos)
    assert got.keys() == want.keys() and len(got) == 16
    for k in want:
        assert got[k].shape == want[k].shape
        assert rel(got[k], want[k]) <= TOL_SH, k


# -- the layers -----------------------------------------------------------------


def _feats(rng, fiber, lead):
    return {str(d): rng.normal(size=(*lead, c, 2 * d + 1)).astype(np.float32)
            for d, c in fiber.items()}


@functools.lru_cache(maxsize=None)
def _graph():
    """(edge features, basis, mask) of ``_mol(2)``, from JAX."""
    batch = _mol(2)
    rel_pos = batch["positions"][:, :, None] - batch["positions"][:, None]
    dist = np.linalg.norm(rel_pos + 1e-12, axis=-1, keepdims=True)
    basis = jit(lambda r: jax_se3.se3_basis(r, 2))(rel_pos)
    return dist, {k: np.asarray(v) for k, v in basis.items()}, batch["mask"]


def _layer_case(name: str):
    """(JAX module, port module, JAX inputs)."""
    rng = np.random.default_rng(1)
    fin, fout = {0: 4, 1: 4}, {0: 4, 1: 4, 2: 4}
    dist, basis, mask = _graph()
    graph = (_feats(rng, fin, (B, N)), dist, basis, mask)
    if name == "radial":
        return (js.RadialProfile(3, 4, 5), ts.RadialProfile(3, 4, 5),
                (dist,))
    if name == "linear":
        return (js.LinearSE3(fout), ts.LinearSE3(fout, fout),
                (_feats(rng, fout, (B, N)),))
    if name == "norm":
        feats = _feats(rng, fout, (B, N))
        feats["1"][1, -1] = 0.0  # a padded atom's zero feature
        return js.NormSE3(fout), ts.NormSE3(fout), (feats,)
    if name.startswith("conv"):
        pool, si = name != "conv_edges", name == "conv_self"
        return (js.ConvSE3(fin, fout, pool=pool, self_interaction=si),
                ts.ConvSE3(fin, fout, pool=pool, self_interaction=si), graph)
    return (js.AttentionBlockSE3(fin, fout, 2, 2),
            ts.AttentionBlockSE3(fin, fout, 2, 2), graph)


LAYERS = ("radial", "linear", "norm", "conv_pooled", "conv_edges",
          "conv_self", "attention")


@functools.lru_cache(maxsize=None)
def _layer_refs() -> dict:
    """Every layer case's JAX parameters, inputs and outputs, from one
    jitted call."""
    cases = {name: _layer_case(name) for name in LAYERS}
    params = {name: draw(jax.eval_shape(lambda m=m, a=a: m.init(
        jax.random.key(0), *a)), 3)["params"]
        for name, (m, _, a) in cases.items()}

    def f(params, args):
        return {name: cases[name][0].apply({"params": params[name]},
                                           *args[name]) for name in cases}

    with jax.default_matmul_precision("highest"):
        out = jit(f)(params, {name: c[2] for name, c in cases.items()})
    return {name: (cases[name][1], cases[name][2], params[name],
                   jax.tree_util.tree_map(np.asarray, out[name]))
            for name in cases}


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name):
    tmod, args, params, want = _layer_refs()[name]
    load(tmod, se3_state_dict_from_jax(params))
    targs = [{k: _t(v) for k, v in a.items()} if isinstance(a, dict)
             else _t(a) for a in args]
    with torch.no_grad():
        got = tmod(*targs)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and rel(got[k], want[k]) \
                <= TOL_LAYER, k
    else:
        assert got.shape == want.shape and rel(got, want) <= TOL_LAYER


# -- the model ------------------------------------------------------------------


def _trunk_modules(num_layers: int = 2):
    kw = dict(fiber_in={0: 8, 1: 8}, fiber_hidden={0: 8, 1: 8, 2: 8},
              fiber_out={0: 8, 1: 8}, num_layers=num_layers, num_heads=2)
    return js.SE3Trunk(**kw), ts.SE3Trunk(**kw)


@functools.lru_cache(maxsize=None)
def _jax32() -> dict:
    """JAX in fp32, one jitted call: per pooling the parameters and the
    loss (max pooling's with its gradients); the trunk's parameters, inputs
    and outputs."""
    batch = _mol(4)
    out, fns = {}, {}
    for pooling in ("max", "avg"):
        task = js.SE3RegressionTask(js.SE3Config(**PARITY, pooling=pooling))
        shapes = jax.eval_shape(lambda t=task: t.model.init(
            jax.random.key(0), batch["positions"], batch["species"],
            batch["mask"]))
        out[pooling] = {"params": draw(shapes, 5)["params"]}
        fns[pooling] = task.loss_fn
    trunk, _ = _trunk_modules(1)
    rng = np.random.default_rng(6)
    feats = _feats(rng, {0: 8, 1: 8}, (B, N))
    shapes = jax.eval_shape(lambda: trunk.init(
        jax.random.key(0), batch["positions"], feats, batch["mask"]))
    out["trunk"] = {"params": draw(shapes, 7)["params"], "feats": feats}

    def f(params, trunk_params):
        (loss, _), g = jax.value_and_grad(fns["max"], has_aux=True)(
            params["max"], {}, batch, None)
        return {"max": (loss, g),
                "avg": (fns["avg"](params["avg"], {}, batch, None)[0], None),
                "trunk": trunk.apply({"params": trunk_params},
                                     batch["positions"], feats,
                                     batch["mask"])}

    with jax.default_matmul_precision("highest"):
        res = jit(f)({p: out[p]["params"] for p in ("max", "avg")},
                     out["trunk"]["params"])
    for k, v in jax.tree_util.tree_map(np.asarray, res).items():
        out[k]["result"] = v
    return out


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_model_loss_and_gradients_match_jax(pooling):
    """The loss of each pooling; the gradients of max pooling's (the
    configuration's)."""
    ref = _jax32()[pooling]
    want_loss, grads = ref["result"]
    task = ts.SE3RegressionTask(ts.SE3Config(**PARITY, pooling=pooling))
    model = load(ts.SE3Transformer(task.cfg), se3_state_dict_from_jax(
        ref["params"]))
    loss, (_, metrics) = task.loss_fn(model, {}, {k: _t(v) for k, v in
                                                  _mol(4).items()}, None)
    assert rel(loss.detach(), want_loss) <= TOL_LAYER
    assert float(metrics["mae"]) > 0
    if grads is None:
        return
    loss.backward()
    own, of_all = worst({n: p.grad.numpy() for n, p in
                         model.named_parameters()},
                        se3_state_dict_from_jax(grads))
    assert own[0] <= TOL_GRAD[0], own
    assert of_all[0] <= TOL_GRAD[1], of_all


def test_trunk_matches_jax():
    ref = _jax32()["trunk"]
    _, trunk = _trunk_modules(1)
    load(trunk, se3_state_dict_from_jax(ref["params"]))
    batch = _mol(4)
    with torch.no_grad():
        got = trunk(_t(batch["positions"]),
                    {k: _t(v) for k, v in ref["feats"].items()},
                    _t(batch["mask"]))
    assert got.keys() == ref["result"].keys() == {"0", "1"}
    for k, w in ref["result"].items():
        assert got[k].shape == w.shape and rel(got[k], w) <= TOL_LAYER, k


# -- equivariance of the port ---------------------------------------------------


def _rotation(rng) -> torch.Tensor:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.tensor(q, dtype=torch.float32)


def _wigner_d(rot, l_max, rng) -> list[torch.Tensor]:
    """The real Wigner-D of each degree, fitted from the harmonics."""
    xs = torch.tensor(rng.normal(size=(max(60, 4 * (l_max + 1) ** 2), 3)),
                      dtype=torch.float32)
    sh = se3.real_spherical_harmonics(xs, l_max)
    sh_r = se3.real_spherical_harmonics(xs @ rot.T, l_max)
    return [torch.linalg.lstsq(sh[l], sh_r[l]).solution.T
            for l in range(l_max + 1)]


def test_harmonics_rotate_orthogonally_and_basis_is_equivariant():
    rng = np.random.default_rng(0)
    rot = _rotation(rng)
    for l, d in enumerate(_wigner_d(rot, 4, rng)):
        assert (d @ d.T - torch.eye(2 * l + 1)).abs().max() < 1e-3, l
    ds = _wigner_d(rot, 2, rng)
    x = torch.tensor(rng.normal(size=(6, 3)), dtype=torch.float32)
    b, b_r = se3.se3_basis(x, 2), se3.se3_basis(x @ rot.T, 2)
    for d_in in range(3):
        for d_out in range(3):
            key = f"{d_in},{d_out}"
            pred = torch.einsum("iI,nIJK,kK->niJk", ds[d_in], b[key],
                                ds[d_out])
            assert (pred - b_r[key]).abs().max() < TOL_EQUI, key


def _port_trunk_outputs(seed: int, pooled: bool = False):
    """The reference's ``test_equivariance.py`` harness on the port's trunk:
    (outputs, outputs of the rotated inputs, the degree-1 Wigner-D)."""
    rng = np.random.default_rng(seed)
    rot = _rotation(rng)
    d1 = _wigner_d(rot, 1, rng)[1]
    _, trunk = _trunk_modules()
    trunk.init_weights_(torch.Generator().manual_seed(seed))
    n = 10
    pos = torch.tensor(rng.normal(size=(2, n, 3)), dtype=torch.float32)
    feats = {"0": torch.tensor(rng.normal(size=(2, n, 8, 1)),
                               dtype=torch.float32),
             "1": torch.tensor(rng.normal(size=(2, n, 8, 3)),
                               dtype=torch.float32)}
    mask = torch.ones(2, n)
    with torch.no_grad():
        out1 = trunk(pos, feats, mask)
        out2 = trunk(pos @ rot.T, {"0": feats["0"], "1": feats["1"] @ d1.T},
                     mask)
    if pooled:
        out1 = {k: v.mean(1) for k, v in out1.items()}
        out2 = {k: v.mean(1) for k, v in out2.items()}
    return out1, out2, d1


@pytest.mark.parametrize("pooled", [False, True], ids=["nodes", "pooled"])
def test_trunk_equivariance(pooled):
    """Type-0 outputs invariant and type-1 outputs co-rotating, per node
    and average-pooled (reference ``test_equivariance``,
    ``test_equivariance_pooled``, ``test_invariance_pooled``)."""
    out1, out2, d1 = _port_trunk_outputs(11 + pooled, pooled)
    assert (out2["0"] - out1["0"]).abs().max() < TOL_EQUI
    assert (out2["1"] - out1["1"] @ d1.T).abs().max() < TOL_EQUI
    assert out1["1"].abs().max() > 0.1


def test_model_rotation_invariance():
    task = ts.SE3RegressionTask(ts.SE3Config(**CFG))
    model = task.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    batch = {k: _t(v) for k, v in _mol(3).items()}
    rot = _rotation(rng)
    with torch.no_grad():
        out = model(batch["positions"], batch["species"], batch["mask"])
        out_r = model(batch["positions"] @ rot.T, batch["species"],
                      batch["mask"])
    np.testing.assert_allclose(out.numpy(), out_r.numpy(), rtol=2e-3,
                               atol=2e-4)


# -- the CLI ------------------------------------------------------------------


def test_cli_se3_transformer_batches_and_rate(tmp_path, monkeypatch):
    jcfg = jax_cli.CommonConfig(batch_size=3, seed=4)
    pcfg = cli_main.CommonConfig(batch_size=3, seed=4, device="cpu")
    want = jax_cli._breadth_spec("se3-transformer", jcfg)[2]
    got = cli_main._breadth_spec("se3-transformer", pcfg)[2]
    for _ in range(2):
        w, g = want(), got()
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], k)
    rates = []
    orig = opt.adam
    monkeypatch.setattr(opt, "adam", lambda lr, *a, **k: rates.append(lr)
                        or orig(lr, *a, **k))
    state, _ = cli_main.cli(["se3-transformer", "--batch-size", "2",
                             "--steps-per-epoch", "3", "--device", "cpu",
                             "--workspace", str(tmp_path / "a")])
    assert rates == [0.1] and state.step == 3
    cli_main.cli(["se3-transformer", "--batch-size", "2", "--steps-per-epoch",
                  "3", "--lr", "3e-3", "--device", "cpu", "--workspace",
                  str(tmp_path / "b")])
    assert rates == [0.1, 3e-3]
    losses = raport_losses(tmp_path / "b" / "se3_transformer_raport.json")
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert dataclasses.asdict(state.model.cfg) == dataclasses.asdict(
        ts.SE3Config(num_layers=4, num_degrees=3, num_channels=16))
