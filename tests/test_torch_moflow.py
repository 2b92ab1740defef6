"""Port parity: MoFlow (the bond Glow, the graph-conditional atom flow,
their inverse, the NLL in bits) and the ``moflow`` command, in torch against
the JAX package.

The model runs at small widths: 6 atoms of 4 types, 4 bond types, 2 bond
flows squeezed 3-fold with a hidden conv of 8, 3 atom flows with a
GraphConv of 8 and Linears of 8 and 6, B=4, on one-hot atoms and symmetric
one-hot bonds. The JAX side is fp32 at "highest" precision, jitted once;
the port is fp32 on one thread. JAX's parameters and BN statistics are
drawn in numpy for its own shapes and carried into the port by the bridge,
which also carries JAX's gradients across. The dequantisation noise cannot
match ``jax.random``: the tests make JAX's from its key and hand it to the
port's ``draws``; the port's own draws are held to their distribution.

Tolerances, relative to the largest entry of the JAX tensor: latents and
log-determinants 1e-5, the BN running statistics 1e-5; losses 1e-5
relative; every gradient within 1e-3 of its own largest entry and 1e-5 of
the largest entry of all (a bond convolution's bias, which the BN after it
removes, only to the largest of all: its gradient is rounding); the inverse
1e-5; the round trip through ``convert_moflow`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.models import moflow as jax_mf
from deeplearningexamples_tpu.utils.torch_import import convert_moflow
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.models import moflow
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    moflow_state_dict_from_jax,
)
from torch_parity import (assert_round_trip, draw, grads, jit, load,
                          raport_losses, rel, sd_numpy, tb, worst)
from torch_threads import torch_one_thread  # noqa: F401

FTOL = 1e-5
LTOL = 1e-5
GTOL = (1e-3, 1e-5)
KW = dict(n_node=6, n_atom_types=4, n_bond_types=4, bond_n_flow=2,
          bond_squeeze=3, bond_hidden=(8,), atom_n_flow=3,
          atom_hidden_gnn=(8,), atom_hidden_lin=(8, 6))
B = 4


@pytest.fixture(autouse=True)
def _exact_fp32():
    with jax.default_matmul_precision("highest"):
        yield


def _jax_task():
    return jax_mf.MoFlowTask(jax_mf.MoFlowConfig(**KW))


@functools.lru_cache(maxsize=None)
def _vars():
    params, stats = jax.eval_shape(lambda: _jax_task().init(jax.random.key(0)))
    return draw(params, 1), draw(stats, 2)


@functools.lru_cache(maxsize=None)
def _batch() -> dict:
    rng = np.random.default_rng(3)
    atoms = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, 6))]
    bonds = np.triu(rng.integers(0, 4, (B, 6, 6)), 1)
    bonds = bonds + bonds.transpose(0, 2, 1)
    adj = np.eye(4, dtype=np.float32)[bonds].transpose(0, 3, 1, 2)
    return {"atoms": atoms, "adj": np.ascontiguousarray(adj)}


def _port() -> moflow.MoFlow:
    return load(moflow.MoFlow(moflow.MoFlowConfig(**KW)),
                moflow_state_dict_from_jax(*_vars()))


def _noise() -> dict:
    """JAX's dequantisation draws for ``jax.random.key(5)``: the loss
    function's ``ra, rx = split(rng)``."""
    ra, rx = jax.random.split(jax.random.key(5))
    b = _batch()
    return {"atoms": np.asarray(jax.random.uniform(rx, b["atoms"].shape)),
            "adj": np.asarray(jax.random.uniform(ra, b["adj"].shape))}


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX's training forward (latents, log-determinants, new statistics),
    loss with its parts and gradients, and the inverse of its eval-mode
    latents."""
    task, b = _jax_task(), _batch()

    def run(params, stats):
        mp = {k: v for k, v in params.items() if k != "ln_var"}
        v = {"params": mp, "batch_stats": stats}
        (zx, ldx, zadj, ldadj), mut = task.model.apply(
            v, b["adj"], b["atoms"], train=True, mutable=["batch_stats"],
            method=lambda m, a, x, train: (
                *m.atom_flow(a, x, train=train),
                *m.bond_glow(a.transpose(0, 2, 3, 1), train=train)))
        (loss, (new_stats, parts)), g = jax.value_and_grad(
            lambda p: task.loss_fn(p, stats, b, jax.random.key(5)),
            has_aux=True)(params)
        ex, _, ea, _ = task.model.apply(
            v, b["adj"], b["atoms"], train=False,
            method=lambda m, a, x, train: (
                *m.atom_flow(a, x, train=train),
                *m.bond_glow(a.transpose(0, 2, 3, 1), train=train)))
        z = jnp.concatenate([ex.reshape(B, -1), ea.reshape(B, -1)], 1)
        back = task.model.apply(v, z, method=jax_mf.MoFlow.reverse)
        return ((zx, ldx, zadj, ldadj), mut["batch_stats"], loss, parts,
                new_stats, g, z, back)

    return jax.tree_util.tree_map(np.asarray, jit(run)(*_vars()))


def _nhwc(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), 1, -1)


def test_forward_and_bn_statistics_match_jax():
    (zx, ldx, zadj, ldadj), new_stats, *_ = _jax()
    model = _port()
    b = tb(_batch())
    with torch.no_grad():
        gx, gadj, gldx, gldadj = model(b["adj"], b["atoms"])
    assert rel(gx.numpy(), zx) < FTOL and rel(gldx.numpy(), ldx) < FTOL
    assert gadj.shape == (B, 4, 6, 6)
    assert rel(_nhwc(gadj), zadj) < FTOL and rel(gldadj.numpy(), ldadj) < FTOL
    want = moflow_state_dict_from_jax(_vars()[0], new_stats)
    got = sd_numpy(model)
    stats = [k for k in want if ".running_" in k]
    assert len(stats) == 2 * (2 + 3 * 3)
    for k in stats:
        assert rel(got[k], want[k]) < FTOL, k


def test_loss_and_gradients_match_jax(monkeypatch):
    """JAX's noise handed to the port: the NLL of the atoms (on the clean
    adjacency) and of the noised bonds, in bits, and every gradient (the
    learned ``ln_var`` too)."""
    _, _, loss, parts, _, g, _, _ = _jax()
    model = _port()
    task = moflow.MoFlowTask(moflow.MoFlowConfig(**KW))
    noise = tb(_noise())
    monkeypatch.setattr(task, "draws", lambda gen, batch: noise)
    got, (_, metrics) = task.loss_fn(model, task.model_state(model),
                                     tb(_batch()), torch.Generator())
    got.backward()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    for k in ("nll_x", "nll_adj"):
        assert abs(float(metrics[k]) - float(parts[k])) < LTOL * abs(
            float(parts[k])), k
    # a bond coupling's hidden convolution feeds a per-channel BN, which
    # removes its bias: that gradient is 0 but for rounding
    noise = {f"bond_model.blocks.0.flows.{i}.coupling.layers.{3 * j}.bias"
             for i in range(KW["bond_n_flow"])
             for j in range(len(KW["bond_hidden"]))}
    own, top = worst(grads(model), moflow_state_dict_from_jax(g), noise)
    assert "ln_var" in grads(model)
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top


def test_reverse_inverts_the_forward_and_matches_jax():
    """In eval mode (BN on its running statistics) the inverse of the
    latents gives back the one-hot bonds exactly and the atoms to 1e-5,
    as JAX's ``reverse`` does."""
    *_, z, (want_adj, want_x) = _jax()
    model = _port().eval()
    b = tb(_batch())
    with torch.no_grad():
        zx, zadj, _, _ = model(b["adj"], b["atoms"])
    latent = torch.cat([zx.reshape(B, -1),
                        zadj.permute(0, 2, 3, 1).reshape(B, -1)], 1)
    assert rel(latent.numpy(), z) < FTOL
    adj, x = model.reverse(torch.from_numpy(z))
    np.testing.assert_array_equal(adj.numpy(), want_adj)
    np.testing.assert_array_equal(adj.numpy(), _batch()["adj"])
    assert rel(x.numpy(), want_x) < FTOL
    assert rel(x.numpy(), _batch()["atoms"]) < FTOL


def test_draws_and_generate_keep_their_distributions():
    """The port's own draws: the noise is U(0, 1) of the batch's shapes,
    another per step of the generator; ``generate`` decodes one-hot,
    symmetric bonds."""
    task = moflow.MoFlowTask(moflow.MoFlowConfig(**KW))
    gen = torch.Generator().manual_seed(0)
    batch = {"atoms": torch.zeros(512, 6, 4), "adj": torch.zeros(512, 4, 6, 6)}
    a, b = task.draws(gen, batch), task.draws(gen, batch)
    for k in batch:
        assert a[k].shape == batch[k].shape
        u = a[k].flatten()
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.01
        assert abs(float(u.var()) - 1 / 12) < 0.005
        assert not torch.equal(a[k], b[k])
    model = _port().eval()
    adj, x = task.generate(model, task.model_state(model), gen, 8)
    assert adj.shape == (8, 4, 6, 6) and x.shape == (8, 6, 4)
    torch.testing.assert_close(adj.sum(1), torch.ones(8, 6, 6))
    torch.testing.assert_close(adj, adj.transpose(2, 3))


def test_round_trips_through_convert_moflow():
    params, stats = _vars()
    back_p, back_s = convert_moflow(
        sd_numpy(_port()), KW["bond_n_flow"], KW["bond_hidden"],
        KW["atom_n_flow"], KW["atom_hidden_gnn"], KW["atom_hidden_lin"])
    assert_round_trip(back_s, stats)
    ln_var = sd_numpy(_port())["ln_var"]
    assert_round_trip({**back_p, "ln_var": ln_var}, params)


# -- the command -------------------------------------------------------------------


@pytest.fixture
def small_moflow(monkeypatch):
    """The command's MoFlow at the small widths."""
    cfg_cls = moflow.MoFlowConfig
    monkeypatch.setattr(moflow, "MoFlowConfig", lambda: cfg_cls(**KW))


def test_cli_trains_moflow_on_the_cpu(tmp_path, small_moflow):
    """fp32 under ``--amp``, 8 steps over 4 batches cycled at ``--lr
    1e-2``: finite and falling; the BN statistics in the state."""
    state, _ = cli(["moflow", "--batch-size", "8", "--steps-per-epoch", "4",
                    "--epochs", "2", "--lr", "1e-2", "--device", "cpu",
                    "--workspace", str(tmp_path)])
    assert state.step == 8 and state.model.dtype == torch.float32
    assert any(".running_var" in k for k in state.model_state)
    losses = raport_losses(tmp_path / "moflow_raport.json")
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert np.isfinite(raport_losses(tmp_path / "moflow_raport.json",
                                     "train.nll_adj")).all()


def test_cli_moflow_batches_and_rate_are_jaxs(tmp_path, small_moflow,
                                              monkeypatch):
    """The synthetic molecules of JAX's ``_breadth_spec`` (the same numpy
    draws) and ``cfg.lr or 1e-3``: without ``--lr`` CommonConfig's 0.1."""
    jax_cfg = jax_mf.MoFlowConfig
    monkeypatch.setattr(jax_mf, "MoFlowConfig", lambda: jax_cfg(**KW))
    _, _, jax_batch, _ = jax_cli._breadth_spec(
        "moflow", jax_cli.CommonConfig(batch_size=3))
    _, _, port_batch, _ = cli_main._breadth_spec(
        "moflow", cli_main.CommonConfig(batch_size=3, device="cpu"))
    for _ in range(2):
        want, got = jax_batch(), port_batch()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rates = []
    orig = opt.adam
    monkeypatch.setattr(opt, "adam", lambda lr, *a, **k: rates.append(lr)
                        or orig(lr, *a, **k))
    cli(["moflow", "--batch-size", "4", "--steps-per-epoch", "1", "--device",
         "cpu", "--workspace", str(tmp_path)])
    assert rates == [0.1]
