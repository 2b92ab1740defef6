"""Port parity: NCF (NeuMF, HR@10/NDCG@10) and TFT with its time-series
reader and forecast metrics, and the ``ncf`` and ``tft`` commands, in torch
against the JAX package.

The models run at small widths: NeuMF over 50 users and 40 items, mf_dim
8, an MLP of 16-16-8-4; TFT at hidden 16, 2 heads, 12 steps of history and
4 of horizon, once with one static variable (whose joint GRN has a scalar
output and no LayerNorm) and once with two. Dropout is 0. The JAX side is
fp32 at "highest" precision, jitted once per function; the port is fp32 on
one thread. JAX's parameters are drawn in numpy for its own shapes and
carried into the port by the bridge, which also carries JAX's gradients
across.

Tolerances, relative to the largest entry of the JAX tensor: forwards
1e-5; losses 1e-5 relative; every gradient within 1e-3 of its own largest
entry and 1e-5 of the largest entry of all; the metrics, the datasets'
windows and the round trips through JAX's converters exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.data import timeseries as jax_ts
from deeplearningexamples_tpu.models import ncf as jax_ncf
from deeplearningexamples_tpu.models import tft as jax_tft
from deeplearningexamples_tpu.utils.torch_import import convert_ncf, convert_tft
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.data import timeseries
from deeplearningexamples_tpu_torch.models import ncf, tft
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    ncf_state_dict_from_jax,
    tft_state_dict_from_jax,
)
from torch_parity import (assert_round_trip, draw, grads, jit, load,
                          raport_losses, rel, sd_numpy, tb, worst)
from torch_threads import torch_one_thread  # noqa: F401

FTOL = 1e-5
LTOL = 1e-5
GTOL = (1e-3, 1e-5)


@pytest.fixture(autouse=True)
def _exact_fp32():
    with jax.default_matmul_precision("highest"):
        yield


# -- NCF ---------------------------------------------------------------------------

NCF_KW = dict(nb_users=50, nb_items=40, mf_dim=8,
              mlp_layer_sizes=(16, 16, 8, 4), dropout=0.0)
NCF_B = 16


@functools.lru_cache(maxsize=None)
def _ncf_vars():
    task = jax_ncf.NcfTask(jax_ncf.NcfConfig(**NCF_KW), jnp.float32)
    return draw(jax.eval_shape(lambda: task.init(jax.random.key(0)))[0], 1)


@functools.lru_cache(maxsize=None)
def _ncf_batch() -> dict:
    rng = np.random.default_rng(2)
    return {"user": rng.integers(0, 50, NCF_B).astype(np.int32),
            "item": rng.integers(0, 40, NCF_B).astype(np.int32),
            "label": rng.integers(0, 2, NCF_B).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _ncf_eval_batch() -> dict:
    rng = np.random.default_rng(3)
    return {"user": rng.integers(0, 50, 6).astype(np.int32),
            "pos_item": rng.integers(0, 40, 6).astype(np.int32),
            "neg_items": rng.integers(0, 40, (6, 20)).astype(np.int32)}


def _ncf_port() -> ncf.NeuMF:
    return load(ncf.NeuMF(ncf.NcfConfig(**NCF_KW), torch.float32),
                ncf_state_dict_from_jax(_ncf_vars()))


@functools.lru_cache(maxsize=None)
def _ncf_jax():
    task = jax_ncf.NcfTask(jax_ncf.NcfConfig(**NCF_KW), jnp.float32)
    b, e = _ncf_batch(), _ncf_eval_batch()

    def run(params):
        logits = task.model.apply({"params": params}, b["user"], b["item"])
        (loss, _), g = jax.value_and_grad(
            lambda p: task.loss_fn(p, {}, b, jax.random.key(0)),
            has_aux=True)(params)
        return logits, loss, g, task.metric_fn(params, {}, e)

    return jax.tree_util.tree_map(np.asarray, jit(run)(_ncf_vars()))


def test_ncf_forward_matches_jax():
    logits, _, _, _ = _ncf_jax()
    b = tb(_ncf_batch())
    with torch.no_grad():
        got = _ncf_port()(b["user"], b["item"]).numpy()
    assert got.shape == (NCF_B,) and got.dtype == np.float32
    assert rel(got, logits) < FTOL


def test_ncf_loss_and_gradients_match_jax():
    _, loss, g, _ = _ncf_jax()
    model = _ncf_port()
    task = ncf.NcfTask(ncf.NcfConfig(**NCF_KW), torch.float32)
    got, _ = task.loss_fn(model, {}, tb(_ncf_batch()), torch.Generator())
    got.backward()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    own, top = worst(grads(model), ncf_state_dict_from_jax(g))
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top


def test_ncf_metrics_match_jax():
    _, _, _, want = _ncf_jax()
    task = ncf.NcfTask(ncf.NcfConfig(**NCF_KW), torch.float32)
    got = task.metric_fn(_ncf_port(), {}, tb(_ncf_eval_batch()))
    for k in ("hr@10", "ndcg@10"):
        assert abs(float(got[k]) - float(want[k])) < 1e-6, k


def test_hit_rate_ndcg_matches_jax_with_ties():
    """Integer scores, so that a negative often ties the positive (a tie
    ranks above it, as in JAX)."""
    scores = np.random.default_rng(4).integers(0, 6, (64, 21)).astype(
        np.float32)
    want = jax_ncf.hit_rate_ndcg(jnp.asarray(scores), k=5)
    got = ncf.hit_rate_ndcg(torch.from_numpy(scores), k=5)
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) < 1e-6


def test_ncf_round_trips_through_convert_ncf():
    back = convert_ncf(sd_numpy(_ncf_port()), len(NCF_KW["mlp_layer_sizes"]) - 1)
    assert_round_trip(back, _ncf_vars())


def test_ncf_dropout_drops_at_its_rate():
    """The port's own draws: at dropout 0.5 about half the units are kept
    (scaled by 2), and a forward is reproducible from its generator."""
    model = ncf.NeuMF(dataclasses.replace(ncf.NcfConfig(**NCF_KW),
                                          dropout=0.5), torch.float32)
    model.init_weights_(torch.Generator().manual_seed(0))
    b = tb(_ncf_batch())
    out = [model(b["user"], b["item"], torch.Generator().manual_seed(5))
           for _ in range(2)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    kept = model.drop(torch.ones(4096, 64), torch.Generator().manual_seed(6))
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.02
    assert float(kept.max()) == 2.0


# -- TFT ---------------------------------------------------------------------------

TFT_KW = {
    "one static": dict(n_observed=2, n_known=2, hidden=16, n_heads=2,
                       encoder_len=12, horizon=4, dropout=0.0),
    "two static": dict(n_observed=3, n_known=2, hidden=16, n_heads=2,
                       encoder_len=12, horizon=4, dropout=0.0, target_pos=1,
                       static_categorical_sizes=(3, 2)),
}
TFT_B = 3


@functools.lru_cache(maxsize=None)
def _tft_vars(name: str):
    task = jax_tft.TFTTask(jax_tft.TFTConfig(**TFT_KW[name]))
    return draw(jax.eval_shape(lambda: task.init(jax.random.key(0)))[0], 5)


@functools.lru_cache(maxsize=None)
def _tft_batch(name: str) -> dict:
    kw, rng = TFT_KW[name], np.random.default_rng(6)
    enc, hor = kw["encoder_len"], kw["horizon"]
    b = {"observed": rng.normal(size=(TFT_B, enc, kw["n_observed"])),
         "known": rng.normal(size=(TFT_B, enc + hor, kw["n_known"])),
         "target": rng.normal(size=(TFT_B, hor))}
    b = {k: v.astype(np.float32) for k, v in b.items()}
    sizes = kw.get("static_categorical_sizes", (1,))
    if len(sizes) > 1:
        b["s_cat"] = np.stack([rng.integers(0, n, TFT_B) for n in sizes],
                              1).astype(np.int32)
    return b


def _tft_port(name: str) -> tft.TFT:
    return load(tft.TFT(tft.TFTConfig(**TFT_KW[name]), torch.float32),
                tft_state_dict_from_jax(_tft_vars(name)))


@functools.lru_cache(maxsize=None)
def _tft_jax(name: str):
    task = jax_tft.TFTTask(jax_tft.TFTConfig(**TFT_KW[name]))
    b = _tft_batch(name)

    def run(params):
        pred = task.predict_fn(params, b["observed"], b["known"], b.get("s_cat"))
        (loss, _), g = jax.value_and_grad(
            lambda p: task.loss_fn(p, {}, b, jax.random.key(0)),
            has_aux=True)(params)
        return pred, loss, g

    return jax.tree_util.tree_map(np.asarray, jit(run)(_tft_vars(name)))


@pytest.mark.parametrize("name", list(TFT_KW))
def test_tft_forward_matches_jax(name):
    pred, _, _ = _tft_jax(name)
    b = tb(_tft_batch(name))
    task = tft.TFTTask(tft.TFTConfig(**TFT_KW[name]))
    got = task.predict_fn(_tft_port(name), b["observed"], b["known"],
                          b["s_cat"].long() if "s_cat" in b else None).numpy()
    assert got.shape == pred.shape == (TFT_B, 4, 3)
    assert rel(got, pred) < FTOL


@pytest.mark.parametrize("name", list(TFT_KW))
def test_tft_loss_and_gradients_match_jax(name):
    _, loss, g = _tft_jax(name)
    model = _tft_port(name)
    task = tft.TFTTask(tft.TFTConfig(**TFT_KW[name]))
    b = tb(_tft_batch(name))
    if "s_cat" in b:
        b["s_cat"] = b["s_cat"].long()
    got, _ = task.loss_fn(model, {}, b, torch.Generator())
    got.backward()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    own, top = worst(grads(model), tft_state_dict_from_jax(g))
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top


@pytest.mark.parametrize("name", list(TFT_KW))
def test_tft_round_trips_through_convert_tft(name):
    cfg = jax_tft.TFTConfig(**TFT_KW[name])
    back = convert_tft(sd_numpy(_tft_port(name)), cfg.num_static_vars,
                       cfg.num_historic_vars, cfg.num_future_vars)
    assert_round_trip(back, _tft_vars(name))


def test_tft_history_lstm_starts_from_the_static_contexts():
    """flax's carry is (c, h): the history LSTM's first step sees h0 = ch
    and c0 = cc. Swapping the two context GRNs moves the forecasts."""
    name = "one static"
    b = tb(_tft_batch(name))
    task = tft.TFTTask(tft.TFTConfig(**TFT_KW[name]))
    model = _tft_port(name)
    want = task.predict_fn(model, b["observed"], b["known"])
    grns = model.static_encoder.context_grns
    grns[2], grns[3] = grns[3], grns[2]
    got = task.predict_fn(model, b["observed"], b["known"])
    assert rel(got.numpy(), want.numpy()) > 1e-3


def test_quantile_loss_matches_jax():
    rng = np.random.default_rng(7)
    pred = rng.normal(size=(5, 6, 3)).astype(np.float32)
    target = rng.normal(size=(5, 6)).astype(np.float32)
    want = jax_tft.quantile_loss(pred, target, (0.1, 0.5, 0.9))
    got = tft.quantile_loss(torch.from_numpy(pred), torch.from_numpy(target),
                            (0.1, 0.5, 0.9))
    assert abs(float(got) - float(want)) < 1e-6 * abs(float(want))


# -- the time-series reader and the forecast metrics -------------------------------


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_windowed_dataset_matches_jaxs(split):
    panel = timeseries.make_synthetic_series(3, 400, seed=1)
    np.testing.assert_array_equal(panel, jax_ts.make_synthetic_series(3, 400, 1))
    spec = timeseries.TimeSeriesSpec((0, 1), (2, 3), 0, 48, 12)
    jspec = jax_ts.TimeSeriesSpec((0, 1), (2, 3), 0, 48, 12)
    got = timeseries.WindowedTimeSeriesDataset(panel, spec, 16, split=split,
                                               seed=3)
    want = jax_ts.WindowedTimeSeriesDataset(panel, jspec, 16, split=split,
                                            seed=3)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(got.unscale_target(np.ones(3)),
                                  want.unscale_target(np.ones(3)))


def test_forecast_metrics_equal_jaxs():
    rng = np.random.default_rng(8)
    pred = rng.normal(size=(40, 6, 3))
    target = rng.normal(size=(40, 6))
    got = timeseries.forecast_metrics(pred, target)
    want = jax_ts.forecast_metrics(pred, target)
    assert got == want and set(got) == {"MAE", "RMSE", "SMAPE", "ND", "P50",
                                        "P90"}


# -- the commands ------------------------------------------------------------------


def test_cli_trains_ncf_on_the_cpu(tmp_path, monkeypatch):
    """bf16 NeuMF at small widths, 4 steps on the one repeated batch at
    ``--lr 1e-2``: finite, falling; a checkpoint."""
    cfg_cls = ncf.NcfConfig
    monkeypatch.setattr(ncf, "NcfConfig",
                        lambda: cfg_cls(**{**NCF_KW, "dropout": 0.5}))
    state, _ = cli(["ncf", "--batch-size", "64", "--steps-per-epoch", "4",
                    "--lr", "1e-2", "--device", "cpu", "--workspace",
                    str(tmp_path)])
    assert state.step == 4 and state.model.dtype == torch.bfloat16
    losses = raport_losses(tmp_path / "ncf_raport.json")
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert (tmp_path / "ncf_ckpt").exists()


def test_cli_ncf_batch_and_quirks_are_jaxs(tmp_path, monkeypatch):
    """JAX's ``run_ncf``: one batch (the same numpy draws) repeated each
    step, ``cfg.lr or 2.5e-3`` (without ``--lr``: CommonConfig's 0.1) and
    no ``--resume``: a second run starts from the seed's weights."""
    cfg_cls = ncf.NcfConfig
    monkeypatch.setattr(ncf, "NcfConfig", lambda: cfg_cls(**NCF_KW))
    run = cli_main.build_ncf(cli_main.CommonConfig(
        batch_size=8, steps_per_epoch=3, device="cpu"))
    assert len(run.loader) == 3 and all(b is run.loader[0] for b in run.loader)
    rng = np.random.default_rng(0)
    want = {"user": rng.integers(0, 50, 8), "item": rng.integers(0, 40, 8),
            "label": rng.integers(0, 2, 8)}
    for k, v in want.items():
        np.testing.assert_array_equal(run.loader[0][k], v, err_msg=k)
    rates = []
    orig = opt.adam
    monkeypatch.setattr(opt, "adam", lambda lr, *a, **k: rates.append(lr)
                        or orig(lr, *a, **k))
    args = ["ncf", "--batch-size", "8", "--steps-per-epoch", "1", "--device",
            "cpu", "--workspace", str(tmp_path)]
    first, _ = cli(args)
    second, _ = cli(args + ["--resume", "true"])
    assert rates == [0.1, 0.1]
    assert first.step == second.step == 1


TFT_CLI_KW = dict(hidden=8, n_heads=2)


@pytest.fixture
def small_tft(monkeypatch):
    """The command's TFT at hidden 8, 2 heads (the runner's 168 + 24 steps
    and its four columns)."""
    cfg_cls = tft.TFTConfig
    monkeypatch.setattr(tft, "TFTConfig",
                        lambda **kw: cfg_cls(**{**kw, **TFT_CLI_KW}))


def _jax_test_metrics(run, model) -> dict:
    """JAX's ``forecast_metrics`` on the port's forecasts of the test split."""
    test = timeseries.WindowedTimeSeriesDataset(run.panel, run.spec, 128,
                                                split="test", seed=0)
    preds, targets = [], []
    for batch in test:
        preds.append(run.task.predict_fn(
            model, torch.from_numpy(batch["observed"]),
            torch.from_numpy(batch["known"])).numpy())
        targets.append(batch["target"])
    return jax_ts.forecast_metrics(np.concatenate(preds),
                                   np.concatenate(targets), (0.1, 0.5, 0.9))


@pytest.mark.parametrize("backend", ["synthetic", "npy"])
def test_cli_trains_tft_and_logs_the_test_metrics(tmp_path, small_tft,
                                                  backend):
    """fp32 TFT over the panel's train windows (synthetic, or a
    ``panel.npy`` the test writes), then the test split's metrics, logged
    as ``test.*`` and equal to JAX's ``forecast_metrics`` on the same
    forecasts."""
    args = ["tft", "--batch-size", "128", "--lr", "1e-2", "--device", "cpu",
            "--workspace", str(tmp_path)]
    panel = jax_ts.make_synthetic_series()
    if backend == "npy":
        panel = jax_ts.make_synthetic_series(3, 500, seed=4)
        np.save(tmp_path / "panel.npy", panel)
        args += ["--data-backend", "npy", "--data-dir", str(tmp_path)]
    state, _, metrics = cli(args)
    assert state.model.dtype == torch.float32
    losses = raport_losses(tmp_path / "tft_raport.json")
    assert len(losses) == state.step > 1 and np.isfinite(losses).all()
    run = cli_main.build_tft(cli_main.CommonConfig(
        batch_size=128, data_backend=backend, data_dir=str(tmp_path),
        device="cpu"))
    np.testing.assert_array_equal(run.panel, panel)
    want = _jax_test_metrics(run, state.model)
    assert metrics == {f"test.{k}": v for k, v in want.items()}
    logged = raport_losses(tmp_path / "tft_raport.json", "test.MAE")
    assert logged == [pytest.approx(want["MAE"], rel=1e-5)]


def test_cli_tft_rate_never_falls_back_and_follows_jaxs_schedule(
        tmp_path, small_tft, monkeypatch):
    """``cfg.lr or 1e-3`` with CommonConfig's 0.1: without ``--lr`` the
    schedule peaks at 0.1, warming up over total // 20 steps, as JAX's
    ``lr_poly_warmup``; the train windows are JAX's."""
    seen = []
    orig = cli_main.lr_poly_warmup
    monkeypatch.setattr(cli_main, "lr_poly_warmup", lambda *a, **k: seen.append(
        a) or orig(*a, **k))
    run = cli_main.build_tft(cli_main.CommonConfig(batch_size=64,
                                                   device="cpu"))
    total = len(run.loader)
    assert seen == [(0.1, max(total // 20, 1), total)]
    jcfg = jax_cli.CommonConfig(batch_size=64)
    spec = jax_ts.TimeSeriesSpec((0, 1), (2, 3), 0, 168, 24)
    want = jax_ts.WindowedTimeSeriesDataset(jax_ts.make_synthetic_series(),
                                            spec, jcfg.batch_size)
    assert len(want) == total
    for a, b in zip(run.loader, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    from deeplearningexamples_tpu.core import optimizers as jax_opt

    jsched = jax_opt.lr_poly_warmup(0.1, max(total // 20, 1), total)
    for step in (0, 1, total // 20, total - 1):
        assert np.float32(orig(0.1, max(total // 20, 1), total)(step)) == \
            np.float32(jsched(step))


def test_cli_tft_takes_its_configs_yml_section(tmp_path, small_tft):
    """``--config-file configs.yml``: the file's ``tft`` section (epochs
    20, batch 64, lr 1e-3) under the flags."""
    from deeplearningexamples_tpu_torch.core import config as cfgmod
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    cfg = cfgmod.resolve(cli_main.CommonConfig(),
                         yaml_path=str(root / "configs.yml"), precision=None,
                         platform=None, model="tft", mode=None)
    assert (cfg.epochs, cfg.batch_size, cfg.lr) == (20, 64, 0.001)
    state, _, _ = cli(["tft", "--config-file", str(root / "configs.yml"),
                       "--epochs", "1", "--batch-size", "256", "--device",
                       "cpu", "--workspace", str(tmp_path)])
    assert state.step == len(timeseries.WindowedTimeSeriesDataset(
        timeseries.make_synthetic_series(),
        timeseries.TimeSeriesSpec((0, 1), (2, 3), 0, 168, 24), 256))


@pytest.mark.parametrize("command", ["ncf", "tft"])
def test_cli_takes_a_mesh(tmp_path, command):
    """``--mesh-data`` is ported (``test_torch_parallel_families.py`` runs
    it on two ranks): two data ranks in one process are JAX's mesh error."""
    with pytest.raises(ValueError, match="!= 1 devices"):
        cli([command, "--mesh-data", "2", "--device", "cpu", "--workspace",
             str(tmp_path)])
