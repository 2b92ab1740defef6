"""Port parity: DLRM training in torch against the JAX package.

The JAX package's small DLRM config (4 tables, D=32, narrow MLPs). Weights
are made by the JAX initialisers and carried over with the port's bridge,
which also carries JAX gradients across. Both sides run in fp32 on the CPU,
JAX's matmuls at "highest", so only summation order differs: logits, loss
and the loss curve within 1e-5 relative, each gradient within 1e-5 of its
largest entry.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.core.metrics import roc_auc as jax_roc_auc
from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.data.synthetic import (
    SyntheticDlrmLoader as JaxDlrmLoader,
)
from deeplearningexamples_tpu.models.dlrm import DlrmConfig as JaxDlrmConfig
from deeplearningexamples_tpu.models.dlrm import DlrmTask as JaxDlrmTask
from deeplearningexamples_tpu.models.dlrm import (
    make_dlrm_optimizer as jax_make_dlrm_optimizer,
)
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core.logging import Logger
from deeplearningexamples_tpu_torch.core.loop import LoopConfig, train_loop
from deeplearningexamples_tpu_torch.core.metrics import roc_auc
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.data.synthetic import SyntheticDlrmLoader
from deeplearningexamples_tpu_torch.models.dlrm import (
    Dlrm,
    DlrmConfig,
    DlrmTask,
    make_dlrm_optimizer,
)
from deeplearningexamples_tpu_torch.ops import embedding as emb
from deeplearningexamples_tpu_torch.utils.jax_bridge import dlrm_state_dict_from_jax
from torch_threads import torch_one_thread  # noqa: F401

CARDS = (100, 50, 200, 30)
SMALL = dict(categorical_cardinalities=CARDS, embedding_dim=32,
             bottom_mlp=(64, 32), top_mlp=(64, 32, 1))
B = 64
RTOL = 1e-5  # logits, loss, loss curve
GTOL = 1e-5  # each gradient, relative to its largest entry

VARIANTS = {
    "dot": {},
    "cat": dict(interaction="cat"),
    "hash": dict(hash_indices=True),
    "sorted": dict(embedding_grad="sorted"),
    "bf16_table": dict(table_dtype="bf16"),
}


def _cfgs(variant):
    kw = dict(SMALL, **VARIANTS[variant])
    return JaxDlrmConfig(**kw), DlrmConfig(**kw)


@pytest.fixture(scope="module")
def jax_params():
    """JAX-initialised params of each variant, as numpy."""
    out = {}
    for variant in VARIANTS:
        jcfg, _ = _cfgs(variant)
        params, _ = JaxDlrmTask(jcfg, jnp.float32).init(jax.random.key(0))
        out[variant] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _tensor(x: np.ndarray) -> torch.Tensor:
    if x.dtype == jnp.bfloat16:  # numpy has no bf16 of its own
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _port_model(params, variant="dot", dtype=torch.float32) -> Dlrm:
    model = Dlrm(_cfgs(variant)[1], dtype)
    sd = dlrm_state_dict_from_jax(params)
    model.load_state_dict({k: _tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _batch(seed=0, hashed=False):
    batch = next(iter(SyntheticDlrmLoader(B, list(CARDS), steps=1, seed=seed)))
    batch = {k: v.copy() for k, v in batch.items()}
    if hashed:  # out of range before hash_indices folds them back
        batch["categorical"][::3] += np.asarray(CARDS, np.int32) * 7
        batch["categorical"][1::5] -= 10_000
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_bridge_covers_the_model(jax_params):
    model = _port_model(jax_params["dot"])
    names = {n for n, _ in model.named_parameters()}
    assert names == set(dlrm_state_dict_from_jax(jax_params["dot"]))
    assert names == {"embedding_table", "bottom_mlp.0.weight", "bottom_mlp.0.bias",
                     "bottom_mlp.1.weight", "bottom_mlp.1.bias",
                     *(f"top_mlp.{i}.{w}" for i in range(3)
                       for w in ("weight", "bias"))}
    np.testing.assert_array_equal(model.top_mlp[1].weight.detach().numpy(),
                                  jax_params["dot"]["top_mlp_1"]["kernel"].T)
    assert model.embedding_table.shape == (-(-sum(CARDS) // 8) * 8, 32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_and_loss_match_jax(jax_params, variant):
    jcfg, _ = _cfgs(variant)
    batch = _batch(hashed=variant == "hash")
    jtask = JaxDlrmTask(jcfg, jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jtask.model.apply(
            {"params": jax_params[variant]}, batch["numerical"],
            batch["categorical"]))
        want_loss, _ = jtask.loss_fn(jax_params[variant], {}, batch, None)
    model = _port_model(jax_params[variant], variant)
    task = DlrmTask(_cfgs(variant)[1], torch.float32)
    with torch.no_grad():
        got = model(*(_torch_batch(batch)[k] for k in ("numerical", "categorical")))
        loss, _ = task.loss_fn(model, {}, _torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)


@pytest.mark.parametrize("variant", ["dot", "cat", "sorted"])
def test_loss_and_gradients_match_jax(jax_params, variant):
    jcfg, _ = _cfgs(variant)
    batch = _batch(1)
    jtask = JaxDlrmTask(jcfg, jnp.float32)
    with jax.default_matmul_precision("highest"):
        (want_loss, _), jgrads = jax.value_and_grad(
            lambda p: jtask.loss_fn(p, {}, batch, None), has_aux=True)(
                jax_params[variant])
    want = dlrm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = _port_model(jax_params[variant], variant)
    task = DlrmTask(_cfgs(variant)[1], torch.float32)
    loss, _ = task.loss_fn(model, {}, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    for name, p in model.named_parameters():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=GTOL * scale, err_msg=name)


def _jax_curve(params, steps, use_adam):
    jtask = JaxDlrmTask(_cfgs("dot")[0], jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_make_dlrm_optimizer(params, mlp_lr=0.05, embedding_lr=0.7,
                                 use_adam_for_mlp=use_adam)
    with jax.default_matmul_precision("highest"):
        state = jax_create_train_state(params, tx, jax.random.key(1), {})
        step = jax_make_train_step(jtask.loss_fn, tx, donate=False)
        batch = jax.tree_util.tree_map(jnp.asarray, _batch(2))
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return losses, dlrm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params))


@pytest.mark.parametrize("mlp_opt", ["sgd", "adam"])
def test_loss_curve_matches_jax(jax_params, mlp_opt):
    """Five steps of the dual optimizer with different MLP and embedding
    rates: losses within 1e-5, parameters within 1e-5 of their largest."""
    steps = 5
    want, want_params = _jax_curve(jax_params["dot"], steps, mlp_opt == "adam")
    model = _port_model(jax_params["dot"])
    task = DlrmTask(_cfgs("dot")[1], torch.float32)
    tx = make_dlrm_optimizer(mlp_lr=0.05, embedding_lr=0.7,
                             use_adam_for_mlp=mlp_opt == "adam")
    state = create_train_state(model, tx, 1)
    step = make_train_step(task.loss_fn, tx)
    batch = _torch_batch(_batch(2))
    got = []
    for _ in range(steps):
        state, m = step(state, batch)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1] < got[0]
    for name, p in state.model.named_parameters():
        scale = float(np.abs(want_params[name]).max())
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   rtol=0, atol=GTOL * scale, err_msg=name)


def test_configs_rate_diverges_alike_in_both_packages(jax_params):
    """configs.yml's DLRM rate, 24, taken as a constant (the reference warms
    up to it): both packages' losses climb to NaN by the fifth step, along
    the same values (within 1e-5) while they are finite."""
    jtask = JaxDlrmTask(_cfgs("dot")[0], jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params["dot"])
    tx = jax_make_dlrm_optimizer(params, mlp_lr=24.0, embedding_lr=24.0)
    batch = _batch(2)
    with jax.default_matmul_precision("highest"):
        state = jax_create_train_state(params, tx, jax.random.key(1), {})
        step = jax_make_train_step(jtask.loss_fn, tx, donate=False)
        want = []
        for _ in range(5):
            state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
            want.append(float(m["loss"]))
    model = _port_model(jax_params["dot"])
    tx = make_dlrm_optimizer(mlp_lr=24.0, embedding_lr=24.0)
    pstate = create_train_state(model, tx, 1)
    pstep = make_train_step(DlrmTask(_cfgs("dot")[1], torch.float32).loss_fn, tx)
    got = []
    for _ in range(5):
        pstate, m = pstep(pstate, _torch_batch(batch))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got[:4], want[:4], rtol=RTOL)
    assert want[3] > 1e6 * want[0]
    assert np.isnan(got[4]) and np.isnan(want[4])


def test_dual_optimizer_separate_lrs(jax_params):
    model = _port_model(jax_params["dot"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    task = DlrmTask(_cfgs("dot")[1], torch.float32)
    tx = make_dlrm_optimizer(mlp_lr=0.0, embedding_lr=1.0)
    state = create_train_state(model, tx, 1)
    state, _ = make_train_step(task.loss_fn, tx)(state, _torch_batch(_batch()))
    assert state.opt_state == {"mlp": 1, "emb": 1}
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == (n == "embedding_table"), n


def test_roc_auc_and_eval_reduce_match_jax():
    """With ties: both argsorts are stable, so tied scores fall in input
    order on both sides."""
    rng = np.random.default_rng(3)
    scores = np.round(rng.normal(size=500), 1).astype(np.float32)  # many ties
    labels = rng.integers(0, 2, 500).astype(np.float32)
    want = float(jax_roc_auc(jnp.asarray(scores), jnp.asarray(labels)))
    got = float(roc_auc(torch.from_numpy(scores), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(roc_auc(torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5, 0.4]),
                         torch.tensor([1.0, 1, 0, 1, 0, 0]))) == pytest.approx(8 / 9)
    assert np.isfinite(float(roc_auc(torch.from_numpy(scores), torch.ones(500))))
    flat = {"score": scores, "label": labels,
            "bce": rng.random(500).astype(np.float32)}
    want = JaxDlrmTask.eval_reduce(flat)
    got = DlrmTask.eval_reduce(flat)
    assert got["auc"] == pytest.approx(want["auc"], rel=1e-12)
    assert got["val_loss"] == want["val_loss"]


@pytest.mark.parametrize("skew", ["uniform", "zipf"])
def test_synthetic_loader_matches_jax(skew):
    cards = [100_000, 30, 1000]
    want = next(iter(JaxDlrmLoader(256, cards, steps=1, seed=5, skew=skew)))
    got = next(iter(SyntheticDlrmLoader(256, cards, steps=1, seed=5, skew=skew)))
    assert set(got) == set(want) == {"numerical", "categorical", "label"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["categorical"] < np.asarray(cards)).all()
    with pytest.raises(ValueError, match="skew"):
        SyntheticDlrmLoader(4, cards, skew="pareto")


class _Counter:
    """A loop state and steps that count what the loop runs."""

    def __init__(self):
        self.step, self.model, self.model_state = 0, None, {}
        self.evals = []

    def train_step(self, state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    def eval_step(self, model, model_state, batch):
        self.evals.append(self.step)
        return {"score": torch.tensor([0.9, 0.1]) + batch,
                "label": torch.tensor([1.0, 0.0]), "bce": torch.tensor(0.5)}


def test_loop_eval_reduce_interval_and_target_metric():
    seen = []

    def reduce(flat):
        seen.append({k: v.shape for k, v in flat.items()})
        return {"auc": 0.75 + 0.01 * len(seen)}

    c = _Counter()
    state, best = train_loop(
        c, c.train_step, lambda: range(3),
        cfg=LoopConfig(epochs=8, eval_interval_epochs=2, watch_metric="auc",
                       target_metric=0.77),
        logger=Logger(backends=[]), eval_step=c.eval_step,
        eval_iter_fn=lambda: [0.0, 0.5], eval_reduce=reduce)
    # every second epoch; the second eval reaches the target and stops
    assert c.evals == [6, 6, 12, 12] and state.step == 12
    assert seen == [{"score": (4,), "label": (4,), "bce": (2,)}] * 2
    assert best == pytest.approx(0.77)


def _losses(path):
    lines = [json.loads(line.split(" ", 1)[1])
             for line in path.read_text().splitlines()]
    return ([ln["data"]["train.loss"] for ln in lines
             if ln["type"] == "LOG" and "train.loss" in ln.get("data", {})],
            [ln["data"] for ln in lines
             if ln["type"] == "LOG" and "val.auc" in ln.get("data", {})])


def test_cli_trains_dlrm_on_the_cpu(tmp_path):
    before = emb.launches
    state, best = cli(["dlrm", "--cardinality", "100", "--num-tables", "4",
                       "--batch-size", "64", "--steps-per-epoch", "5",
                       "--device", "cpu", "--workspace", str(tmp_path)])
    assert emb.launches == before  # the CPU run takes the plain gather
    assert state.step == 5 and 0.0 <= best <= 1.0
    assert state.model.embedding_table.shape == (400, 128)
    losses, vals = _losses(tmp_path / "dlrm_raport.json")
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # one repeated batch is memorised
    assert len(vals) == 1 and vals[0]["val.auc"] == best
    assert (tmp_path / "dlrm_ckpt" / "ckpt_5.pt").exists()
    # an AUC target below any reading stops after the first epoch
    state, _ = cli(["dlrm", "--cardinality", "100", "--num-tables", "4",
                    "--batch-size", "64", "--steps-per-epoch", "2",
                    "--epochs", "3", "--auc-threshold", "0.01", "--device",
                    "cpu", "--workspace", str(tmp_path / "t")])
    assert state.step == 2
    # --mesh-model is ported: 2 ranks in one process is JAX's mesh error
    for flags, error, match in (
            (["--data-backend", "parquet"], SystemExit, "not ported"),
            (["--mesh-model", "2"], ValueError, "1 devices")):
        with pytest.raises(error, match=match):
            cli(["dlrm", "--device", "cpu", "--workspace", str(tmp_path), *flags])


def test_task_init_defaults_to_the_card_and_draws_the_jax_ranges():
    import inspect

    assert inspect.signature(DlrmTask.init).parameters["device"].default == "cuda"
    cfg = DlrmConfig(**SMALL)
    model = DlrmTask(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    again = DlrmTask(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    for (n, p), q in zip(model.named_parameters(), again.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), n
    table = model.embedding_table.detach()
    row = 0
    for c in CARDS:  # uniform in +-1/sqrt(c), each table its own bound
        part = table[row:row + c]
        assert float(part.abs().max()) <= 1 / np.sqrt(c)
        assert float(part.abs().max()) > 0.9 / np.sqrt(c)
        row += c
    assert float(table[row:].abs().max()) == 0.0  # the pad rows
    assert dataclasses.is_dataclass(DlrmTask)
    bf16 = DlrmTask(dataclasses.replace(cfg, table_dtype="bf16")).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert bf16.embedding_table.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="embedding_dim"):
        DlrmConfig(categorical_cardinalities=CARDS, embedding_dim=32,
                   bottom_mlp=(64, 16))
