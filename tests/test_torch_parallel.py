"""The port's data and model mesh axes on the CPU: two gloo ranks against
JAX's single-device run of the global batch.

One spawn of two ranks (``tests/torch_dist_worker.py``, torch on one thread
each) runs every multi-rank check while this process runs JAX's side; the
tests read what the ranks wrote. Sizes: BERT 2 layers x 128 wide (2 heads
of 64, so JAX reaches its flash kernels, in interpret mode), B=8 S=32 with
rows that mask 5, 5, 1, 1, 4, 3, 2 and 2 positions (the ranks' masked
counts differ, within each microbatch too), attention dropout 0.1 with the
per-layer seeds handed to both packages; a ResNet of widths 8 at 32 x 32,
B=8; DLRM with 3 tables of 101, 53 and 199 rows (353, padded to 360, split
180 / 180 inside the third table). Weights come from JAX (or numpy draws
for JAX's shapes) through ``utils/jax_bridge.py``.

Tolerances, fp32 on both sides (JAX's matmuls at "highest"): BERT's
3-step LAMB losses within 2e-4 relative and parameters within 2e-4 + 2e-3
relative (``test_torch_bert_pretrain.py``'s curve tolerance: bf16 moments,
fp32 sums in another order); ResNet gradients within 1e-4 of each tensor's
largest entry and BN running statistics within 1e-5 of each tensor's largest
entry against JAX in float64 (``test_torch_convnets.py``'s); DLRM losses
within 1e-5 relative and parameters within 1e-5 of each tensor's largest
entry (``test_torch_dlrm.py``'s). Port against port (ZeRO against none, two
ranks against one): 1e-5 relative on losses, BERT's parameters at the curve
tolerance above (LAMB's bf16 moments round apart where a norm or a gradient
sums in another order; a different dropout mask moves the first loss by
about 1e-2), AUC within 1e-5.
"""

import contextlib
import itertools
import os
import socket
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.core.flat import flatten_train as jax_flatten_train
from deeplearningexamples_tpu.core.flat import unflatten as jax_unflatten
from deeplearningexamples_tpu.core.optimizers import lr_poly_warmup as jax_poly
from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.models.dlrm import DlrmConfig as JaxDlrmConfig
from deeplearningexamples_tpu.models.dlrm import DlrmTask as JaxDlrmTask
from deeplearningexamples_tpu.models.dlrm import (
    make_dlrm_optimizer as jax_make_dlrm_optimizer,
)
from deeplearningexamples_tpu.ops.lamb import lamb as jax_lamb
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager
from deeplearningexamples_tpu_torch.data.synthetic import SyntheticDlrmLoader
from deeplearningexamples_tpu_torch.models.bert import modeling
from deeplearningexamples_tpu_torch.parallel import mesh
from deeplearningexamples_tpu_torch.parallel.dist import (
    device_for_rank,
    initialize_distributed,
    slurm_coordinator,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_pretrain_state_dict_from_jax,
    dlrm_state_dict_from_jax,
    resnet_state_dict_from_jax,
)
from test_torch_convnets import (
    SMALL as RESNET_ARCH,
    C as RESNET_CLASSES,
    _apply64,
    _check_grads,
    _images,
    _jax_loss_and_grads,
    _jax_model,
    _jax_variables,
    _labels,
    _rel,
)
from torch_dist_worker import BERT_TOTAL, bert_params, patch_attention_seeds, run_bert
from torch_threads import torch_one_thread  # noqa: F401

BERT = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64,
            hidden_dropout=0.0, attention_dropout=0.1)
HIDDEN = dict(BERT, hidden_dropout=0.1)
B, S, P = 8, 32, 6
COUNTS = (5, 5, 1, 1, 4, 3, 2, 2)  # masked positions of each row
SEEDS = (123456789, -987654321)  # K1's dropout seed of layer 0 and 1
LR = 1e-2
DLRM = dict(categorical_cardinalities=(101, 53, 199), embedding_dim=16,
            bottom_mlp=(32, 16), top_mlp=(32, 16, 1))
DLRM_B = 64
CLI_DLRM = ["dlrm", "--device", "cpu", "--cardinality", "97", "--num-tables",
            "3", "--embedding-dim", "16", "--batch-size", "64",
            "--steps-per-epoch", "3", "--lr", "0.1", "--amp", "false"]
ROOT = Path(__file__).resolve().parent.parent


def _bert_batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, BERT["vocab_size"], size=(B, S)).astype(np.int32)
    lengths = np.asarray([S, S - 5, S - 11, S, S - 2, S, S - 7, S])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    types = (np.arange(S)[None, :] >= S // 2).astype(np.int32) * mask
    labels = np.full((B, S), -1, np.int32)
    for i, n in enumerate(COUNTS):
        pos = rng.choice(lengths[i], size=n, replace=False)
        labels[i, pos] = rng.integers(1, BERT["vocab_size"], size=n)
    nsp = rng.integers(0, 2, size=(B,)).astype(np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask,
            "token_type_ids": types, "mlm_labels": labels, "nsp_label": nsp}


@contextlib.contextmanager
def _jax_attention_seeds():
    """JAX's K1 seed draw (``jax.random.randint(key, (), -2**31, ...)`` in
    ``BertSelfAttention``) gives ``SEEDS`` by layer, at every trace: the
    draws of each thread's traces are counted apart (the fixture traces
    three runs at once)."""
    real, local = jax.random.randint, threading.local()

    def fixed(key, shape, minval, maxval, *args, **kw):
        if tuple(shape) == () and minval == -2**31:
            calls = local.__dict__.setdefault("calls", itertools.count())
            return jnp.int32(SEEDS[next(calls) % len(SEEDS)])
        return real(key, shape, minval, maxval, *args, **kw)

    jax.random.randint = fixed
    try:
        yield
    finally:
        jax.random.randint = real


def _jax_bert(params, batch, flat=False, accum=1, steps=3):
    jtask = JaxPretrainTask(JaxBertConfig(**BERT), dtype=jnp.float32,
                            max_predictions=P)
    sched = jax_poly(LR, 1, BERT_TOTAL)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.default_matmul_precision("highest"):
        if flat:
            loss_fn, tx, params = jax_flatten_train(
                jtask.loss_fn, params, lr=sched, weight_decay=0.01,
                moment_dtype=jnp.bfloat16)
        else:
            loss_fn = jtask.loss_fn
            tx = jax_lamb(sched, weight_decay=0.01, moment_dtype=jnp.bfloat16,
                          mask=jax.tree_util.tree_map(lambda p: p.ndim > 1,
                                                      params))
        step = jax_make_train_step(loss_fn, tx, accum_steps=accum)
        state = jax_create_train_state(params, tx, jax.random.key(1))
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        losses = []
        for _ in range(steps):
            state, m = step(state, jb)
            losses.append(float(m["loss"]))
    out = state.params
    if flat:
        out = jax_unflatten(loss_fn.layout, out, loss_fn.dtypes)
    return losses, bert_pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, out))


def _jax_dlrm(params, batch, steps=3):
    jtask = JaxDlrmTask(JaxDlrmConfig(**DLRM), jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_make_dlrm_optimizer(params, mlp_lr=0.05, embedding_lr=0.7)
    with jax.default_matmul_precision("highest"):
        state = jax_create_train_state(params, tx, jax.random.key(1), {})
        step = jax_make_train_step(jtask.loss_fn, tx, donate=False)
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        losses, norms = [], []
        for _ in range(steps):
            state, m = step(state, jb)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, dlrm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params)), norms


def _jax_resnet(variables, images, labels):
    """JAX's float64 gradients of the global batch's CE and the training
    forward's new batch statistics."""
    with jax.enable_x64(True):
        grads = _jax_loss_and_grads(
            _jax_model("resnet", dtype=jnp.float64),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables),
            {"image": images.astype(np.float64), "label": labels}, 0.0)[1]
    return grads, _apply64("resnet", 11, B)[2]["batch_stats"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs written, the two ranks started, JAX's side computed while
    they run; then each rank's results, JAX's, and the port's one-rank
    runs."""
    out = tmp_path_factory.mktemp("dist")
    jtask = JaxPretrainTask(JaxBertConfig(**BERT), dtype=jnp.float32,
                            max_predictions=P)
    bert_jax = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jtask.init(key, seq_len=S, batch=1)[0])(jax.random.key(0)))
    bert_sd = bert_pretrain_state_dict_from_jax(bert_jax)
    batch = _bert_batch()
    rv = _jax_variables("resnet", False, True)
    images, labels = _images(11, B), _labels(12, B)
    dlrm_jax = jax.tree_util.tree_map(np.asarray, JaxDlrmTask(
        JaxDlrmConfig(**DLRM), jnp.float32).init(jax.random.key(3))[0])
    dlrm_batch = {k: v.copy() for k, v in next(iter(SyntheticDlrmLoader(
        DLRM_B, list(DLRM["categorical_cardinalities"]), steps=1,
        seed=4))).items()}
    torch.save({
        "bert": {"cfg": BERT, "sd": bert_sd, "batch": batch, "p": P,
                 "seeds": SEEDS, "lr": LR},
        "hidden_cfg": HIDDEN,
        "resnet": {"arch": RESNET_ARCH, "classes": RESNET_CLASSES,
                   "sd": resnet_state_dict_from_jax(rv["params"],
                                                    rv["batch_stats"]),
                   "images": images, "labels": labels},
        "dlrm": {"cfg": DLRM, "sd": dlrm_state_dict_from_jax(dlrm_jax),
                 "batch": dlrm_batch},
        "cli_dlrm": CLI_DLRM,
    }, out / "inputs.pt")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), "2", str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        # XLA compiles JAX's runs on threads of their own while this thread
        # runs the port's one-rank runs
        with _jax_attention_seeds(), ThreadPoolExecutor(5) as pool:
            jobs = {f"bert_{name}": pool.submit(_jax_bert, bert_jax, batch, **kw)
                    for name, kw in (("tree", {}), ("accum", dict(accum=2)),
                                     ("flat", dict(flat=True)))}
            jobs["dlrm"] = pool.submit(_jax_dlrm, dlrm_jax, dlrm_batch)
            jobs["resnet"] = pool.submit(_jax_resnet, rv, images, labels)
            # the port in this process: one rank, no process group
            losses, state, _ = run_bert(HIDDEN, bert_sd, batch, P, steps=2,
                                        lr=LR)
            one = {"bert_hidden": {"losses": losses,
                                   "params": bert_params(state)}}
            _, one["cli_dlrm"] = cli([*CLI_DLRM, "--workspace",
                                      str(out / "one")])
            jax_side = {k: f.result() for k, f in jobs.items()}
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"dir": out, "ranks": ranks, "jax": jax_side, "one": one,
            "bert_sd": bert_sd, "batch": batch}


def _close(got: dict, want: dict, atol: float, rtol: float = 0.0,
           scaled: bool = False) -> None:
    """Each named tensor of ``got`` against ``want``; ``scaled``: ``atol``
    is relative to each tensor's largest entry."""
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float64)
        tol = atol * max(float(np.abs(w).max()), 1e-30) if scaled else atol
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=rtol,
                                   atol=tol, err_msg=name)


# -- the mesh's logic, no process group -------------------------------------


@pytest.mark.parametrize("spec,n,want", [
    (dict(), 1, (1, 1, 1)), (dict(), 8, (8, 1, 1)),
    (dict(model=2), 8, (4, 2, 1)), (dict(data=2, model=-1), 8, (2, 4, 1)),
    (dict(data=1, model=2), 2, (1, 2, 1)), (dict(data=2, model=2), 4, (2, 2, 1)),
    (dict(data=-1, sequence=2), 4, (2, 1, 2)),
    (dict(data=-1, model=-1), 4, "at most one mesh axis"),
    (dict(model=3), 8, "8 devices not divisible by 3"),
    (dict(data=2), 1, r"mesh \[2, 1, 1\] != 1 devices"),
    (dict(data=2, model=2), 8, r"mesh \[2, 2, 1\] != 8 devices"),
])
def test_mesh_spec_resolves_as_jax(spec, n, want):
    from deeplearningexamples_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

    if isinstance(want, str):
        for cls in (mesh.MeshSpec, JaxMeshSpec):
            with pytest.raises(ValueError, match=want):
                cls(**spec).resolve(n)
    else:
        assert mesh.MeshSpec(**spec).resolve(n) == want \
            == JaxMeshSpec(**spec).resolve(n)


def test_initialize_distributed_reads_slurm_and_explicit_arguments():
    """SLURM's environment parsed as JAX parses it (the explicit arguments
    are the two ranks' start-up in the other tests)."""
    env = {"SLURM_JOB_NUM_NODES": "2", "SLURM_STEP_NODELIST": "node[3-4]",
           "SLURM_PROCID": "5", "SLURM_NTASKS": "16"}
    assert slurm_coordinator(env) == ("node3:12345", 16, 5)
    assert slurm_coordinator({**env, "COORDINATOR_PORT": "999",
                              "SLURM_NTASKS": "2"}) == ("node3:999", 2, 5)
    no_tasks = {k: v for k, v in env.items() if k != "SLURM_NTASKS"}
    assert slurm_coordinator(no_tasks) == ("node3:12345", 2, 5)
    assert slurm_coordinator({"SLURM_JOB_NUM_NODES": "1"}) is None
    assert slurm_coordinator({}) is None
    # neither arguments, SLURM nor torchrun: no process group, one rank
    assert initialize_distributed(device="cpu", env={}) == {
        "process_index": 0, "process_count": 1, "device_count": 1}
    assert not torch.distributed.is_initialized()
    assert device_for_rank("cpu") == torch.device("cpu")
    assert mesh.build_mesh().shape == {"data": 1, "model": 1, "sequence": 1}


def test_batch_rows_follow_jax_microbatches(monkeypatch):
    """Rank 1 of 2 data ranks: its rows of each of JAX's contiguous
    microbatches, lists (SSD300's ``gt``) alike; unsharded on one rank."""
    x = np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(mesh.shard_batch({"x": x})["x"], x)
    monkeypatch.setattr(mesh, "_current", mesh.Mesh((2, 1, 1), rank=1))
    got = mesh.shard_batch({"x": x, "gt": list(range(8)), "n": 3})
    np.testing.assert_array_equal(got["x"], x[4:])
    assert got["gt"] == [4, 5, 6, 7] and got["n"] == 3
    got = mesh.shard_batch({"x": torch.as_tensor(x), "gt": list(range(8))},
                           accum_steps=2)
    np.testing.assert_array_equal(got["x"].numpy(), x[[2, 3, 6, 7]])
    assert got["gt"] == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="microbatches"):
        mesh.shard_batch({"x": x}, accum_steps=3)
    assert mesh.data_rows(4) == (4, 8) and mesh.rank_rows(7) == (3, 7)
    assert mesh.Mesh((2, 3, 2), rank=9).coords == {
        "data": 1, "model": 1, "sequence": 1}  # rank = (d M + m) S + s


# -- two ranks -----------------------------------------------------------------


def test_ranks_sit_on_the_mesh_and_collectives_transpose(run):
    r0, r1 = run["ranks"]
    assert r0["info"] == {"process_index": 0, "process_count": 2,
                          "device_count": 2}
    assert r1["coords"] == {"data": 1, "model": 0, "sequence": 0}
    # sum_over_ranks: d/dx_r sum_q q * (x_1 + x_2) = 1 + 2 on both ranks;
    # sum_partials: each rank's own cotangent, r
    for r, res in enumerate((r0, r1)):
        assert res["transposes"]["over_ranks"].tolist() == [3.0] * 3
        assert res["transposes"]["partials"].tolist() == [r + 1.0] * 3


@pytest.mark.parametrize("mode", ["tree", "accum", "flat"])
def test_bert_pretrain_data2_matches_jax(run, mode):
    """Three LAMB steps at data 2, attention dropout on, masked counts that
    differ between the ranks (and within each microbatch under
    ``--accum-steps 2``), against JAX's one-device run of the batch."""
    want_losses, want = run["jax"][f"bert_{mode}"]
    for res in run["ranks"]:
        got = res[f"bert_{mode}"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-4)
        _close({k: v.numpy() for k, v in got["params"].items()}, want,
               atol=2e-4, rtol=2e-3)
    # the dropout drew: with rate 0 the losses would differ
    assert run["ranks"][0]["bert_tree"]["losses"][0] != \
        run["ranks"][0]["bert_hidden"]["losses"][0]


def test_zero_matches_no_zero_with_half_of_each_sharded_moment(run):
    """Losses within 1e-5, parameters at the curve's tolerance: ZeRO sums
    a leaf's ||p|| and ||u|| from its two halves, and a trust ratio one fp32
    rounding apart can round a bf16 moment the other way."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res["bert_zero"]["losses"],
                                   res["bert_tree"]["losses"], rtol=1e-5)
        _close(res["bert_zero"]["params"], res["bert_tree"]["params"],
               atol=2e-4, rtol=2e-3)
        rows = res["zero_mu_rows"]
        full = {n: v.shape[0] for n, v in run["bert_sd"].items()}
        sharded = {n for n, v in run["bert_sd"].items()
                   if v.size >= 2**15 and v.shape[0] % 2 == 0}
        assert "bert.embeddings.word_embeddings.weight" in sharded
        for n in full:
            assert rows[n] == (full[n] // 2 if n in sharded else full[n]), n


def test_zero_checkpoint_saved_at_world_2_resumes_at_world_1(run):
    """Rank 0 wrote the one-rank checkpoint (moments gathered whole); a
    one-rank run restores it and its fourth step is the two ranks'."""
    ckpt = CheckpointManager(str(run["dir"] / "zero_ckpt"))
    assert ckpt.latest_step() == 3
    drawn = modeling.attention_seed
    patch_attention_seeds(SEEDS)
    try:
        _, state, (step, tb) = run_bert(BERT, run["bert_sd"], run["batch"], P,
                                        steps=0, lr=LR)
        state = ckpt.restore(state)
        assert state.step == 3 and state.opt_state.count == 3
        table = "bert.embeddings.word_embeddings.weight"
        assert state.opt_state.mu[table].shape == run["bert_sd"][table].shape
        state, m = step(state, tb)
    finally:
        modeling.attention_seed = drawn
    want = run["ranks"][0]["zero_step4"]
    assert abs(float(m["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
    _close(bert_params(state), want["params"], atol=2e-4, rtol=2e-3)


def test_hidden_dropout_draws_the_one_rank_masks(run):
    """Hidden and attention dropout on, seeds drawn from the generator:
    two data ranks take the one-rank run's masks for their rows."""
    want = run["one"]["bert_hidden"]
    for res in run["ranks"]:
        np.testing.assert_allclose(res["bert_hidden"]["losses"],
                                   want["losses"], rtol=1e-5)
        _close(res["bert_hidden"]["params"], want["params"], atol=2e-4,
               rtol=2e-3)


def test_resnet_gradients_and_global_bn_statistics_match_jax(run):
    grads, stats = run["jax"]["resnet"]
    want_grads = resnet_state_dict_from_jax(grads)
    rv = _jax_variables("resnet", False, True)
    want_stats = resnet_state_dict_from_jax(rv["params"], stats)
    for res in run["ranks"]:
        grads, buffers = res["resnet"]
        _check_grads(grads, want_grads)
        for name, b in buffers.items():
            if name.endswith(("running_mean", "running_var")):
                assert _rel(b.numpy(), want_stats[name]) <= 1e-5, name


@pytest.mark.parametrize("axis", ["model", "data"])
def test_dlrm_matches_jax(run, axis):
    """Three dual-SGD steps with the table row-sharded over 2 model ranks
    (180 rows each) or the batch over 2 data ranks; each rank's
    ``grad_norm`` is the whole gradient's, the table's rows of both model
    ranks included."""
    want_losses, want, want_norms = run["jax"]["dlrm"]
    for res in run["ranks"]:
        losses, params, rows, norms = res[f"dlrm_{axis}"]
        assert rows == (180 if axis == "model" else 360)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
        _close({k: v.numpy() for k, v in params.items()}, want, atol=1e-5,
               scaled=True)


def test_dlrm_cli_auc_at_world_2_equals_world_1(run):
    """``dlrm --mesh-data 2`` through the CLI: the eval set's AUC over both
    ranks' scores is the one-rank run's; only rank 0 logs and checkpoints."""
    want = run["one"]["cli_dlrm"]
    for res in run["ranks"]:
        assert abs(res["cli_dlrm"]["auc"] - want) <= 1e-5
    assert (run["dir"] / "cli_dlrm_0" / "dlrm_raport.json").exists()
    assert (run["dir"] / "cli_dlrm_0" / "dlrm_ckpt" / "ckpt_3.pt").exists()
    assert not (run["dir"] / "cli_dlrm_1" / "dlrm_raport.json").exists()
    assert not list((run["dir"] / "cli_dlrm_1" / "dlrm_ckpt").glob("*.pt"))


@pytest.mark.parametrize("case,rows", [("odd", "63 rows does not split into 1 "),
                                       ("odd_accum", "6 rows does not split "
                                                     "into 2 ")])
def test_cli_refuses_a_batch_that_does_not_split_over_data_ranks(run, case,
                                                                 rows):
    """``--mesh-data 2`` with ``dlrm``'s training batch of 63 rows, or
    ``resnet50``'s 6 rows under ``--accum-steps 2``: both ranks raise before
    any step, as JAX's ``shard_batch`` would refuse the batch."""
    for res in run["ranks"]:
        assert res[f"cli_{case}"] is not None and rows in res[f"cli_{case}"]
