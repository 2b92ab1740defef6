"""The data axis of the seventeen commands PR 14 left on one rank: two gloo
ranks against the port's one-rank run of the same global batch, and three of
them against JAX's one-device run.

One spawn of two ranks (``tests/torch_families_worker.py``, torch on one
thread each) runs every command through the CLI at ``--mesh-data 2``
(``tacotron2``, ``waveglow``, ``transformer``, ``bart``, ``gnmt``,
``fastpitch``, ``hifigan``, ``jasper``, ``wav2vec2``, ``ncf``, ``tft``,
``nnunet``, ``transformer-xl``, ``moflow``, ``se3-transformer``,
``efficientdet``, ``maskrcnn``), ``transformer`` once more at ``--mesh-data 1
--mesh-sequence 2``, then one step each of the Transformer NMT, wav2vec 2.0
and EfficientDet on JAX's weights, while this process runs the same
commands on one rank and JAX's side on threads. Sizes: the widths of
``torch_families_worker`` (1-2 layers, widths 8-64, Mask R-CNN on
resnet18 at 128 px with its proposals pinned), a global batch of 4 split
2 / 2, fp32, dropout on wherever the model has it, 2 steps. The rows'
valid counts differ between the ranks: BART's target tokens, wav2vec 2.0's
masked frames, EfficientDet's positive anchors, Mask R-CNN's live ROI slots
and positives; the steps held against JAX add padded sources and targets to
the Transformer. This file takes about 55 s alone on one pytest worker
on the CPU (the fixture about 39 s, importing JAX and its models about
10 s).

Limits, two ranks against one: losses within 1e-5 relative; the first
step's gradients after the data axis's mean within 1e-5 of each tensor's
largest entry (``GTOL``), a tensor whose gradient is 0 but for rounding (a
bias before a BN, a key projection's bias) held to 1e-5 of a tenth of the
largest gradient of all; the BN-heavy convolutional models are held to
1e-4 (Jasper, EfficientDet: their fp32 BN backward over the batch's frames
or pixels cancels, and two ranks' partial sums round about 2e-5 of a
tensor apart), Mask R-CNN to 1e-3 (the mask head's ReLUs flip on the
pooled features' rounding, as in ``test_torch_maskrcnn.py``); BN
running statistics after the first step within 1e-5 of max(1, the tensor's
largest entry); the ranks' parameters equal bit for bit; the eval metrics
(BART's ROUGE of the beam-decoded val split, TFT's test-split forecast
metrics, HiFi-GAN's logged losses) equal, the continuous ones to 1e-5
relative. Against JAX, the limits of the world-1 parity tests of each model
(``test_torch_seq2seq.py``, ``test_torch_asr.py``,
``test_torch_efficientdet.py``).
"""

import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.models import efficientdet as jax_det
from deeplearningexamples_tpu.models import wav2vec2 as jax_w2v
from deeplearningexamples_tpu.models.translation import (
    transformer as jax_transformer,
)
from deeplearningexamples_tpu_torch.parallel import mesh
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    efficientdet_state_dict_from_jax,
    transformer_state_dict_from_jax,
    wav2vec2_state_dict_from_jax,
)
from test_torch_asr import (
    GTOL as W2V_GTOL,
    W2V_KW,
    _draw,
    _jax_draws,
    _w2v_params,
    _worst,
)
from test_torch_efficientdet import TOL as DET_TOL
from test_torch_efficientdet import FLOOR as DET_FLOOR
from test_torch_efficientdet import _EvalApply, _jit
from test_torch_seq2seq import GTOL as NMT_GTOL
from torch_families_worker import (
    B, COMMANDS, DET, NMT, SEQUENCE_CASE, TXL, args, run_command,
    small_models,
)
from torch_threads import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LTOL = 1e-5  # a loss, relative
GTOL = {"jasper": 1e-4, "efficientdet": 1e-4, "maskrcnn": 1e-3}  # else 1e-5
STOL = 1e-5  # BN running statistics
MTOL = 1e-5  # a continuous eval metric, relative
JAX_NMT = {**NMT, "dropout": 0.0, "max_len": 24}
SRC_PADS, TGT_LENGTHS = (0, 2, 5, 7), (9, 8, 4, 3)  # rank 0: 15 targets, 1: 5
W2V_AUDIO = 800
DET_GT = (5, 2, 1, 3)  # boxes an image: the ranks' positive anchors differ
DET_S, DET_G = 128, 8


# -- JAX's side: one device, the global batch ---------------------------------


def _nmt_inputs() -> dict:
    task = jax_transformer.TransformerTask(
        jax_transformer.TransformerConfig(**JAX_NMT), jnp.float32)
    params = _draw(jax.eval_shape(lambda: task.init(jax.random.key(0))[0]), 1)
    cfg = task.cfg
    rng = np.random.default_rng(3)
    src = rng.integers(4, NMT["vocab_size"], (B, 10)).astype(np.int32)
    tgt = np.full((B, 9), cfg.pad_id, np.int32)
    for i, (pads, n) in enumerate(zip(SRC_PADS, TGT_LENGTHS)):
        src[i, :pads] = cfg.pad_id
        tgt[i, 0], tgt[i, n - 1] = cfg.bos_id, cfg.eos_id
        tgt[i, 1:n - 1] = rng.integers(4, NMT["vocab_size"], n - 2)
    return {"cfg": JAX_NMT, "params": params, "batch": {"src": src, "tgt": tgt}}


def _w2v_inputs() -> dict:
    cfg = jax_w2v.Wav2Vec2Config(**W2V_KW)
    t = jax_w2v.Wav2Vec2Task(cfg)._n_frames(W2V_AUDIO)
    rng = np.random.default_rng(4)
    batch = {"audio": (0.1 * rng.normal(size=(B, W2V_AUDIO))).astype(np.float32),
             "mask": jax_w2v.sample_spans_mask(rng, B, t, 0.5, 2)}
    draws = _jax_draws(jax.random.key(9), B, t)
    return {"cfg": W2V_KW, "params": _w2v_params(), "batch": batch,
            "draws": {k: v.numpy() for k, v in draws.items()}}


def _det_inputs() -> dict:
    cfg = jax_det.EfficientDetConfig(image_size=DET_S, **DET)
    model = jax_det.EfficientDet(cfg, jnp.float32)
    v = _draw(jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, DET_S, DET_S, 3)), train=False)), 2)
    rng = np.random.default_rng(3)
    boxes = np.zeros((B, DET_G, 4), np.float32)
    labels = np.zeros((B, DET_G), np.int32)
    valid = np.zeros((B, DET_G), bool)
    for i, n in enumerate(DET_GT):
        lo = rng.uniform(0, DET_S * 0.6, (n, 2))
        boxes[i, :n] = np.concatenate(
            [lo, lo + rng.uniform(16, DET_S * 0.4, (n, 2))], 1)
        labels[i, :n] = rng.integers(0, cfg.num_classes, n)
        valid[i, :n] = True
    batch = {"image": rng.normal(size=(B, DET_S, DET_S, 3)).astype(np.float32),
             "boxes": boxes, "labels": labels, "valid": valid}
    return {"cfg": dict(image_size=DET_S, **DET), "variables": v,
            "batch": batch}


def _jax_value_and_grad(loss_fn, params, jit=jax.jit):
    with jax.default_matmul_precision("highest"):
        (loss, (_, metrics)), grads = jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return jax.tree_util.tree_map(np.asarray, (loss, metrics, grads))


def _jax_nmt(inp: dict):
    task = jax_transformer.TransformerTask(
        jax_transformer.TransformerConfig(**inp["cfg"]), jnp.float32)
    return _jax_value_and_grad(
        lambda p: task.loss_fn(p, {}, inp["batch"], jax.random.key(0)),
        inp["params"])


def _jax_w2v(inp: dict):
    task = jax_w2v.Wav2Vec2Task(jax_w2v.Wav2Vec2Config(**inp["cfg"]),
                                jnp.float32)
    return _jax_value_and_grad(
        lambda p: task.loss_fn(p, {}, inp["batch"], jax.random.key(9)),
        inp["params"])


def _jax_det(inp: dict):
    """The eval-mode loss (BN on its running statistics) and gradients."""
    v = inp["variables"]
    task = jax_det.EfficientDetTask(
        jax_det.EfficientDetConfig(**inp["cfg"]), jnp.float32, max_gt=DET_G)
    task.model = _EvalApply(task.model)
    return _jax_value_and_grad(
        lambda p: task.loss_fn(p, v["batch_stats"], inp["batch"],
                               jax.random.key(0)), v["params"], _jit)


# -- the run -------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_rank(out: Path) -> dict:
    """The commands on one rank in this process; Transformer-XL also for
    two epochs, and resumed for its second from the two ranks' checkpoint."""
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        small_models(mp)
        for command in COMMANDS:
            res[command] = run_command(args(command, str(out / command)))
        res["txl_4"] = run_command(args(TXL, str(out / "txl_4"), "--epochs",
                                        "2"))
    return res


def _resumed(out: Path) -> dict:
    ws = out / "txl_resumed"
    shutil.copytree(out / f"{TXL}_0" / "transformer_xl_ckpt",
                    ws / "transformer_xl_ckpt")
    with pytest.MonkeyPatch.context() as mp:
        small_models(mp)
        return run_command(args(TXL, str(ws), "--epochs", "2", "--resume",
                                "true"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_families_worker.py"),
         str(r), "2", str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        return _run(out, procs)
    finally:
        for p in procs:
            p.kill()


def _run(out: Path, procs) -> dict:
    """The held steps' inputs written (the ranks read them after the
    commands), JAX's side and the one-rank runs while the ranks run."""
    held = {"transformer": _nmt_inputs(), "wav2vec2": _w2v_inputs(),
            "efficientdet": _det_inputs()}
    v = held["efficientdet"]["variables"]
    torch.save({
        "transformer": {**held["transformer"], "sd": transformer_state_dict_from_jax(
            held["transformer"]["params"])},
        "wav2vec2": {**held["wav2vec2"], "sd": wav2vec2_state_dict_from_jax(
            held["wav2vec2"]["params"])},
        "efficientdet": {**held["efficientdet"], "g": DET_G,
                         "sd": efficientdet_state_dict_from_jax(
                             v["params"], v["batch_stats"])},
    }, out / "inputs.tmp")
    os.replace(out / "inputs.tmp", out / "inputs.pt")
    # XLA compiles JAX's steps on threads of their own while this thread
    # runs the port's one-rank runs
    with ThreadPoolExecutor(3) as pool:
        jobs = {"transformer": pool.submit(_jax_nmt, held["transformer"]),
                "wav2vec2": pool.submit(_jax_w2v, held["wav2vec2"]),
                "efficientdet": pool.submit(_jax_det, held["efficientdet"])}
        one = _one_rank(out)
        jax_side = {k: f.result() for k, f in jobs.items()}
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    mesh.reset_mesh()
    one["txl_resumed"] = _resumed(out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"dir": out, "ranks": ranks, "one": one, "jax": jax_side}


# -- the checks ----------------------------------------------------------------


def _grads_close(got: dict, want: dict, tol: float) -> None:
    """Each gradient within ``tol`` of max(its largest entry, a tenth of
    the largest of all)."""
    assert got.keys() == want.keys()
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((got[name].double() - w.double()).abs().max())
        assert err <= tol * max(float(w.abs().max()), 0.1 * top), (name, err)


@pytest.mark.parametrize("command", COMMANDS)
def test_command_at_data_2_matches_its_one_rank_run(run, command):
    want = run["one"][command]
    r0, r1 = (res[command] for res in run["ranks"])
    for got in (r0, r1):
        assert len(got["losses"]) == len(want["losses"]) == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LTOL)
        _grads_close(got["grads"], want["grads"], GTOL.get(command, 1e-5))
        assert got["stats"].keys() == want["stats"].keys()
        for name, s in want["stats"].items():
            err = float((got["stats"][name] - s).abs().max())
            assert err <= STOL * max(1.0, float(s.abs().max())), name
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, m in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(m, rel=MTOL, abs=0), k
    assert r0["params"].keys() == r1["params"].keys()
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
    if command == "bart":  # ROUGE of the same decoded tokens
        assert r0["metrics"] == want["metrics"] and want["metrics"]
    # rank 0 alone logs and writes checkpoints
    name = command.replace("-", "_")
    assert (run["dir"] / f"{command}_0" / f"{name}_raport.json").exists()
    assert not (run["dir"] / f"{command}_1" / f"{name}_raport.json").exists()
    assert not list((run["dir"] / f"{command}_1").glob("*_ckpt/*.pt"))


def _held(run, name):
    (loss, metrics, grads), got = run["jax"][name], [
        res["held"][name] for res in run["ranks"]]
    return loss, metrics, grads, got


def test_transformer_at_data_2_matches_jax(run):
    """Padded sources and targets: 15 target tokens on rank 0, 5 on rank 1;
    the label-smoothed loss over the global batch's 20."""
    loss, _, grads, got = _held(run, "transformer")
    want = transformer_state_dict_from_jax(grads)
    for res in got:
        assert abs(res["metrics"]["loss"] - float(loss)) <= LTOL * abs(float(loss))
        (own, n1), (alls, n2) = _worst(
            {k: v.numpy() for k, v in res["grads"].items()}, want)
        assert own <= NMT_GTOL[0] and alls <= NMT_GTOL[1], (n1, own, n2, alls)


def test_wav2vec2_at_data_2_matches_jax(run):
    """JAX's draws of the global batch, each rank its rows; the masked
    frames differ between the ranks; the perplexity is of the global batch's
    mean (its gradient reaches every rank's quantizer)."""
    loss, metrics, grads, got = _held(run, "wav2vec2")
    want = wav2vec2_state_dict_from_jax(grads)
    for res in got:
        m = res["metrics"]
        assert abs(m["loss"] - float(loss)) <= LTOL * abs(float(loss))
        for k in ("contrastive", "diversity"):
            assert abs(m[k] - float(metrics[k])) <= LTOL * abs(float(metrics[k]))
        (own, n1), (alls, n2) = _worst(
            {k: v.numpy() for k, v in res["grads"].items()}, want)
        assert own <= W2V_GTOL[0] and alls <= W2V_GTOL[1], (n1, own, n2, alls)
        assert np.abs(want["quantizer.weight_proj.weight"]).max() > 0


def test_efficientdet_at_data_2_matches_jax(run):
    """BN on its running statistics; 5 + 2 boxes on rank 0, 1 + 3 on rank
    1: the focal and box losses over the global batch's positive anchors."""
    loss, metrics, grads, got = _held(run, "efficientdet")
    want = efficientdet_state_dict_from_jax(grads)
    top = max(float(np.abs(w).max()) for w in want.values())
    for res in got:
        m = res["metrics"]
        for k, w in (("loss", loss), ("cls_loss", metrics["cls_loss"]),
                     ("box_loss", metrics["box_loss"])):
            assert abs(m[k] - float(w)) <= DET_TOL["eval"][0] * abs(float(w)), k
        for n, w in want.items():
            err = float(np.abs(res["grads"][n].double().numpy() - w).max())
            assert err <= DET_TOL["eval"][1] * max(
                float(np.abs(w).max()), DET_FLOOR * top), n
            assert err <= DET_TOL["eval"][2] * top, n


def test_transformer_xl_checkpoint_from_world_2_resumes_at_world_1(run):
    """Rank 0 wrote the memories whole, in the global batch's row order: a
    one-rank run resumed from that checkpoint takes the steps of a one-rank
    run of two epochs."""
    want, got = run["one"]["txl_4"], run["one"]["txl_resumed"]
    np.testing.assert_allclose(want["losses"][:2],
                               run["ranks"][0][TXL]["losses"], rtol=LTOL)
    np.testing.assert_allclose(got["losses"], want["losses"][2:], rtol=LTOL)
    saved = torch.load(run["dir"] / f"{TXL}_0" / "transformer_xl_ckpt" /
                       "ckpt_2.pt", weights_only=True)["model_state"]["mems"]
    whole = [torch.cat(m) for m in zip(*(res[TXL]["mems"]
                                         for res in run["ranks"]))]
    assert [tuple(m.shape) for m in saved] == [tuple(m.shape) for m in whole]
    assert saved[0].shape[0] == B
    for s, w in zip(saved, whole):
        assert torch.equal(s, w)


def test_data_1_sequence_2_repeats_the_one_rank_run(run):
    """``transformer --mesh-data 1 --mesh-sequence 2``: both ranks take the
    whole batch, draw the one-rank run's dropout masks and end with its
    parameters."""
    want = run["one"][SEQUENCE_CASE]
    r0, r1 = (res["sequence"] for res in run["ranks"])
    for got in (r0, r1):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LTOL)
        _grads_close(got["grads"], want["grads"], 1e-5)
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                   rtol=0, atol=1e-6 * max(
                                       1.0, float(p.abs().max())))
    assert (run["dir"] / "sequence_0" / f"{SEQUENCE_CASE}_raport.json").exists()
    assert not (run["dir"] / "sequence_1" /
                f"{SEQUENCE_CASE}_raport.json").exists()
