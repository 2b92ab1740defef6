"""Port parity: Transformer-XL (relative attention, segment memories) and
the ``transformer-xl`` command, in torch against the JAX package.

The model runs at small widths: a vocab of 100 (128 padded), d 16, 2 heads
of 8, an FFN of 32, 2 layers, segments of 6, memories of 5 (shorter than a
segment) and of 8 (longer: the second segment sees a memory 6 of 8 slots
full), dropout 0, B=2. Two segments run in turn with the memories carried in
``model_state``, as the trainer carries them. The JAX side is fp32 at
"highest" precision, jitted once; the port is fp32 on one thread. JAX's
parameters are drawn in numpy for its own shapes and carried into the port
by the bridge, which also carries JAX's gradients across.

Tolerances, relative to the largest entry of the JAX tensor: logits and
memories 1e-5; losses 1e-5 relative; every gradient within 1e-3 of its own
largest entry and 1e-5 of the largest entry of all; ``mem_valid`` and the
round trip through ``convert_transformer_xl`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.models import transformer_xl as jax_txl
from deeplearningexamples_tpu.utils.torch_import import convert_transformer_xl
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager
from deeplearningexamples_tpu_torch.models import transformer_xl as txl
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    transformer_xl_state_dict_from_jax,
)
from torch_parity import (assert_round_trip, draw, grads, jit, load,
                          raport_losses, rel, sd_numpy, tb, worst)
from torch_threads import torch_one_thread  # noqa: F401

FTOL = 1e-5
LTOL = 1e-5
GTOL = (1e-3, 1e-5)
B = 2
CFGS = {
    "mem 5": dict(vocab_size=100, d_model=16, n_heads=2, d_head=8, d_ff=32,
                  n_layers=2, seg_len=6, mem_len=5, dropout=0.0),
    "mem 8": dict(vocab_size=100, d_model=16, n_heads=2, d_head=8, d_ff=32,
                  n_layers=2, seg_len=6, mem_len=8, dropout=0.0),
}


@pytest.fixture(autouse=True)
def _exact_fp32():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _vars(name: str):
    task = jax_txl.TransformerXLTask(jax_txl.TransformerXLConfig(**CFGS[name]),
                                     jnp.float32)
    return draw(jax.eval_shape(lambda: task.init(jax.random.key(0)))[0], 1)


@functools.lru_cache(maxsize=None)
def _segments() -> list[dict]:
    """Two consecutive segments of one token stream per row."""
    toks = np.random.default_rng(2).integers(0, 100, (B, 13))
    return [{"tokens": toks[:, i:i + 6].astype(np.int32),
             "targets": toks[:, i + 1:i + 7].astype(np.int32)}
            for i in (0, 6)]


def _port(name: str) -> txl.TransformerXL:
    return load(txl.TransformerXL(txl.TransformerXLConfig(**CFGS[name]),
                                  torch.float32),
                transformer_xl_state_dict_from_jax(_vars(name)))


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    """Per segment, in turn from ``{}``: JAX's logits, loss, gradients, and
    the new memories and valid count."""
    task = jax_txl.TransformerXLTask(jax_txl.TransformerXLConfig(**CFGS[name]),
                                     jnp.float32)

    def run(params):
        state, out = {}, []
        for seg in _segments():
            mems = state.get("mems")
            valid = state.get("mem_valid", 0 if mems is None else None)
            logits, _ = task.model.apply({"params": params}, seg["tokens"],
                                         mems, valid)
            (loss, (state, _)), g = jax.value_and_grad(
                lambda p: task.loss_fn(p, state, seg, jax.random.key(0)),
                has_aux=True)(params)
            out.append((logits, loss, g, state["mems"], state["mem_valid"]))
        return out

    return jax.tree_util.tree_map(np.asarray, jit(run)(_vars(name)))


def _port_segments(name: str):
    """The port's two steps through ``loss_fn``, the state carried: per
    segment (loss, gradients, new state); the logits of each from a forward
    on the state it started from."""
    model = _port(name)
    task = txl.TransformerXLTask(txl.TransformerXLConfig(**CFGS[name]),
                                 torch.float32)
    state, out = {}, []
    for seg in _segments():
        model.zero_grad()
        with torch.no_grad():
            mems = state.get("mems")
            logits, _ = model(torch.from_numpy(seg["tokens"]), mems,
                              state.get("mem_valid", 0 if mems is None else None))
        loss, (state, metrics) = task.loss_fn(model, state, tb(seg),
                                              torch.Generator())
        loss.backward()
        out.append((logits, loss, grads(model), state, metrics))
    return out


@pytest.mark.parametrize("name", list(CFGS))
def test_two_segments_match_jax(name):
    """Logits, loss and memories of each segment; the second attends to the
    first's memory."""
    want, got = _jax(name), _port_segments(name)
    for i, ((wl, wloss, _, wmems, wvalid), (gl, gloss, _, state, metrics)) in \
            enumerate(zip(want, got)):
        assert gl.shape == wl.shape == (B, 6, 128)
        assert rel(gl.numpy(), wl) < FTOL, i
        assert abs(gloss.item() - float(wloss)) < LTOL * abs(float(wloss)), i
        assert float(metrics["ppl_proxy"]) == gloss.item()
        assert int(state["mem_valid"]) == int(wvalid) == min(6 * (i + 1),
                                                             CFGS[name]["mem_len"])
        assert len(state["mems"]) == len(wmems) == 2
        for m, w in zip(state["mems"], wmems):
            assert not m.requires_grad
            assert rel(m.numpy(), w) < FTOL, i


@pytest.mark.parametrize("name", list(CFGS))
def test_gradients_of_each_segment_match_jax(name):
    for i, ((_, _, g, _, _), (_, _, got, _, _)) in enumerate(
            zip(_jax(name), _port_segments(name))):
        own, top = worst(got, transformer_xl_state_dict_from_jax(g))
        assert own[0] < GTOL[0], (i, own)
        assert top[0] < GTOL[1], (i, top)


def test_second_segment_reads_the_memory():
    """Other tokens in the first segment move the second's logits (through
    its memory) on both sides alike; a fresh sequence (``{}``) equals zero
    memories with none valid."""
    name = "mem 8"
    task = jax_txl.TransformerXLTask(jax_txl.TransformerXLConfig(**CFGS[name]),
                                     jnp.float32)
    model = _port(name)
    seg1, seg2 = _segments()
    other = (seg1["tokens"] + 1) % 100
    outs = []
    for first in (seg1["tokens"], other):
        _, mems = task.model.apply({"params": _vars(name)}, first)
        want, _ = task.model.apply({"params": _vars(name)}, seg2["tokens"],
                                   mems, 6)
        with torch.no_grad():
            _, pmems = model(torch.from_numpy(first))
            got, _ = model(torch.from_numpy(seg2["tokens"]), pmems, 6)
        assert rel(got.numpy(), np.asarray(want)) < FTOL
        outs.append(got)
    assert rel(outs[0].numpy(), outs[1].numpy()) > 1e-3
    with torch.no_grad():
        fresh, _ = model(torch.from_numpy(seg1["tokens"]))
        zeros, _ = model(torch.from_numpy(seg1["tokens"]),
                         model.initial_mems(B, "cpu"), 0)
    torch.testing.assert_close(fresh, zeros, rtol=0, atol=0)


def test_rel_shift_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(txl._rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_txl._rel_shift(x)))


@pytest.mark.parametrize("name", list(CFGS))
def test_round_trips_through_convert_transformer_xl(name):
    cfg = CFGS[name]
    back = convert_transformer_xl(sd_numpy(_port(name)), cfg["n_layers"], 128)
    assert_round_trip(back, _vars(name))


def test_bf16_logits_are_fp32_on_the_tied_table():
    """The tied logits are an fp32 product of the bf16-rounded operands plus
    the softmax bias."""
    model = _port("mem 5").to(torch.bfloat16).float()
    model.dtype = torch.bfloat16
    for m in model.modules():
        for attr in ("dtype", "compute_dtype"):
            if getattr(m, attr, None) is not None:
                setattr(m, attr, torch.bfloat16)
    seg = _segments()[0]
    hidden = []
    model.layers[-1].register_forward_hook(lambda m, i, o: hidden.append(o))
    with torch.no_grad():
        logits, mems = model(torch.from_numpy(seg["tokens"]))
    assert logits.dtype == torch.float32 and mems[0].dtype == torch.bfloat16
    want = hidden[0].float() @ model.table.bfloat16().float().t() \
        + model.crit.out_layers_biases[0]
    torch.testing.assert_close(logits, want, rtol=0, atol=0)


# -- the command -------------------------------------------------------------------


@pytest.fixture
def small_txl(monkeypatch):
    """The command's model at the small widths of ``CFGS["mem 8"]`` (a
    vocab of 100: the synthetic tokens are drawn below it)."""
    cfg_cls = txl.TransformerXLConfig
    monkeypatch.setattr(txl, "TransformerXLConfig",
                        lambda: cfg_cls(**CFGS["mem 8"]))
    task_cls = txl.TransformerXLTask
    monkeypatch.setattr(txl, "TransformerXLTask", lambda dtype: task_cls(
        cfg_cls(**CFGS["mem 8"]), dtype))


def test_cli_trains_transformer_xl_on_the_cpu(tmp_path, small_txl):
    """bf16, 8 steps over 4 batches cycled at ``--lr 1e-2``: finite and
    falling; the memories travel in the state, full after the second step,
    and the checkpoint keeps them; ``--resume`` restores them."""
    args = ["transformer-xl", "--batch-size", "2", "--steps-per-epoch", "4",
            "--epochs", "2", "--lr", "1e-2", "--device", "cpu",
            "--workspace", str(tmp_path)]
    state, _ = cli(args)
    assert state.step == 8 and state.model.dtype == torch.bfloat16
    assert int(state.model_state["mem_valid"]) == 8
    assert len(state.model_state["mems"]) == 2
    assert state.model_state["mems"][0].shape == (2, 8, 16)
    losses = raport_losses(tmp_path / "transformer_xl_raport.json")
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    ckpt = CheckpointManager(str(tmp_path / "transformer_xl_ckpt"))
    saved = torch.load(ckpt._path(ckpt.latest_step()))["model_state"]
    for a, b in zip(saved["mems"], state.model_state["mems"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    resumed, _ = cli(args[:5] + ["--epochs", "3"] + args[7:] + ["--resume",
                                                                "true"])
    assert resumed.step == 12


def test_cli_transformer_xl_batches_and_rate_are_jaxs(tmp_path, small_txl,
                                                      monkeypatch):
    """The synthetic batches of JAX's ``_breadth_spec`` (the same numpy
    draws: tokens below the vocab, targets shifted by one) and ``cfg.lr or
    2.5e-4``: without ``--lr`` CommonConfig's 0.1."""
    jax_task = jax_txl.TransformerXLTask
    monkeypatch.setattr(jax_txl, "TransformerXLTask", lambda dtype: jax_task(
        jax_txl.TransformerXLConfig(**CFGS["mem 8"]), dtype))
    _, _, jax_batch, _ = jax_cli._breadth_spec(
        "transformer-xl", jax_cli.CommonConfig(batch_size=2))
    _, _, port_batch, _ = cli_main._breadth_spec(
        "transformer-xl", cli_main.CommonConfig(batch_size=2, device="cpu"))
    for _ in range(2):
        want, got = jax_batch(), port_batch()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rates = []
    orig = opt.adam
    monkeypatch.setattr(opt, "adam", lambda lr, *a, **k: rates.append(lr)
                        or orig(lr, *a, **k))
    cli(["transformer-xl", "--batch-size", "2", "--steps-per-epoch", "1",
         "--device", "cpu", "--workspace", str(tmp_path)])
    assert rates == [0.1]


@pytest.mark.parametrize("command", ["transformer-xl", "nnunet", "moflow"])
def test_cli_takes_a_mesh(tmp_path, command):
    """``--mesh-data`` is ported (``test_torch_parallel_families.py`` runs
    it on two ranks): two data ranks in one process are JAX's mesh error."""
    with pytest.raises(ValueError, match="!= 1 devices"):
        cli([command, "--mesh-data", "2", "--device", "cpu", "--workspace",
             str(tmp_path)])


@pytest.mark.parametrize("command", ["maskrcnn", "se3-transformer"])
def test_cli_last_two_commands_train_and_take_a_mesh(tmp_path, command):
    """The last two commands are ported: each trains a step, and takes the
    mesh flags (two data ranks in one process are JAX's mesh error)."""
    size = ["--image-size", "64"] if command == "maskrcnn" else []
    state = cli([command, *size, "--batch-size", "1", "--steps-per-epoch",
                 "1", "--lr", "1e-3", "--device", "cpu", "--workspace",
                 str(tmp_path)])[0]
    assert state.step == 1
    with pytest.raises(ValueError, match="!= 1 devices"):
        cli([command, "--mesh-data", "2", "--device", "cpu", "--workspace",
             str(tmp_path)])


def test_cli_runs_29_of_jaxs_31_commands():
    """All 31 of JAX's commands now."""
    assert set(cli_main.MODELS) == set(jax_cli.MODELS)
    assert len(cli_main.MODELS) == 31
