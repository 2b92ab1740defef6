"""Port parity: nnU-Net's ``DynUNet`` (2-D and 3-D, deep supervision), its
losses and dice metric, the BraTS ``BratsUNet3D`` and the ``nnunet``
command, in torch against the JAX package.

The models run at small widths: ``DynUNet`` with 4-12 filters, depth 3 over
16 x 16 images (2-D) and depth 2 over 8^3 volumes (3-D), 3 classes, B=2;
``BratsUNet3D`` keeps its fixed filters (64, 128, 256, 512) at three and
four levels over one 8^3 volume of 2 channels. The JAX side is fp32 at
"highest" precision, jitted once per function; the port is fp32 on one
thread. ``BratsUNet3D`` runs in float64 on both sides (JAX under
``jax.enable_x64``; its output convolutions stay fp32 there). Its instance
norms still take the variance in fp32 on both sides, as JAX's model does,
and the two sides' roundings of it (about 1e-7) grow level by level through
norms over as few as 8 voxels: the logits are held to 1e-4 of their
largest entry (6.3e-5 read), the test's loss to 1e-4 relative (2.1e-5
read) and the gradients to 5e-5 of the largest of
all (1.3e-5 read); at 16^3 the readings are no smaller. JAX's parameters are drawn in numpy for its own shapes and carried
into the port by the bridge (JAX's transposed-convolution kernels reversed
in space), which also carries JAX's gradients across. The port is
channels-first: images and logits are moved from and to JAX's channels-last
layout.

Tolerances, relative to the largest entry of the JAX tensor: forwards
1e-5; losses 1e-5 relative; every gradient within 1e-3 of its own largest
entry and 1e-5 of the largest entry of all; the dice metric 1e-6; the
round trip through ``convert_brats_unet3d`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.models import unet as jax_unet
from deeplearningexamples_tpu.utils.torch_import import convert_brats_unet3d
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.models import unet
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    brats_unet3d_state_dict_from_jax,
    dynunet_state_dict_from_jax,
)
from torch_parity import (assert_round_trip, draw, grads, jit, load,
                          raport_losses, rel, sd_numpy, tb, worst)
from torch_threads import torch_one_thread  # noqa: F401

FTOL = 1e-5
LTOL = 1e-5
GTOL = (1e-3, 1e-5)
# BratsUNet3D (see the module's docstring): the instance norms' fp32
# variances, amplified through the levels
BRATS_FTOL = 1e-4
BRATS_GTOL = {"3 levels": (1e-3, 5e-5), "4 levels": (1e-1, 5e-3)}
B = 2

CFGS = {
    "2d": dict(spatial_rank=2, in_channels=1, n_classes=3, base_filters=4,
               depth=3, max_filters=12, deep_supervision=True),
    "3d": dict(spatial_rank=3, in_channels=2, n_classes=3, base_filters=4,
               depth=2, max_filters=8, deep_supervision=False),
}
SIZE = {"2d": 16, "3d": 8}


@pytest.fixture(autouse=True)
def _exact_fp32():
    with jax.default_matmul_precision("highest"):
        yield


def _nchw(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -1, 1)


@functools.lru_cache(maxsize=None)
def _vars(name: str):
    task = jax_unet.UNetTask(jax_unet.UNetConfig(**CFGS[name]), jnp.float32)
    size = SIZE[name]
    c = CFGS[name]["in_channels"]
    shape = (B,) + (size,) * CFGS[name]["spatial_rank"] + (c,)
    # init in training so that the deep-supervision heads exist
    shapes = jax.eval_shape(lambda: task.model.init(
        jax.random.key(0), jnp.zeros(shape), train=True))["params"]
    return draw(shapes, 1)


@functools.lru_cache(maxsize=None)
def _batch(name: str) -> dict:
    rng, cfg, size = np.random.default_rng(2), CFGS[name], SIZE[name]
    spatial = (size,) * cfg["spatial_rank"]
    return {"image": rng.normal(size=(B, *spatial, cfg["in_channels"])
                                ).astype(np.float32),
            "label": rng.integers(0, cfg["n_classes"], (B, *spatial)
                                  ).astype(np.int32)}


def _port(name: str, train: bool = True) -> unet.DynUNet:
    model = load(unet.DynUNet(unet.UNetConfig(**CFGS[name]), torch.float32),
                 dynunet_state_dict_from_jax(_vars(name)))
    return model.train(train)


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    """JAX's eval forward, training forward (logits and heads), loss with
    gradients and dice metric on ``_batch(name)``."""
    task = jax_unet.UNetTask(jax_unet.UNetConfig(**CFGS[name]), jnp.float32)
    b = _batch(name)

    def run(params):
        v = {"params": params}
        ev = task.model.apply(v, b["image"])
        tr = task.model.apply(v, b["image"], train=True)
        (loss, _), g = jax.value_and_grad(
            lambda p: task.loss_fn(p, {}, b, jax.random.key(0)),
            has_aux=True)(params)
        return ev, tr, loss, g, task.metric_fn(params, {}, b)

    return jax.tree_util.tree_map(np.asarray, jit(run)(_vars(name)))


@pytest.mark.parametrize("name", list(CFGS))
def test_dynunet_forward_matches_jax(name):
    ev, tr, _, _, _ = _jax(name)
    x = torch.from_numpy(_nchw(_batch(name)["image"]))
    with torch.no_grad():
        got_ev = _port(name, train=False)(x)
        got_tr = _port(name, train=True)(x)
    assert got_ev.dtype == torch.float32
    assert rel(got_ev.numpy(), _nchw(ev)) < FTOL
    if CFGS[name]["deep_supervision"]:
        logits, heads = got_tr
        want_logits, want_heads = tr
        assert len(heads) == len(want_heads) == 2
        for h, w in zip(heads, want_heads):
            assert h.shape == _nchw(w).shape
            assert rel(h.numpy(), _nchw(w)) < FTOL
    else:
        logits, want_logits = got_tr, tr
    assert rel(logits.numpy(), _nchw(want_logits)) < FTOL


@pytest.mark.parametrize("name", list(CFGS))
def test_dynunet_loss_and_gradients_match_jax(name):
    _, _, loss, g, _ = _jax(name)
    model = _port(name)
    task = unet.UNetTask(unet.UNetConfig(**CFGS[name]), torch.float32)
    got, _ = task.loss_fn(model, {}, tb(_batch(name)), torch.Generator())
    got.backward()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    want = dynunet_state_dict_from_jax(g)
    # the heads of the deep supervision never reach JAX's loss (their sizes
    # miss its labels' at the decoder's order): zero gradients both sides
    heads = {n for n in want if n.startswith("ds_head")}
    for n in heads:
        assert not np.any(want[n]) and model.get_parameter(n).grad is None
    own, top = worst({n: v for n, v in _grads_or_zero(model).items()
                      if n not in heads},
                     {n: v for n, v in want.items() if n not in heads})
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top


def _grads_or_zero(model) -> dict:
    return {n: (p.grad.numpy() if p.grad is not None
                else np.zeros(tuple(p.shape), np.float32))
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", list(CFGS))
def test_dynunet_dice_metric_matches_jax(name):
    *_, metric = _jax(name)
    task = unet.UNetTask(unet.UNetConfig(**CFGS[name]), torch.float32)
    got = task.metric_fn(_port(name), {}, tb(_batch(name)))
    assert abs(float(got["dice"]) - float(metric["dice"])) < 1e-6


def test_stride_two_convolution_pads_as_flax_same():
    """An even input under stride 2 pads (0, 1), not (1, 1): the first
    down block's output against JAX's, and against a symmetric pad (which
    must miss)."""
    name = "2d"
    model = _port(name, train=False)
    x = torch.from_numpy(_nchw(_batch(name)["image"]))
    down = model.down_0.conv0
    y = model.input_block(x)
    got = down(y)
    sym = torch.nn.functional.conv2d(y, down.weight, None, 2, 1)
    params = _vars(name)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(np.moveaxis(y.detach().numpy(), 1, -1)),
        params["down_0"]["conv0"]["kernel"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert rel(got.detach().numpy(), _nchw(want)) < FTOL
    assert rel(sym.detach().numpy(), _nchw(want)) > 1e-2


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = (2 * rng.normal(size=(2, 6, 5, 4))).astype(np.float32)
    labels = rng.integers(0, 4, (2, 6, 5)).astype(np.int32)
    t_logits = torch.from_numpy(_nchw(logits).copy()).requires_grad_()
    for jfn, fn in ((jax_unet.dice_loss, unet.dice_loss),
                    (jax_unet.focal_loss, unet.focal_loss)):
        want, want_g = jax.value_and_grad(jfn)(logits, labels)
        t_logits.grad = None
        got = fn(t_logits, torch.from_numpy(labels))
        got.backward()
        assert abs(got.item() - float(want)) < LTOL * abs(float(want))
        assert rel(t_logits.grad.numpy(), _nchw(want_g)) < FTOL
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    got = torch.nn.functional.cross_entropy(torch.from_numpy(
        _nchw(logits).copy()), torch.from_numpy(labels).long())
    assert abs(got.item() - float(ce)) < LTOL * float(ce)


# -- the BraTS UNet3D ------------------------------------------------------------

BRATS = {"3 levels": ((3, 3, 3), (1, 2, 2)),
         "4 levels": ((3, 3, 3, 3), (1, 2, 2, 2))}
BRATS_SIZE = 8


@functools.lru_cache(maxsize=None)
def _brats_x() -> np.ndarray:
    return np.random.default_rng(4).normal(size=(1,) + (BRATS_SIZE,) * 3
                                            + (2,)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brats_jax(name: str):
    """JAX's variables (fp32, drawn in numpy), the heads' weights of the
    test's loss, and in float64: the eval forward, the training heads, the
    loss and its gradients."""
    kernels, strides = BRATS[name]
    x = _brats_x()
    params = draw(jax.eval_shape(lambda: jax_unet.BratsUNet3D(
        kernels=kernels, strides=strides, in_channels=2, n_classes=3).init(
            jax.random.key(0), x, train=True))["params"], 5)
    w = [np.random.default_rng(6 + i).normal(
        size=(1,) + (BRATS_SIZE // 2 ** i,) * 3 + (3,))
        for i in range(3)]
    with jax.enable_x64(True):
        model = jax_unet.BratsUNet3D(kernels=kernels, strides=strides,
                                     in_channels=2, n_classes=3,
                                     dtype=jnp.float64)
        x64 = x.astype(np.float64)

        def loss(p):
            heads = model.apply({"params": p}, x64, train=True)
            return sum(jnp.mean(h * w[i]) for i, h in enumerate(heads))

        def run(p):
            value, g = jax.value_and_grad(loss)(p)
            return (model.apply({"params": p}, x64),
                    model.apply({"params": p}, x64, train=True), value, g)

        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)
        out = jax.tree_util.tree_map(np.asarray, jit(run)(p64))
    return params, w, out


def _brats_port(name: str, dtype=torch.float32):
    kernels, strides = BRATS[name]
    params, _, _ = _brats_jax(name)
    model = unet.BratsUNet3D(kernels, strides, in_channels=2, n_classes=3,
                             dtype=dtype)
    return load(model, brats_unet3d_state_dict_from_jax(params)).to(dtype)


@pytest.mark.parametrize("name", list(BRATS))
def test_brats_unet3d_forward_loss_and_gradients_match_jax(name):
    _, w, (ev, heads, loss, g) = _brats_jax(name)
    model = _brats_port(name, torch.float64)
    x = torch.from_numpy(_nchw(_brats_x()).astype(np.float64))
    with torch.no_grad():
        got_ev = model.eval()(x)
    assert rel(got_ev.numpy(), _nchw(ev)) < BRATS_FTOL
    got = model.train()(x)
    assert len(got) == len(heads) == len(BRATS[name][0]) - 1
    for h, want in zip(got, heads):
        assert rel(h.detach().numpy(), _nchw(want)) < BRATS_FTOL
    value = sum((h * torch.from_numpy(_nchw(w[i]))).mean()
                for i, h in enumerate(got))
    value.backward()
    assert abs(value.item() - float(loss)) < BRATS_FTOL * abs(float(loss))
    # at four levels the bottleneck runs on one voxel, which the first up
    # block's instance norm sees as a constant volume and removes: its
    # gradients are 0 but for rounding (1e-16), held to the largest of all
    noise = {n for n, _ in model.named_parameters()
             if n.startswith("bottleneck.") and name == "4 levels"}
    own, top = worst(grads(model), brats_unet3d_state_dict_from_jax(g), noise)
    assert own[0] < BRATS_GTOL[name][0], own
    assert top[0] < BRATS_GTOL[name][1], top


@pytest.mark.parametrize("name", list(BRATS))
def test_brats_unet3d_round_trips_through_convert_brats_unet3d(name):
    params, _, _ = _brats_jax(name)
    back = convert_brats_unet3d(sd_numpy(_brats_port(name)),
                                len(BRATS[name][0]))
    assert_round_trip(back, params)


def test_upsample_align_corners_matches_jaxs():
    """Separable linear upsampling on torch's align_corners grid, an axis
    of one repeated."""
    x = np.random.default_rng(7).normal(size=(2, 3, 1, 5, 4)).astype(
        np.float32)
    want = jax_unet._upsample_align_corners(jnp.asarray(x))
    got = unet._upsample_align_corners(torch.from_numpy(_nchw(x).copy()))
    assert got.shape == _nchw(want).shape
    assert rel(got.numpy(), _nchw(want)) < FTOL


# -- the command -------------------------------------------------------------------

CLI_KW = dict(base_filters=4, depth=2, max_filters=8)


@pytest.fixture
def small_unet(monkeypatch):
    """The command's UNet at 4-8 filters and depth 2 (its 128 x 128 images,
    3 classes)."""
    cfg_cls = unet.UNetConfig
    monkeypatch.setattr(unet, "UNetConfig",
                        lambda **kw: cfg_cls(**{**kw, **CLI_KW}))


def test_cli_trains_nnunet_on_the_cpu(tmp_path, small_unet):
    """bf16, 6 steps over 3 batches cycled at ``--lr 1e-2``: finite and
    falling; a checkpoint."""
    state, _ = cli(["nnunet", "--batch-size", "2", "--steps-per-epoch", "3",
                    "--epochs", "2", "--lr", "1e-2", "--device", "cpu",
                    "--workspace", str(tmp_path)])
    assert state.step == 6 and state.model.dtype == torch.bfloat16
    losses = raport_losses(tmp_path / "nnunet_raport.json")
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert (tmp_path / "nnunet_ckpt").exists()


def test_cli_nnunet_batches_and_rate_are_jaxs(tmp_path, small_unet,
                                              monkeypatch):
    """The synthetic batches of JAX's ``_breadth_spec`` (the same numpy
    draws), ``min(steps_per_epoch, 16)`` of them cycled, and ``cfg.lr or
    1e-3``: without ``--lr`` CommonConfig's 0.1."""
    jcfg = jax_cli.CommonConfig(batch_size=2)
    pcfg = cli_main.CommonConfig(batch_size=2, device="cpu")
    _, _, jax_batch, _ = jax_cli._breadth_spec("nnunet", jcfg)
    _, _, port_batch, _ = cli_main._breadth_spec("nnunet", pcfg)
    for _ in range(2):
        want, got = jax_batch(), port_batch()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    run = cli_main.build_breadth("nnunet", cli_main.CommonConfig(
        batch_size=1, steps_per_epoch=20, device="cpu"))
    assert len(run.loader) == 20 and run.loader[16] is run.loader[0]
    rates = []
    orig = opt.adam
    monkeypatch.setattr(opt, "adam", lambda lr, *a, **k: rates.append(lr)
                        or orig(lr, *a, **k))
    cli(["nnunet", "--batch-size", "1", "--steps-per-epoch", "1", "--device",
         "cpu", "--workspace", str(tmp_path)])
    assert rates == [0.1]
