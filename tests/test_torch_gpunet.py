"""Port parity: GPUNet-0, -1 and -2 against the JAX package.

The three archs at full width on 64 x 64 images (the last stage sees 2 x 2
maps), 10 classes, B=2. Weights are drawn in numpy for the JAX model's
shapes, every BN scale, bias and running statistic too, and carried over
with ``gpunet_state_dict_from_jax``, which also carries JAX's gradients and
batch statistics across. Both sides run in fp32 (TF32 off; JAX at
"highest", one jitted function an arch with XLA's quick CPU code
generation): XLA's float64 convolutions on the CPU take 17 s for one
GPUNet-0 step at 32 x 32, too long for these tests. The dropout before
``fc`` takes the port's draws: ``jax.random.bernoulli`` is replaced, inside
the test, by the comparison of the port's uniforms with the keep
probability, which is what it computes from its own.

Tolerances. Eval mode (BN on its running statistics), where fp32 is well
conditioned: logits and loss within 1e-5 of the largest entry, each
gradient within 1e-4 of its own largest entry and 1e-5 of the largest of
all (readings 5e-7; 4.3e-6 and 6.0e-7). Training mode: the gradient through
the batch statistics of 2 x 2 maps at B=2 cancels most of dy, stage after
stage, as ResNet-50's does (``chip_smoke.py`` phase 19), and two fp32
computations in another order (JAX's, and the port's on one thread or
several) part by up to 3.5e-2 of a tensor's own largest entry and 7.5e-3 of
the largest of all (the eval-mode gradients of the same weights agree to
4e-6): phase 19's rule and limits, each error over its tensor's largest
entry or 1e-3 of the largest of all where that is more, 1e-1, and over the
largest of all, 1e-2; a block's last BN bias, whose gradient is 0 but for
rounding, only against the largest of all. JAX's training-mode gradients
are compiled for GPUNet-0 only (15-25 s an arch on the CPU); the eval-mode ones of all
three hold the backward. Training logits and loss within 2e-4 of the
largest (7.6e-5, 1.4e-5), the running statistics within 1e-4 of each
tensor's largest entry (6.8e-5). The QAT
forward, on a narrow arch with every kind of layer (at full width fp32's
order flips entries of the int8 grid), within 1e-4 of the largest logit,
JAX jitted without XLA's algebraic simplifier as the ConvNets' QAT cases.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from deeplearningexamples_tpu.models.convnets import ClassificationTask as JaxTask
from deeplearningexamples_tpu.models.convnets.gpunet import (
    GPUNET_ARCHS as JAX_ARCHS,
    GPUNet as JaxGPUNet,
)
from deeplearningexamples_tpu_torch.cli.main import (
    ConvNetCliConfig,
    build_convnet,
    cli,
)
from deeplearningexamples_tpu_torch.models.convnets import (
    GPUNET_ARCHS,
    ClassificationTask,
    GPUNet,
    build_model,
)
from deeplearningexamples_tpu_torch.models.convnets.gpunet import HEAD, same_pad
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    gpunet_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

B, R, C = 2, 64, 10
RTOL, STOL, QTOL, FLOOR = 1e-5, 1e-4, 1e-4, 1e-3
# (logits of the largest, each gradient of its own largest entry, of the
# largest entry of all)
TOL = {"eval": (1e-5, 1e-4, 1e-5), "train": (2e-4, 1e-1, 1e-2)}
ARCH_NAMES = list(GPUNET_ARCHS)
TRAIN_GRADS = ("gpunet-0",)  # the archs whose training-mode grads are held


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jit(f, disable: str = ""):
    return jax.jit(f, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        **({"xla_disable_hlo_passes": disable} if disable else {})})


@functools.lru_cache(maxsize=None)
def _variables(name: str):
    """numpy variables of JAX's model: convs normal with the fan-out std,
    dense kernels 1 / sqrt(in), BN scales 1 + 0.3 N, biases and means 0.1 N,
    variances U(0.5, 1.5)."""
    jm = JaxGPUNet(JAX_ARCHS[name], C, jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((B, R, R, 3)), train=False))
    rng = np.random.default_rng(ARCH_NAMES.index(name))

    def leaf(path, x):
        names = [p.key for p in path]
        name, shape = names[-1], x.shape
        if name == "kernel" and len(shape) == 4:
            return rng.normal(0, np.sqrt(2 / (shape[0] * shape[1] * shape[3])),
                              shape)
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(shape[0]), shape)
        if name == "scale":
            return rng.normal(1.0, 0.3, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0.0, 0.1, shape)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(name: str):
    rng = np.random.default_rng(10 + ARCH_NAMES.index(name))
    x = rng.normal(size=(B, R, R, 3)).astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    u = torch.rand(B, HEAD, generator=torch.Generator().manual_seed(7))
    return x, y, u


def _port_draws_for_jax(u: torch.Tensor):
    """``jax.random.bernoulli`` as the port draws: its uniforms below p."""
    def bernoulli(key, p, shape):
        return jnp.asarray(u.numpy()).reshape(shape) < p
    return bernoulli


@functools.lru_cache(maxsize=None)
def _jax32(name: str):
    """JAX in fp32 at "highest", in one jitted call: the eval and the
    training forward's logits, the training forward's new batch statistics,
    then {mode: (loss, grads)}: ``ClassificationTask.loss_fn``'s
    label-smoothed CE (0.1) in training mode, plain CE in eval mode (BN on
    its running statistics, no dropout)."""
    v = _variables(name)
    x, y, u = _inputs(name)
    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _port_draws_for_jax(u))
        jm = JaxGPUNet(JAX_ARCHS[name], C, jnp.float32)
        task = JaxTask(jm, label_smoothing=0.1, num_classes=C)

        def f(v, x):
            ev = jm.apply(v, x, train=False)
            tr, mut = jm.apply(v, x, train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.key(0)})

            def train_loss(params):
                return task.loss_fn(params, {"batch_stats": v["batch_stats"]},
                                    {"image": x, "label": y},
                                    jax.random.key(0))[0]

            def eval_loss(params):
                logits = jm.apply({"params": params,
                                   "batch_stats": v["batch_stats"]}, x,
                                  train=False)
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean()

            # training-mode gradients of one arch only: compiling JAX's
            # takes 15-25 s an arch on the CPU (the eval-mode ones hold the
            # backward)
            train = (jax.value_and_grad(train_loss)(v["params"])
                     if name in TRAIN_GRADS else (train_loss(v["params"]), {}))
            return ev, tr, mut["batch_stats"], {
                "train": train,
                "eval": jax.value_and_grad(eval_loss)(v["params"])}

        out = _jit(f)(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), v), x)
        return jax.tree_util.tree_map(np.asarray, out)


def _port(name: str, quantized: bool = False) -> GPUNet:
    v = _variables(name)
    pm = GPUNet(GPUNET_ARCHS[name], C, torch.float32, quantized=quantized)
    sd = gpunet_state_dict_from_jax(v["params"], v["batch_stats"])
    pm.load_state_dict({k: torch.from_numpy(np.asarray(a, np.float32))
                        for k, a in sd.items()}, strict=True)
    return pm


@pytest.fixture(autouse=True)
def _exact_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_matches_jax(name, train):
    """Logits of an eval (running statistics) and a training forward
    (batch statistics, dropout on the same draws), and the BN running
    statistics after the training forward."""
    pm = _port(name)
    x, _, u = _inputs(name)
    pm.train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2), u=u if train else None)
    ev, tr, stats, _ = _jax32(name)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    assert _rel(got, tr if train else ev) <= TOL[("train" if train else "eval")][0]
    if not train:
        return
    want = gpunet_state_dict_from_jax({}, stats)
    sd = pm.state_dict()
    assert want and max(_rel(sd[k], w) for k, w in want.items()) <= STOL
    # the training loss (label-smoothed CE 0.1) of every arch
    task = ClassificationTask(name, torch.float32, label_smoothing=0.1,
                              num_classes=C)
    with torch.no_grad():
        loss, _ = task.loss_fn(_port(name).train(), {}, {
            "image": torch.from_numpy(x),
            "label": torch.from_numpy(_inputs(name)[1])},
            torch.Generator().manual_seed(7))
    want_loss = float(_jax32(name)[3]["train"][0])
    assert abs(loss.item() - want_loss) <= TOL["train"][0] * abs(want_loss)


def _shift_invariant(pm: GPUNet, name: str) -> bool:
    """A BN bias whose training-mode gradient is 0 but for rounding: a
    block's last BN (``bn3`` of an IRB, ``bn2`` of a fused IRB) feeds only
    convolutions followed by training-mode BN, which remove any per-channel
    shift."""
    if not name.startswith("layers.") or not name.endswith(".bias"):
        return False
    kind = pm.layers[int(name.split(".")[1])].layer.kind
    return name.endswith({"irb": ".bn3.bias", "fused_irb": ".bn2.bias"}.get(
        kind, "-"))


@pytest.mark.parametrize("name,mode", [(n, "eval") for n in ARCH_NAMES]
                         + [(n, "train") for n in TRAIN_GRADS])
def test_loss_and_gradients_match_jax(name, mode):
    """Training mode: ``ClassificationTask.loss_fn``'s label-smoothed CE
    (0.1), dropout on the same draws; eval mode: plain CE with BN on its
    running statistics. Every gradient, each against its own largest entry
    and against the largest entry of all."""
    pm = _port(name)
    x, y, _ = _inputs(name)
    want_loss, grads = _jax32(name)[3][mode]
    want = gpunet_state_dict_from_jax(grads)
    if mode == "train":
        task = ClassificationTask(name, torch.float32, label_smoothing=0.1,
                                  num_classes=C)
        pm.train()
        gen = torch.Generator().manual_seed(7)  # draws _inputs' u
        loss, _ = task.loss_fn(pm, task.model_state(pm),
                               {"image": torch.from_numpy(x),
                                "label": torch.from_numpy(y)}, gen)
    else:
        pm.eval()
        loss = F.cross_entropy(pm(torch.from_numpy(x).permute(0, 3, 1, 2)),
                               torch.from_numpy(y).long())
    loss.backward()
    own_tol, all_tol = TOL[mode][1:]
    assert abs(loss.item() - float(want_loss)) <= \
        TOL[mode][0] * abs(float(want_loss))
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    # of its own largest entry, or of FLOOR times the largest of all where
    # that is more (phase 19's rule)
    own = [(float((got[n].double() - torch.from_numpy(w).double()).abs().max())
            / max(float(np.abs(w).max()), FLOOR * top), n)
           for n, w in want.items()
           if mode == "eval" or not _shift_invariant(pm, n)]
    of_all = [(float((got[n].double() - torch.from_numpy(w).double()).abs()
                     .max()) / top, n) for n, w in want.items()]
    assert max(own)[0] <= own_tol, max(own)
    assert max(of_all)[0] <= all_tol, max(of_all)


# every kind of layer, narrow: at full width some of the int8 grid's entries
# land on a rounding edge in one package and not the other (fp32's order),
# and the flips add up over the layers to 2e-3 - 4e-3 of the largest logit
QAT_ARCH = (32, 8, (("conv", 8), ("fused_irb", 8, 1, 2, 3, "relu"),
                    ("fused_irb", 16, 2, 3, 5, "swish", True),
                    ("irb", 16, 1, 2, 3, "swish", True),
                    ("irb", 24, 2, 2, 5, "relu")))


def test_qat_forward_matches_jax():
    """int8 fake-quant on every convolution (dense, depthwise, and the fused
    IRB's "SAME"-padded one), eval mode, on a narrow arch with every kind
    of layer; the full archs' QAT models take the fp32 models' parameters
    as they are."""
    from deeplearningexamples_tpu.models.convnets.gpunet import (
        GPUNetArch as JaxArch,
        Layer as JaxLayer,
    )
    from deeplearningexamples_tpu_torch.models.convnets.gpunet import (
        GPUNetArch,
        Layer,
    )

    res, stem, layers = QAT_ARCH
    jm = JaxGPUNet(JaxArch(res, stem, tuple(JaxLayer(*l) for l in layers)), C,
                   jnp.float32, quantized=True)
    x = np.random.default_rng(3).normal(size=(B, res, res, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, train=False))
    rng = np.random.default_rng(4)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key in
                      ("scale", "var") else rng.normal(0, 0.3, a.shape)
                      ).astype(np.float32), shapes)
    want = _jit(lambda v, x: jm.apply(v, x, train=False), "algsimp")(v, x)
    pm = GPUNet(GPUNetArch(res, stem, tuple(Layer(*l) for l in layers)), C,
                torch.float32, quantized=True)
    pm.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                        gpunet_state_dict_from_jax(v["params"],
                                                   v["batch_stats"]).items()})
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(got, want) <= QTOL
    for name in ARCH_NAMES:
        assert set(build_model(name, quantized=True).state_dict()) == \
            set(build_model(name).state_dict())


@pytest.mark.parametrize("n,k,s", [(9, 3, 2), (8, 3, 2), (8, 5, 2), (7, 3, 1)])
def test_same_pad_is_flax_same(n, k, s):
    """The fused IRB's expansion pads as flax's "SAME": ceil(n / s) outputs,
    the odd step after."""
    x = np.random.default_rng(0).normal(size=(1, n, n, 2)).astype(np.float32)
    kern = np.random.default_rng(1).normal(size=(k, k, 2, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, kern, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision="highest")
    got = torch.nn.functional.conv2d(
        same_pad(torch.from_numpy(x).permute(0, 3, 1, 2), k, s),
        torch.from_numpy(kern).permute(3, 2, 0, 1), stride=s)
    assert got.shape[2:] == (math.ceil(n / s),) * 2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,extra", [("gpunet-0", []),
                                        ("gpunet-1", ["--quant-policy", "qat"])])
def test_cli_trains_gpunet_on_the_cpu(tmp_path, monkeypatch, name, extra):
    """Two steps at B=2 on synthetic images, then the 10-batch eval, at 64
    x 64 (the arch's own resolution is what the loaders are built at)."""
    want = {"gpunet-0": 320, "gpunet-1": 288, "gpunet-2": 384}
    for arch, res in want.items():
        run = build_convnet(arch, ConvNetCliConfig(batch_size=1, device="cpu"))
        assert next(iter(run.loader))["image"].shape == (1, res, res, 3)
    monkeypatch.setitem(GPUNET_ARCHS, name, dataclasses.replace(
        GPUNET_ARCHS[name], resolution=R))
    state, best = cli([name, "--device", "cpu", "--batch-size", "2",
                       "--steps-per-epoch", "2", "--workspace", str(tmp_path),
                       *extra])
    assert state.step == 2 and 0.0 <= best <= 1.0
    assert isinstance(state.model, GPUNet)
    assert state.model.layers[0].conv.__class__.__name__ == (
        "QATConv" if extra else "Conv2d")
