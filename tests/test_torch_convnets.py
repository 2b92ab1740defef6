"""Port parity: ConvNets training in torch against the JAX package.

Small archs as ``tests/test_resnet.py`` builds them (layers (1, 1, 1, 1),
widths 8, 32x32 images, 10 classes), a grouped (ResNeXt) and an SE variant
of it, and a two-stage EfficientNet. Weights are drawn in numpy for the JAX
model's shapes, every BN scale, bias and running statistic too, so that no
branch sits at its zero init, and are carried over with the port's bridge,
which also carries JAX's gradients and batch statistics across. The port runs in
fp32 with TF32 off.

The forward, BN statistics, loss and gradient cases hold the port to the
JAX model evaluated in float64 (its pool and ``fc`` stay fp32, as JAX
writes them). JAX's own fp32 forward is not exact enough to be the
reference at 1e-5: flax takes the batch variance as E[x^2] - E[x]^2, and in
the ResNeXt training forward below that alone puts JAX's fp32 logits about
1e-5 of the largest logit away from its float64 ones, several times further
than the port's fp32 logits. QAT's logits are held to float64 JAX too, its
gradients to JAX in fp32 (the int8 grid's ties are fp32's). The SGD curve
and the schedules run JAX in fp32 at "highest". Tolerances: logits and loss within 1e-5 of the largest
entry, each gradient within 1e-4 of its largest entry, BN running
statistics within 1e-5 relative, the 3-step SGD curve within 1e-4.
"""

import dataclasses
import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from deeplearningexamples_tpu.core import losses as jax_losses
from deeplearningexamples_tpu.core import optimizers as jax_opt
from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.data.synthetic import (
    SyntheticImageLoader as JaxImageLoader,
)
from deeplearningexamples_tpu.models.convnets import (
    ClassificationTask as JaxTask,
    EfficientNet as JaxEfficientNet,
    ResNet as JaxResNet,
    resnet50 as jax_resnet50,
)
from deeplearningexamples_tpu.models.convnets.efficientnet import (
    EffNetArch as JaxEffNetArch,
)
from deeplearningexamples_tpu.models.convnets.resnet import (
    ResNetArch as JaxResNetArch,
)
from deeplearningexamples_tpu.utils.torch_import import (
    convert_efficientnet,
    convert_resnet50,
)
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import losses, optimizers as opt
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from deeplearningexamples_tpu_torch.data.synthetic import SyntheticImageLoader
from deeplearningexamples_tpu_torch.models.convnets import (
    ARCHS,
    EFFNET_ARCHS,
    ClassificationTask,
    EffNetArch,
    EfficientNet,
    ResNet,
    ResNetArch,
    build_model,
)
from deeplearningexamples_tpu_torch.models.convnets.layers import (
    MOMENTUM,
    BatchNorm2d,
)
from deeplearningexamples_tpu_torch.ops import (
    embedding as emb,
    flash_attention as fa,
    quantization as quant,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    efficientnet_state_dict_from_jax,
    resnet_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

B, R, C = 4, 32, 10
RTOL = 1e-5  # logits and loss, relative to the largest entry
GTOL = 1e-4  # each gradient, relative to its largest entry
STOL = 1e-5  # BN running statistics, relative to each tensor's largest entry
CTOL = 1e-4  # the 3-step loss curve, relative

SMALL = dict(layers=(1, 1, 1, 1), widths=(8, 8, 8, 8))
RESNETS = {
    "resnet": {},
    "resnext": dict(cardinality=4, base_width=32),  # 16 channels, 4 groups
    "se-resnext": dict(cardinality=4, base_width=32, use_se=True, se_squeeze=4),
}
# two stages: expand 1 without a residual, then expand 6 with one (SE both)
EFFNET = dict(kernels=(3, 5), widths=(16, 24), depths=(1, 2), strides=(1, 2),
              expands=(1, 6), resolution=R, survival_prob=1.0, dropout=0.0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _draw(shapes, seed: int, redraw: bool):
    """Variables of the JAX model's shapes, drawn in numpy: conv kernels
    normal with flax's ``variance_scaling(2.0, "fan_out")`` std, dense
    kernels with std 1 / sqrt(in), biases 0. With ``redraw`` every BN scale,
    bias and running statistic is drawn too; without, they take JAX's
    initial values (scale 1, 0 on each bottleneck's ``bn3``; bias and mean
    0; variance 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [p.key for p in path]
        kind, name, shape = names[0], names[-1], x.shape
        if name == "kernel" and len(shape) == 4:
            out = rng.normal(0.0, np.sqrt(2.0 / (shape[0] * shape[1] * shape[3])),
                             shape)
        elif name == "kernel":
            out = rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape)
        elif not redraw or kind == "params" and len(names) > 2 \
                and names[-2] in ("squeeze", "expand", "fc") and name == "bias":
            out = {"scale": 0.0 if names[-2] == "bn3" else 1.0,
                   "var": 1.0}.get(name, 0.0) * np.ones(shape)
        elif name == "scale":
            out = rng.normal(1.0, 0.3, shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, shape)
        else:  # BN bias, running mean
            out = rng.normal(0.0, 0.1, shape)
        return jnp.asarray(out, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(seed: int, b: int = B, r: int = R) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, r, r, 3)).astype(np.float32)


def _labels(seed: int, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, C, b).astype(np.int32)


def _jax_model(kind: str, quantized: bool = False, dtype=jnp.float32):
    if kind == "effnet":
        return JaxEfficientNet(JaxEffNetArch(**EFFNET), C, dtype,
                               quantized=quantized)
    return JaxResNet(JaxResNetArch(**SMALL, **RESNETS[kind]), C, dtype,
                     quantized=quantized)


@functools.lru_cache(maxsize=None)
def _jax_variables(kind: str, quantized: bool, redraw: bool):
    jm = _jax_model(kind, quantized)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((2, R, R, 3)), train=False))
    return _draw(shapes, 1, redraw)


def _pair(kind: str, quantized: bool = False, redraw: bool = True):
    """(JAX model in fp32, its variables, port model with the same
    weights); ``redraw=False`` keeps JAX's initial BN values."""
    if kind == "effnet":
        pm = EfficientNet(EffNetArch(**EFFNET), C, torch.float32,
                          quantized=quantized)
    else:
        pm = ResNet(ResNetArch(**SMALL, **RESNETS[kind]), C, torch.float32,
                    quantized=quantized)
    v = _jax_variables(kind, quantized, redraw)
    _load(pm, _bridge(kind)(v["params"], v["batch_stats"]))
    return _jax_model(kind, quantized), v, pm


@functools.lru_cache(maxsize=None)
def _apply64(kind: str, seed: int, b: int):
    """The JAX model's eval and training forwards in float64 on
    ``_images(seed, b)``, in one jitted call: (eval logits, training
    logits, the training forward's new batch statistics)."""
    v = _jax_variables(kind, False, True)
    x = _images(seed, b).astype(np.float64)
    with jax.enable_x64(True):
        jm = _jax_model(kind, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

        def both(v, x):
            train, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
            return jm.apply(v, x, train=False), train, mut

        return jax.tree_util.tree_map(np.asarray, _jit(both)(v64, x))


def _load(model, sd) -> None:
    model.load_state_dict({k: torch.from_numpy(np.asarray(a))
                           for k, a in sd.items()}, strict=True)


def _bridge(kind: str):
    return efficientnet_state_dict_from_jax if kind == "effnet" \
        else resnet_state_dict_from_jax


def _jit(f, disable: str = ""):
    """``jax.jit`` with XLA's quick CPU code generation: these functions run
    once, so compiling dominates. ``disable``: HLO passes to leave out."""
    return jax.jit(f, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        **({"xla_disable_hlo_passes": disable} if disable else {})})


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(autouse=True)
def _exact_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


# -- forward, BN statistics, loss and gradients ------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", list(RESNETS) + ["effnet"])
def test_forward_matches_jax(kind, train):
    """Logits of an eval (running statistics) and a train (batch
    statistics) forward, within 1e-5 of the largest logit."""
    _, _, pm = _pair(kind)
    x = _images(2)
    want = _apply64(kind, 2, B)[1 if train else 0]
    pm.train(train)
    with torch.no_grad():
        got = pm(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (B, C)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("kind", ["resnet", "effnet"])
def test_bn_running_statistics_match_flax(kind):
    """One training forward at B=2, every BN's running mean and variance.
    In the ResNet the last stage sees 1x1 maps, so a channel's batch holds
    2 values: flax updates the running variance with the biased batch
    variance, and torch's ``nn.BatchNorm2d`` rule (the unbiased one, here
    2x larger) misses by far more than the limit."""
    _, v, pm = _pair(kind)
    x = _images(3, b=2)
    mut = _apply64(kind, 3, 2)[2]
    want = _bridge(kind)(v["params"], mut["batch_stats"])
    pm.train()
    with torch.no_grad():
        pm(_nchw(x))
    got = pm.state_dict()
    stats = [k for k in want if "running" in k]
    assert stats and max(_rel(got[k], want[k]) for k in stats) <= STOL

    def unbiased(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, True, 1 - MOMENTUM,
                            self.eps)

    if kind != "resnet":
        return
    _, _, pm2 = _pair(kind)
    pm2.train()
    orig = BatchNorm2d.forward
    BatchNorm2d.forward = unbiased
    try:
        with torch.no_grad():
            pm2(_nchw(x))
    finally:
        BatchNorm2d.forward = orig
    got2 = pm2.state_dict()
    assert max(_rel(got2[k], want[k]) for k in stats if "var" in k) > 1e-2


def _jax_loss_and_grads(jm, v, batch, smoothing):
    """JAX ``ClassificationTask``'s loss and gradients (jitted)."""
    task = JaxTask(jm, label_smoothing=smoothing, num_classes=C)

    def f(params, stats, batch):
        return task.loss_fn(params, {"batch_stats": stats}, batch,
                            jax.random.key(0))

    (loss, _), grads = _jit(jax.value_and_grad(f, has_aux=True))(
        v["params"], v["batch_stats"], batch)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("kind", ["resnet", "se-resnext", "effnet"])
def test_loss_and_gradients_match_jax(kind):
    """Label-smoothed CE (0.1) of a training forward and every gradient,
    through the port's ``ClassificationTask.loss_fn`` (SE-ResNeXt holds the
    grouped convolutions and SE)."""
    _, v, pm = _pair(kind)
    batch = {"image": _images(4), "label": _labels(5)}
    with jax.enable_x64(True):
        want_loss, grads = _jax_loss_and_grads(
            _jax_model(kind, dtype=jnp.float64),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v),
            {"image": batch["image"].astype(np.float64),
             "label": batch["label"]}, 0.1)
    want = _bridge(kind)(grads)
    task = ClassificationTask("resnet50", torch.float32, label_smoothing=0.1,
                              num_classes=C)
    pm.train()
    loss, (ms, metrics) = task.loss_fn(
        pm, task.model_state(pm), {k: torch.from_numpy(x) for k, x in
                                   batch.items()}, torch.Generator())
    loss.backward()
    assert abs(float(loss) - want_loss) <= RTOL * abs(want_loss)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    _check_grads(got, want)


def _check_grads(got, want, coarse=()) -> None:
    """Each gradient within 1e-4 of its largest entry; those named in
    ``coarse`` within 1e-4 of the model's largest entry. A tensor whose JAX
    gradient is 0 but for float64 rounding (EfficientNet's last ``proj.bn``
    bias: the head's training-mode BN removes any per-channel shift) is
    held to fp32 noise instead: within 1e-6 of the largest gradient
    entry of the model."""
    scale = max(float(np.abs(w).max()) for w in want.values())
    worst, noise = [], []
    for n, w in want.items():
        if np.abs(w).max() <= 1e-12 * scale:
            noise.append((float(got[n].abs().max()) / scale, n))
        elif n in coarse:
            worst.append((float(np.abs(got[n].numpy() - w).max()) / scale, n))
        else:
            worst.append((_rel(got[n], w), n))
    assert max(worst)[0] <= GTOL, max(worst)
    assert not noise or max(noise)[0] <= 1e-6, max(noise)


@pytest.mark.parametrize("kind", ["resnet", "resnext", "effnet"])
def test_qat_forward_and_gradients_match_jax(kind):
    """QAT fake-quant on every convolution (grouped in ResNeXt, depthwise in
    EfficientNet): the same parameters as fp32. The logits are held to the
    JAX model in float64 like the fp32 cases, the gradients to JAX in fp32:
    the straight-through clip passes half the gradient where a value lands
    on the int8 bound (each channel's absmax does), and whether ``absmax /
    (absmax / 127)`` lands there exactly is fp32's rounding, which float64
    does not share (conv1's gradient is 3e-2 apart between the two). A
    tensor whose fp32 JAX gradient is itself more than 1e-4 of its largest
    entry from JAX's float64 one (conv1 for that reason; EfficientNet's
    ``proj.bn`` biases, which feed a training-mode BN that removes any shift
    but for the next layer's int8 rounding, so their gradients are 3e-4 to
    6e-4 of the largest entry and lose 2e-4 to 3e-4 of their own in fp32)
    is held to 1e-4 of the model's largest entry. JAX is jitted without
    XLA's algebraic simplifier, which turns ``w / scale`` into ``w * (1 /
    scale)`` and so puts about 0.7% of a kernel's entries one int8 step
    from JAX's op-by-op result (as written, and the port's)."""
    jm, v, pm = _pair(kind, quantized=True)
    x, y = _images(6), _labels(7)

    def grads(jm, v, x):
        def f(params):
            logits, _ = jm.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, x,
                                 train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), logits
        (_, logits), g = _jit(jax.value_and_grad(f, has_aux=True),
                              "algsimp")(v["params"])
        return np.asarray(logits), _bridge(kind)(
            jax.tree_util.tree_map(np.asarray, g))

    _, want = grads(jm, v, x)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        want_logits, want64 = grads(
            _jax_model(kind, quantized=True, dtype=jnp.float64), v64,
            x.astype(np.float64))
    coarse = [n for n in want if _rel(want[n], want64[n]) > GTOL]
    assert len(coarse) <= 3, coarse
    pm.train()
    logits = pm(_nchw(x))
    assert _rel(logits.detach(), want_logits) <= RTOL
    F.cross_entropy(pm(_nchw(x)), torch.from_numpy(_labels(7)).long()).backward()
    _check_grads({n: p.grad for n, p in pm.named_parameters()}, want, coarse)
    # an fp32 model's weights load into the QAT model as they are
    assert set(build_model("resnet50", quantized=True).state_dict()) == \
        set(build_model("resnet50").state_dict())


def test_stochastic_depth_keeps_each_sample_at_its_survival_rate():
    """A residual MBConv block keeps a sample's branch with probability p
    and scales it by 1 / p; the training forward's survival decays linearly
    over the blocks as JAX's."""
    arch = EffNetArch(**{**EFFNET, "survival_prob": 0.8, "dropout": 0.3})
    model = EfficientNet(arch, C, torch.float32)
    model.init_weights_(torch.Generator().manual_seed(0))
    blocks = [b for stage in model.layers for b in stage.values()]
    n = len(blocks)
    assert [b.survival_prob for b in blocks] == pytest.approx(
        [1.0 - 0.2 * i / (n - 1) for i in range(n)])
    blk = blocks[-1]
    assert blk.drops and blk.survival_prob == pytest.approx(0.8)
    n = 2000
    x = torch.randn(n, 24, 4, 4, generator=torch.Generator().manual_seed(1))
    blk.train()
    with torch.no_grad():
        full = blk(x)  # no draws: the branch always kept, unscaled
        u = torch.rand(n, generator=torch.Generator().manual_seed(2))
        out = blk(x, u)
    branch = full - x
    kept = (out - x).flatten(1).abs().amax(1) > 0
    rate = float(kept.float().mean())
    assert abs(rate - 0.8) < 4 * math.sqrt(0.8 * 0.2 / n)
    torch.testing.assert_close((out - x)[kept], branch[kept] / 0.8,
                               rtol=1e-5, atol=1e-6)
    # a training forward draws once per dropping block and for the dropout
    model.train()
    draws = model._draws(torch.Generator().manual_seed(3), 2, 1280,
                         torch.device("cpu"))
    assert sum(d is not None for d in draws) == sum(b.drops for b in blocks) + 1
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(2, 3, R, R))
    model.eval()
    assert all(d is None for d in model._draws(None, 2, 1280,
                                               torch.device("cpu")))


# -- optimizer, schedules, losses ---------------------------------------------


@pytest.mark.parametrize("nesterov", [False, True], ids=["momentum", "nesterov"])
def test_sgd_loss_curve_matches_jax(nesterov):
    """3 steps from JAX's initial weights (zero scales on each block's last
    BN) of SGD with momentum 0.875, weight decay 3.0517578125e-05 off the
    1-D tensors, label smoothing 0.1 and the cosine policy with one warmup
    epoch (2 steps an epoch, 3 epochs), JAX in fp32 at "highest": the losses
    within 1e-4 relative; the weights after the first step (-lr * g, g with
    decay) within 1e-4 of each tensor's largest entry. At these widths and
    rates (gradient norm about 20) later steps magnify fp32's rounding, so
    the weights are compared after the first step only."""
    jm, v, pm = _pair("resnext", redraw=False)
    spe, wd, mom = 2, 3.0517578125e-05, 0.875
    jsched = jax_opt.lr_cosine_policy(0.1, 1, 3, spe)
    jtx = jax_opt.sgd(jsched, mom, wd, nesterov=nesterov,
                      params_for_mask=v["params"])
    jtask = JaxTask(jm, label_smoothing=0.1, num_classes=C)
    jstate = jax_create_train_state(v["params"], jtx, jax.random.key(1),
                                    {"batch_stats": v["batch_stats"]})
    jstep = jax_make_train_step(jtask.loss_fn, jtx, donate=False)
    task = ClassificationTask("resnet50", torch.float32, label_smoothing=0.1,
                              num_classes=C)
    params = dict(pm.named_parameters())
    tx = opt.sgd(opt.lr_cosine_policy(0.1, 1, 3, spe), mom, wd,
                 nesterov=nesterov, mask=opt.no_decay_mask(params))
    state = create_train_state(pm, tx, 1, params=params,
                               model_state=task.model_state(pm))
    step = make_train_step(task.loss_fn, tx)
    want, got = [], []
    for i in range(3):
        b = {"image": _images(10 + i), "label": _labels(20 + i)}
        jstate, m = jstep(jstate, b)
        want.append(float(m["loss"]))
        state, m = step(state, {k: torch.from_numpy(x) for k, x in b.items()})
        got.append(float(m["loss"]))
        if i == 0:
            first = resnet_state_dict_from_jax(
                jstate.params, jstate.model_state["batch_stats"])
            sd = pm.state_dict()
            worst = max((_rel(sd[k], first[k]), k) for k in first)
            assert worst[0] <= GTOL, worst
    assert np.allclose(got, want, rtol=CTOL, atol=0), (got, want)
    assert len(set(got)) == 3  # the steps moved the weights


POLICIES = {
    "step": (lambda m: m.lr_step_policy(0.1, [1, 3], 0.1, 1, 4)),
    "linear": (lambda m: m.lr_linear_policy(0.1, 1, 5, 4)),
    "cosine": (lambda m: m.lr_cosine_policy(0.1, 1, 5, 4)),
    "exponential": (lambda m: m.lr_exponential_policy(0.1, 1, 5, 4)),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_lr_policies_match_jax(policy):
    """Each policy at steps 0-19 (4 steps an epoch, one warmup epoch), in
    fp32 on both sides: within 1e-6 relative."""
    want = POLICIES[policy](jax_opt)
    got = POLICIES[policy](opt)
    w = [float(want(jnp.int32(s))) for s in range(20)]
    g = [got(s) for s in range(20)]
    assert np.allclose(g, w, rtol=1e-6, atol=0), (g, w)
    assert len(set(np.round(g, 8))) > 3  # the policy moves


def test_no_decay_mask_and_momentum_free_sgd_stays_optax_sgd():
    params = {"conv1.weight": torch.ones(2, 2, 1, 1), "bn1.weight": torch.ones(2),
              "fc.bias": torch.ones(2), "x.LayerNorm.w": torch.ones(2, 2),
              "emb.embedding_table": torch.ones(3, 2)}
    assert opt.no_decay_mask(params) == {
        "conv1.weight": True, "bn1.weight": False, "fc.bias": False,
        "x.LayerNorm.w": False, "emb.embedding_table": False}
    tx = opt.sgd(0.5)
    state = tx.init(params)
    assert state == 0  # optax.sgd's state: the count alone
    upd, state = tx.update({"a": torch.full((2,), 2.0)}, state)
    assert state == 1 and torch.equal(upd["a"], torch.full((2,), -1.0))


def test_smoothed_cross_entropy_matches_jax_and_not_torch_label_smoothing():
    """``1 - s`` on the target and ``s / (C - 1)`` elsewhere, for integer
    and soft labels; ``F.cross_entropy(label_smoothing=s)`` (``s / C`` on
    every class) gives another value."""
    logits = np.random.default_rng(8).normal(size=(6, C)).astype(np.float32) * 3
    labels = _labels(9, 6)
    soft = np.random.default_rng(10).dirichlet(np.ones(C), 6).astype(np.float32)
    for lab in (labels, soft):
        want = float(jax_losses.smoothed_cross_entropy(logits, lab, 0.1))
        got = float(losses.smoothed_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(lab), 0.1))
        assert abs(got - want) <= 1e-6 * abs(want)
        want_ce = float(jax_losses.cross_entropy(logits, lab))
        got_ce = float(losses.cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(lab)))
        assert abs(got_ce - want_ce) <= 1e-6 * abs(want_ce)
    torch_ls = float(F.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels).long(),
                                     label_smoothing=0.1))
    ours = float(losses.smoothed_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), 0.1))
    assert abs(torch_ls - ours) > 1e-3


def test_mixup_matches_jax_at_a_fixed_lambda_and_draws_beta():
    """JAX's mixup with its Beta draw replaced by the lambda the port draws
    from the same generator state: equal bits. The draws follow Beta(a, a):
    repeatable, mean 1/2, U-shaped."""
    x = _images(11)
    y = np.eye(C, dtype=np.float32)[_labels(12)]
    seed = int(torch.randint(0, 2**62, (1,),
                             generator=torch.Generator().manual_seed(5)))
    lam = jnp.float32(np.random.default_rng(seed).beta(0.2, 0.2))
    jx = lam * x + (1.0 - lam) * x[::-1]
    jy = lam * y + (1.0 - lam) * y[::-1]
    gx, gy = losses.mixup(torch.Generator().manual_seed(5), 0.2,
                          torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))
    lams = []
    g = torch.Generator().manual_seed(6)
    for _ in range(400):
        _, yy = losses.mixup(g, 0.2, torch.zeros(2, 1), torch.eye(2))
        lams.append(float(yy[0, 0]))
    assert abs(np.mean(lams) - 0.5) < 0.06  # Beta(a, a) has mean 1/2
    assert np.mean(np.abs(np.array(lams) - 0.5) > 0.4) > 0.4  # U-shaped


def test_top_k_accuracy_matches_jax():
    logits = np.random.default_rng(13).normal(size=(64, C)).astype(np.float32)
    logits[0, :] = 1.0  # ties: JAX's reversed stable argsort picks
    labels = np.random.default_rng(14).integers(0, C, 64).astype(np.int32)
    want = jax_losses.top_k_accuracy(logits, labels)
    got = losses.top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    one_hot = np.eye(C, dtype=np.float32)[labels]
    assert float(losses.top_k_accuracy(torch.from_numpy(logits),
                                       torch.from_numpy(one_hot))["top5"]) \
        == float(want["top5"])


# -- full width, loader, weights ----------------------------------------------


def test_full_width_resnet50_weights_round_trip_through_convert_resnet50():
    """On the meta device, shapes and names only: the port's ResNet-50
    ``state_dict`` goes through JAX's ``convert_resnet50`` (the reference's
    names) and back through the bridge unchanged, and matches the shapes of
    JAX's own ResNet-50; it holds 25,557,032 parameters, as the
    reference's."""
    with torch.device("meta"):
        model = build_model("resnet50")
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    sd = {k: np.lib.stride_tricks.as_strided(np.zeros((), np.float32),
                                             tuple(t.shape), (0,) * t.dim())
          for k, t in model.state_dict().items()}
    params, stats = convert_resnet50(sd)
    shapes = jax.eval_shape(lambda: jax_resnet50().init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    leaf = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert leaf(params) == leaf(shapes["params"])
    assert leaf(stats) == leaf(shapes["batch_stats"])
    back = resnet_state_dict_from_jax(params, stats)
    assert {k: a.shape for k, a in back.items()} == \
        {k: tuple(t.shape) for k, t in model.state_dict().items()}


def test_efficientnet_b0_weights_round_trip_through_convert_efficientnet():
    with torch.device("meta"):
        model = build_model("efficientnet-b0")
    arch = EFFNET_ARCHS["efficientnet-b0"]
    sd = {k: np.zeros(tuple(t.shape), np.float32)
          for k, t in model.state_dict().items()}
    params, stats = convert_efficientnet(
        sd, [arch.scaled_depth(d) for d in arch.depths], list(arch.expands))
    back = efficientnet_state_dict_from_jax(params, stats)
    assert {k: a.shape for k, a in back.items()} == \
        {k: tuple(t.shape) for k, t in model.state_dict().items()}
    shapes = jax.eval_shape(lambda: JaxEfficientNet(JaxEffNetArch()).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    leaf = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert leaf(params) == leaf(shapes["params"])


def test_efficientnet_b4_state_dict_matches_jax_shapes():
    """EfficientNet-B4's width (1.4) and depth (1.8) scaling: JAX's
    variables at 380 x 380, through the bridge, have the port's names and
    shapes (``chip_smoke.py`` drives B0's path on the card, not B4's)."""
    from deeplearningexamples_tpu.models.convnets import (
        EFFNET_ARCHS as JAX_EFFNET_ARCHS,
    )

    with torch.device("meta"):
        model = build_model("efficientnet-b4")
    shapes = jax.eval_shape(lambda: JaxEfficientNet(
        JAX_EFFNET_ARCHS["efficientnet-b4"]).init(
        jax.random.key(0), jnp.zeros((1, 380, 380, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes)
    got = efficientnet_state_dict_from_jax(zeros["params"],
                                           zeros["batch_stats"])
    assert {k: a.shape for k, a in got.items()} == \
        {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert EFFNET_ARCHS["efficientnet-b4"].resolution == 380


@pytest.mark.parametrize("one_hot", [False, True])
def test_synthetic_image_loader_matches_jax(one_hot):
    want = next(iter(JaxImageLoader(3, 16, C, steps=1, one_hot=one_hot, seed=4)))
    loader = SyntheticImageLoader(3, 16, C, steps=2, one_hot=one_hot, seed=4)
    got = list(loader)
    assert len(loader) == 2 and len(got) == 2
    for k in ("image", "label"):
        assert got[0][k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[0][k], want[k])
    x = torch.from_numpy(got[0]["image"]).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)


def test_activations_stay_channels_last():
    """The batch's NCHW view is channels_last in memory, and so is every
    stage's output, the one the pool reads included; the weights too."""
    model = ResNet(ResNetArch(**SMALL, **RESNETS["se-resnext"]), C,
                   torch.bfloat16)
    model.init_weights_(torch.Generator().manual_seed(0))
    x = _nchw(_images(15))
    feats = model(x, return_features=True)
    assert all(f.is_contiguous(memory_format=torch.channels_last)
               and f.dtype == torch.bfloat16 for f in feats)
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for n, p in model.named_parameters() if p.dim() == 4)
    assert model(x).dtype == torch.float32


def test_unknown_arch_is_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        build_model("vgg16")


# -- the CLI and checkpoints ---------------------------------------------------


def _raport(path: Path) -> list[dict]:
    return [json.loads(line[len("DLLL "):]) for line in path.read_text().splitlines()
            if line.startswith("DLLL ")]


@pytest.fixture
def tiny_archs(monkeypatch):
    """The CLI's archs at a test size: ResNet-50 and ResNeXt101 with widths
    8 (224x224 images), EfficientNet-B0 cut to two stages at 32x32."""
    monkeypatch.setitem(ARCHS, "resnet50",
                        dataclasses.replace(ARCHS["resnet50"], **SMALL))
    monkeypatch.setitem(ARCHS, "resnext101-32x4d", dataclasses.replace(
        ARCHS["resnext101-32x4d"], **SMALL, **RESNETS["resnext"]))
    monkeypatch.setitem(EFFNET_ARCHS, "efficientnet-b0", dataclasses.replace(
        EFFNET_ARCHS["efficientnet-b0"], **{**EFFNET, "survival_prob": 0.8,
                                            "dropout": 0.2}))


@pytest.mark.parametrize("arch,extra", [
    ("resnet50", ["--label-smoothing", "0.1", "--weight-decay", "3e-5",
                  "--mixup", "0.2", "--warmup-epochs", "1"]),
    ("resnet50", ["--quant-policy", "qat"]),
    ("resnext101-32x4d", ["--quant-policy", "qat"]),
    ("efficientnet-b0", ["--ema", "0.9999", "--amp", "false"]),
    ("efficientnet-b0", ["--quant-policy", "qat"]),
])
def test_cli_trains_convnets_on_the_cpu(tmp_path, tiny_archs, arch, extra):
    before = (fa.launches, emb.launches, quant.launches)
    state, best = cli([arch, "--device", "cpu", "--batch-size", "2",
                       "--steps-per-epoch", "3", "--workspace", str(tmp_path),
                       *extra])
    assert (fa.launches, emb.launches, quant.launches) == before
    assert state.step == 3
    assert (state.ema_params is not None) == ("--ema" in extra)
    rows = _raport(tmp_path / f"{arch}_raport.json")
    loss = [r["data"]["train.loss"] for r in rows if "train.loss" in r.get("data", {})]
    val = [r["data"] for r in rows if "val.top1" in r.get("data", {})]
    assert len(loss) == 3 and all(math.isfinite(x) for x in loss)
    assert abs(loss[0] - math.log(1000)) < 1.5
    assert len(val) == 1 and {"val.top1", "val.top5", "val.val_loss"} <= set(val[0])
    assert best == val[0]["val.top1"]
    assert (tmp_path / f"{arch}_ckpt" / "ckpt_3.pt").exists()


@pytest.mark.parametrize("flag,value", [("--mesh-model", "2")])
def test_cli_refuses_unported_flags(tmp_path, flag, value):
    # --mesh-* is ported: a mesh of 2 ranks in one process is JAX's error
    with pytest.raises(ValueError, match="1 devices"):
        cli(["resnet50", "--device", "cpu", flag, value, "--workspace",
             str(tmp_path)])


def test_checkpoint_restores_weights_and_bn_statistics(tmp_path):
    """Two steps, save; a model from another seed restored from the file
    has the same weights and BN buffers, and its eval gives the same
    top1, top5 and ``val_loss``."""
    task = ClassificationTask("resnet50", torch.float32, label_smoothing=0.1,
                              num_classes=C)
    arch = ResNetArch(**SMALL)

    def fresh(seed):
        model = ResNet(arch, C, torch.float32)
        model.init_weights_(torch.Generator().manual_seed(seed))
        params = dict(model.named_parameters())
        tx = opt.sgd(0.1, 0.9, 1e-4, mask=opt.no_decay_mask(params))
        return create_train_state(model, tx, 1, params=params,
                                  model_state=task.model_state(model)), tx

    state, tx = fresh(0)
    step = make_train_step(task.loss_fn, tx)
    batch = {"image": torch.from_numpy(_images(16)),
             "label": torch.from_numpy(_labels(17))}
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(int(state.step), state)
    other, _ = fresh(1)
    restored = ckpt.restore(other)
    assert restored.step == 2
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert any("running_var" in k and not torch.equal(a[k], torch.ones_like(a[k]))
               for k in a)  # the statistics moved and came back
    evaluate = make_eval_step(task.metric_fn)
    m1 = evaluate(state.model, state.model_state, batch)
    m2 = evaluate(restored.model, restored.model_state, batch)
    assert state.model.training and restored.model.training
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    # one more step from each gives the same loss: the optimizer state too
    _, l1 = step(state, batch)
    _, l2 = step(restored, batch)
    assert float(l1["loss"]) == float(l2["loss"])
