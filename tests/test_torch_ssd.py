"""Port parity: SSD300 in torch against the JAX package.

SSD300 at its full width (the anchors need 300x300 inputs), B=2 and 5
classes. JAX's variables are drawn in numpy for its own shapes: every BN
scale, bias and running statistic and every head bias too, so that no
branch sits at its zero init and the heads are not symmetric (a wrong head
channel permutation then gives the right shapes and wrong numbers); each
block's last BN scale is drawn at 0.1 N(0, 1), where JAX starts it at 0. They
are carried into the port by the bridge, which also carries JAX's gradients
and batch statistics across. The port runs in fp32.

The reference is JAX in fp32 at "highest" precision, jitted once per
function and shared by the tests. JAX's float64 convolutions on the CPU take
about 11 s per forward at this size, so the fp32 readings are held to limits
that lie above both packages' own fp32 error. Against the port's own
float64 step, the training-mode gradient through the batch statistics loses
up to about 5e-2 of a tensor's own largest entry and 5e-3 of the largest
entry of all in fp32, in either package (as ResNet-50 does, PERF.md §6);
with BN on its running statistics, 3e-4 and 2e-4. Tolerances: the eval
forward within 1e-5 of the largest output, the training forward within
1e-4; BN running statistics within 1e-5 of each tensor's largest entry; the
loss within 1e-5 relative; the training-mode gradients within 1e-1 of each
tensor's largest entry and 1e-2 of the largest of all (phase 19's limits
for ResNet-50 in ``chip_smoke.py``), with BN on its running statistics
within 1e-2 and 1e-3; the 3-step SGD curve within 1e-4 relative. The loss, boxes, loaders, NMS and mAP are held to JAX on crafted
inputs, bit for bit where both sides run the same numpy.
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

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.core import optimizers as jax_opt
from deeplearningexamples_tpu.data.ssd_synthetic import (
    SyntheticSSDLoader as JaxSSDLoader,
)
from deeplearningexamples_tpu.models.ssd import (
    SSD300 as JaxSSD300,
    SSDTask as JaxSSDTask,
    dboxes300_coco as jax_dboxes,
    decode_batch as jax_decode,
    encode as jax_encode,
    multibox_loss as jax_multibox_loss,
    nms_single as jax_nms,
)
from deeplearningexamples_tpu.models.ssd.coco_eval import CocoMAP as JaxCocoMAP
from deeplearningexamples_tpu.models.ssd.evaluate import (
    evaluate_ssd as jax_evaluate_ssd,
)
from deeplearningexamples_tpu.models.ssd.task import (
    color_twist as jax_color_twist,
)
from deeplearningexamples_tpu.utils.torch_import import convert_ssd300
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.data.ssd_synthetic import SyntheticSSDLoader
from deeplearningexamples_tpu_torch.models.convnets.layers import (
    MOMENTUM,
    BatchNorm2d,
)
from deeplearningexamples_tpu_torch.models.ssd import (
    SSD300,
    SSDTask,
    dboxes300_coco,
    decode_batch,
    encode,
    multibox_loss,
    nms_single,
)
from deeplearningexamples_tpu_torch.models.ssd.coco_eval import CocoMAP
from deeplearningexamples_tpu_torch.models.ssd.evaluate import evaluate_ssd
from deeplearningexamples_tpu_torch.models.ssd.task import (
    color_twist,
    sample_color_twist_params,
)
from deeplearningexamples_tpu_torch.ops import (
    embedding as emb,
    flash_attention as fa,
    quantization as quant,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    ssd300_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

B, C, R = 2, 5, 300
FTOL = {False: 1e-5, True: 1e-4}  # eval and training forward, of the largest
STOL = 1e-5  # BN running statistics, of each tensor's largest entry
LTOL = 1e-5  # the loss, relative
# gradients: (of each tensor's largest entry, of the largest entry of all)
GTOL = {"train": (1e-1, 1e-2), "eval": (1e-2, 1e-3)}
CTOL = 1e-4  # the 3-step loss curve, relative
# fixed color-twist parameters, inside the reference's ranges
TWIST = dict(hue_deg=[0.3, -0.4], saturation=[0.7, 1.3],
             brightness=[0.9, 1.1], contrast=[0.6, 1.4])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _worst(got: dict, want: dict) -> tuple[tuple, tuple]:
    """The worst (error, name) over each tensor's largest entry and over
    the largest entry of all."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return (max((_rel(got[n], w), n) for n, w in want.items()),
            max((float(np.abs(np.asarray(got[n], np.float64) - w).max()) / top,
                 n) for n, w in want.items()))


@pytest.fixture(autouse=True)
def _exact_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


# -- the shared JAX side -------------------------------------------------------


def _draw(shapes, seed: int):
    """Variables of the JAX model's shapes, drawn in numpy: kernels normal
    with std sqrt(2 / fan_out) in the backbone and sqrt(1 / fan_out) in the
    extra blocks and heads (flax's scales there), BN scales 1 + 0.2 N(0, 1)
    but 0.1 N(0, 1) on each block's ``bn3``, biases and running means
    0.1 N(0, 1), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [p.key for p in path]
        module, name, shape = names[-2], names[-1], x.shape
        if name == "kernel":
            gain = 2.0 if names[1] == "backbone" else 1.0
            out = rng.normal(0.0, np.sqrt(gain / (shape[0] * shape[1]
                                                  * shape[3])), shape)
        elif name == "scale":
            z = rng.normal(size=shape)
            out = 0.1 * z if module == "bn3" else 1.0 + 0.2 * z
        elif name == "var":
            out = rng.uniform(0.5, 1.5, shape)
        else:  # biases, running means
            out = rng.normal(0.0, 0.1, shape)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_model(num_classes: int = C):
    return JaxSSD300(num_classes, jnp.float32)


def _jax_shapes(num_classes: int = C):
    return jax.eval_shape(lambda: _jax_model(num_classes).init(
        jax.random.key(0), jnp.zeros((2, R, R, 3)), train=False))


@functools.lru_cache(maxsize=None)
def _jax_variables():
    return _draw(_jax_shapes(), 1)


def _port(dtype=torch.float32):
    """The port's SSD300 with JAX's variables, in training mode."""
    v = _jax_variables()
    model = SSD300(C, dtype)
    model.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                           ssd300_state_dict_from_jax(
                               v["params"], v["batch_stats"]).items()},
                          strict=True)
    return model.train()


def _twist(jax_side: bool = False) -> dict:
    t = {k: np.asarray(x, np.float32) for k, x in TWIST.items()}
    if jax_side:
        return {k: jnp.asarray(x) for k, x in t.items()}
    return {k: torch.from_numpy(x) for k, x in t.items()}


@functools.lru_cache(maxsize=None)
def _batch(seed: int) -> dict:
    """JAX's synthetic batch of seed ``seed`` (5 classes), its images
    color-twisted by JAX at ``TWIST``."""
    batch = next(iter(JaxSSDLoader(B, jax_dboxes(), num_classes=C, steps=1,
                                   seed=seed)))
    with jax.default_matmul_precision("highest"):
        image = np.asarray(jax_color_twist(jnp.asarray(batch["image"]),
                                           **_twist(jax_side=True)))
    return {**batch, "image": image}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(x) for k, x in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX's eval and training forwards on ``_batch(2)``'s images in one
    jitted call: (eval (loc, conf), training (loc, conf), the training
    forward's batch statistics)."""
    jm, v = _jax_model(), _jax_variables()

    def both(v, x):
        train, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x, train=False), train, mut

    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(both)(v, _batch(2)["image"]))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    """JAX ``SSDTask.loss_fn`` (without its jitter: the batches come
    twisted) under ``jax.value_and_grad``, jitted: (params, batch_stats,
    batch) -> ((loss, (mutated, {})), grads)."""
    task = JaxSSDTask(C, jnp.float32, color_jitter=False)

    def f(params, stats, batch):
        return task.loss_fn(params, {"batch_stats": stats}, batch,
                            jax.random.key(0))

    return jax.jit(jax.value_and_grad(f, has_aux=True))


# -- forward and BN statistics --------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(train):
    """loc and conf of an eval (running statistics) and a training (batch
    statistics) forward, each within FTOL of its largest entry."""
    pm = _port().train(train)
    want = _jax_forward()[1 if train else 0]
    with torch.no_grad():
        got = pm(torch.from_numpy(_batch(2)["image"]).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(B, 8732, 4), (B, 8732, C)]
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        assert _rel(g, w) <= FTOL[train]


def test_bn_running_statistics_match_flax():
    """One training forward, every BN's running mean and variance. The last
    extra block's maps are 1x1, so each of its channels holds B=2 values:
    torch's ``nn.BatchNorm2d`` rule (the unbiased variance, 2x the biased
    one that flax takes) misses by far more than the limit."""
    v = _jax_variables()
    want = ssd300_state_dict_from_jax(v["params"],
                                      _jax_forward()[2]["batch_stats"])
    stats = [k for k in want if "running" in k]
    x = torch.from_numpy(_batch(2)["image"]).permute(0, 3, 1, 2)
    pm = _port()
    with torch.no_grad():
        pm(x)
    got = pm.state_dict()
    assert max(_rel(got[k], want[k]) for k in stats) <= STOL

    def unbiased(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, True, 1 - MOMENTUM,
                            self.eps)

    pm2 = _port()
    orig = BatchNorm2d.forward
    BatchNorm2d.forward = unbiased
    try:
        with torch.no_grad():
            pm2(x)
    finally:
        BatchNorm2d.forward = orig
    got2 = pm2.state_dict()
    assert _rel(got2["additional_blocks.4.4.running_var"],
                want["additional_blocks.4.4.running_var"]) > 1e-2


def test_activations_stay_channels_last_and_outputs_are_fp32():
    """Under bf16 every feature map is bf16 and ``channels_last``, the
    kernels too, and the outputs are fp32."""
    model = SSDTask(C, torch.bfloat16).init(torch.Generator().manual_seed(0),
                                            "cpu")
    feats = []
    hooks = [m.register_forward_hook(lambda m, a, out: feats.append(out))
             for m in [model.feature_extractor, *model.additional_blocks]]
    with torch.no_grad():
        loc, conf = model(torch.zeros(1, R, R, 3).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    assert [f.shape[-1] for f in feats] == [38, 19, 10, 5, 3, 1]
    assert all(f.dtype == torch.bfloat16 and f.is_contiguous(
        memory_format=torch.channels_last) for f in feats)
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in model.parameters() if p.dim() == 4)
    assert loc.dtype == conf.dtype == torch.float32
    assert conf.shape == (1, 8732, C)


# -- the loss and the gradients -------------------------------------------------


def _loss_inputs():
    """(loc_pred, conf_pred, loc_target, cls_target) for 3 images of 32
    anchors. Image 0 has 2 positives, so 6 negatives are mined: the
    negatives' CE is 4 distinct large values, then 5 anchors (10-14) whose
    logits are equal, which tie, and the 6-negative boundary falls inside
    them; image 1 has no positive; image 2 has 12 positives, so 3 * 12 is
    clipped to the 32 anchors."""
    rng = np.random.default_rng(4)
    n = 32
    loc_p = rng.normal(size=(3, n, 4)).astype(np.float32)
    loc_t = rng.normal(size=(3, n, 4)).astype(np.float32)
    conf = rng.normal(0.0, 0.1, (3, n, C)).astype(np.float32)
    cls = np.zeros((3, n), np.int32)
    cls[0, [3, 20]] = [1, 4]
    for i, a in enumerate((5, 6, 7, 8)):  # the hardest negatives
        conf[0, a] = 0.0
        conf[0, a, 1 + i % 4] = 6.0 - 0.5 * i
    conf[0, 10:15] = np.array([0.0, 3.0, -1.0, 0.5, 2.0], np.float32)
    cls[2, :12] = rng.integers(1, C, 12)
    return loc_p, conf, loc_t, cls


def test_multibox_loss_matches_jax_with_ties_and_an_empty_image():
    """The loss within 1e-6 relative and its gradients to the predictions
    within 1e-6 of their largest entry. Mining picks the two tied anchors of
    lowest index (10 and 11), as JAX's stable argsort does: only they, among
    the tied ones, carry a gradient. The image without positives adds 0."""
    loc_p, conf, loc_t, cls = _loss_inputs()
    (want, (wg_loc, wg_conf)) = jax.value_and_grad(
        jax_multibox_loss, argnums=(0, 1))(loc_p, conf, loc_t, cls)
    lp = torch.from_numpy(loc_p).requires_grad_()
    cp = torch.from_numpy(conf).requires_grad_()
    got = multibox_loss(lp, cp, torch.from_numpy(loc_t), torch.from_numpy(cls))
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert _rel(lp.grad, wg_loc) <= 1e-6 and _rel(cp.grad, wg_conf) <= 1e-6
    carried = cp.grad[0].abs().sum(-1) > 0
    assert carried[10:15].tolist() == [True, True, False, False, False]
    assert int(carried.sum()) == 2 + 6
    assert float(cp.grad[1].abs().max()) == 0.0  # no positive: no gradient
    assert bool((cp.grad[2].abs().sum(-1) > 0).all())  # every anchor mined
    # the empty image weighs in the mean over B as a 0
    two = multibox_loss(lp[[0, 2]], cp[[0, 2]], torch.from_numpy(loc_t[[0, 2]]),
                        torch.from_numpy(cls[[0, 2]]))
    assert abs(float(got) * 3 - float(two) * 2) <= 1e-5 * float(got)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_loss_and_gradients_match_jax(mode):
    """One step's loss and every gradient, through the port's
    ``SSDTask.loss_fn`` (training mode, batch statistics) or the eval-mode
    forward (BN on its running statistics) and ``multibox_loss``."""
    v, batch = _jax_variables(), _batch(5)
    if mode == "train":
        (want_loss, _), grads = _jax_grad_fn()(v["params"], v["batch_stats"],
                                               batch)
    else:
        jm = _jax_model()

        def f(params):
            loc, conf = jm.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 batch["image"], train=False)
            return jax_multibox_loss(loc, conf, batch["loc_targets"],
                                     batch["cls_targets"])

        want_loss, grads = jax.jit(jax.value_and_grad(f))(v["params"])
    want = ssd300_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    pm = _port().train(mode == "train")
    task = SSDTask(C, torch.float32, color_jitter=False)
    loss, (ms, metrics) = task.loss_fn(pm, task.model_state(pm),
                                       _torch_batch(batch), torch.Generator())
    loss.backward()
    assert abs(float(loss) - float(want_loss)) <= LTOL * abs(float(want_loss))
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    own, whole = _worst(got, want)
    assert own[0] <= GTOL[mode][0] and whole[0] <= GTOL[mode][1], (own, whole)


def test_sgd_loss_curve_matches_jax_with_the_no_decay_mask():
    """3 steps of SGD (momentum 0.9, weight decay 5e-4 off the biases and
    BN, configs.yml's; the cosine policy with one warmup epoch of 2 steps,
    3 epochs), JAX's ``sgd`` with ``params_for_mask`` against the port's
    with ``no_decay_mask``: the same tensors decay, the losses within 1e-4
    relative; after the first step the momentum buffers (each gradient
    plus its decay) within the training-mode gradients' limits, the BN
    running statistics within 1e-5."""
    v = _jax_variables()
    params, stats = v["params"], v["batch_stats"]
    spe, wd, lr = 2, 5e-4, 2e-4
    jtx = jax_opt.sgd(jax_opt.lr_cosine_policy(lr, 1, 3, spe), 0.9, wd,
                      params_for_mask=params)
    jstate = jtx.init(params)
    pm = _port()
    named = dict(pm.named_parameters())
    mask = opt.no_decay_mask(named)
    jmask = ssd300_state_dict_from_jax(jax.tree_util.tree_map(
        lambda p, m: np.full(p.shape, m), params,
        jax_opt.no_decay_mask(params)))
    assert mask == {n: bool(m.all()) for n, m in jmask.items()}
    assert 0 < sum(mask.values()) < len(mask)
    tx = opt.sgd(opt.lr_cosine_policy(lr, 1, 3, spe), 0.9, wd, mask=mask)
    task = SSDTask(C, torch.float32, color_jitter=False)
    state = create_train_state(pm, tx, 1, params=named,
                               model_state=task.model_state(pm))
    step = make_train_step(task.loss_fn, tx)
    want, got = [], []
    for i in range(3):
        batch = _batch(10 + i)
        (loss, (mut, _)), g = _jax_grad_fn()(params, stats, batch)
        updates, jstate = jtx.update(g, jstate, params)
        params, stats = optax.apply_updates(params, updates), mut["batch_stats"]
        want.append(float(loss))
        state, m = step(state, _torch_batch(batch))
        got.append(float(m["loss"]))
        if i == 0:  # the momentum buffers: the gradients plus the decay
            trace = ssd300_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, jstate[1].trace))
            own, whole = _worst(state.opt_state.trace, trace)
            assert own[0] <= GTOL["train"][0] and \
                whole[0] <= GTOL["train"][1], (own, whole)
            sd, want_stats = pm.state_dict(), ssd300_state_dict_from_jax(
                params, jax.tree_util.tree_map(np.asarray, stats))
            assert max(_rel(sd[k], want_stats[k]) for k in want_stats
                       if "running" in k) <= STOL
    assert np.allclose(got, want, rtol=CTOL, atol=0), (got, want)
    assert len(set(got)) == 3  # the steps moved the weights


# -- boxes, loader, decode, NMS, mAP --------------------------------------------


def test_dboxes_and_encode_match_jax_bitwise():
    want, got = jax_dboxes(), dboxes300_coco()
    assert got.num_boxes == 8732
    for k in ("ltrb", "xywh"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    rng = np.random.default_rng(6)
    lt = rng.uniform(0.0, 0.7, (5, 2))
    gt = np.concatenate([lt, lt + rng.uniform(0.05, 0.3, (5, 2))],
                        1).astype(np.float32)
    labels = rng.integers(1, 81, 5)
    for g, lab in ((gt, labels), (gt[:0], labels[:0])):
        for a, b in zip(encode(got, g, lab), jax_encode(want, g, lab)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_synthetic_ssd_loader_matches_jax_bitwise():
    want = next(iter(JaxSSDLoader(3, jax_dboxes(), num_classes=C, steps=1,
                                  seed=7)))
    loader = SyntheticSSDLoader(3, dboxes300_coco(), num_classes=C, steps=2,
                                seed=7)
    got = list(loader)
    assert len(loader) == 2 and len(got) == 2
    assert set(got[0]) == set(want) == {"image", "loc_targets", "cls_targets"}
    for k in want:
        assert got[0][k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[0][k], want[k])
    assert (got[0]["cls_targets"] > 0).sum(1).min() >= 6  # each box matched


def test_decode_batch_matches_jax_and_inverts_encode():
    """Decoded boxes in fp32 within 1e-6 of the same arithmetic in float64,
    as JAX's are (so the two agree within 2e-6); decoding the encoded
    targets gives the ground-truth boxes back at the matched anchors."""
    db = dboxes300_coco()
    loc = np.random.default_rng(8).normal(size=(2, 8732, 4)).astype(np.float32)
    got = decode_batch(db, torch.from_numpy(loc))
    assert got.dtype == torch.float32 and got.shape == (2, 8732, 4)
    exact = decode_batch(db, torch.from_numpy(loc).double()).numpy()
    errors = {"port": float(np.abs(got.numpy() - exact).max()),
              "jax": float(np.abs(np.asarray(jax_decode(db, loc)) - exact).max())}
    assert max(errors.values()) <= 1e-6, errors
    gt = np.array([[0.1, 0.1, 0.4, 0.5], [0.5, 0.55, 0.9, 0.95]], np.float32)
    t, cls = encode(db, gt, np.array([3, 7]))
    back = decode_batch(db, torch.from_numpy(t)[None])[0].numpy()
    for g, lab in zip(gt, (3, 7)):
        assert np.abs(back[cls == lab] - g).max(1).min() < 1e-5


def _detections():
    """Crafted per-image (boxes, probs) over 3 classes and ground truth:
    overlapping boxes of one class (suppressed), a class below the score
    threshold, and near misses at several IoUs."""
    rng = np.random.default_rng(9)
    images = []
    for _ in range(4):
        gt = np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.8],
                       [0.2, 0.6, 0.45, 0.95]], np.float32)
        gl = np.array([1, 2, 1], np.int32)
        jitter = rng.normal(0.0, 0.04, (12, 4)).astype(np.float32)
        boxes = np.concatenate([gt, gt, gt, gt]) + jitter
        probs = rng.dirichlet(np.ones(4), 12).astype(np.float32)
        probs[:3, 0] = 0.0  # sharp detections of the first copy
        probs[:3, 1:] = np.eye(3, dtype=np.float32)[gl - 1] * 0.9
        probs[:, 3] = np.minimum(probs[:, 3], 0.04)  # under the threshold
        images.append((boxes, probs, gt, gl))
    return images


def test_nms_and_coco_map_match_jax():
    """``nms_single`` keeps the same boxes, labels and scores as JAX's, and
    ``CocoMAP`` over them gives JAX's mAP and mAP50 exactly (the same numpy
    on both sides); an image without detections and an empty scorer too."""
    ours, theirs = CocoMAP(), JaxCocoMAP()
    for boxes, probs, gt, gl in _detections():
        got, want = nms_single(boxes, probs), jax_nms(boxes, probs)
        assert 0 < len(got[0]) < len(boxes)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert 3 not in got[1]
        ours.add_image(*got, gt, gl)
        theirs.add_image(*want, gt, gl)
    empty = nms_single(np.zeros((4, 4), np.float32), np.zeros((4, 3), np.float32))
    assert [len(x) for x in empty] == [0, 0, 0]
    ours.add_image(*empty, _detections()[0][2], _detections()[0][3])
    theirs.add_image(*empty, _detections()[0][2], _detections()[0][3])
    got, want = ours.compute(), theirs.compute()
    assert got == want and 0.0 < got["mAP"] < got["mAP50"] <= 1.0
    assert CocoMAP().compute() == {"mAP": 0.0, "mAP50": 0.0}


class _GivenPredictions:
    """A stand-in task whose ``predict_fn`` returns given (B, 8732, 4)
    offsets decoded and (B, 8732, C) probabilities, whatever the images;
    ``xp`` is the package whose ``decode_batch`` it calls."""

    def __init__(self, loc, probs, xp: str):
        self.loc, self.probs, self.xp = loc, probs, xp
        self.dboxes = dboxes300_coco()

    def predict_fn(self, model, model_state, images):
        if self.xp == "jax":
            return (jax_decode(self.dboxes, jnp.asarray(self.loc)),
                    jnp.asarray(self.probs))
        return (decode_batch(self.dboxes, torch.from_numpy(self.loc)),
                torch.from_numpy(self.probs))


def test_evaluate_ssd_matches_jax_evaluate_ssd():
    """``evaluate_ssd`` on batches with ``gt``, whose predictions are each
    ground-truth box shifted by 0.02, encoded at one anchor it matches,
    with probability 1 for its class: the same mAP and mAP50 as JAX's
    ``evaluate_ssd`` on the same predictions, mAP50 1.0 and mAP below it."""
    db = dboxes300_coco()
    rng = np.random.default_rng(10)
    model = torch.nn.Linear(1, 1)
    for _ in range(2):
        gts, locs, probs = [], [], []
        for img in range(2):
            lt = rng.uniform(0.05, 0.6, (3, 2))
            g = np.concatenate([lt, lt + rng.uniform(0.15, 0.3, (3, 2))],
                               1).astype(np.float32)
            lab = rng.integers(1, C, 3).astype(np.int32)
            loc = np.zeros((8732, 4), np.float32)
            p = np.zeros((8732, C), np.float32)
            for j in range(3):
                t, cls = encode(db, g[j:j + 1] + 0.02, lab[j:j + 1])
                a = int(np.flatnonzero(cls)[0])
                assert not p[a].any()
                loc[a], p[a, lab[j]] = t[a], 1.0
            gts.append((img, g, lab))
            locs.append(loc)
            probs.append(p)
        batch = {"image": np.zeros((2, R, R, 3), np.float32), "gt": gts}
        loc, probs = np.stack(locs), np.stack(probs)
        got = evaluate_ssd(_GivenPredictions(loc, probs, "torch"), model,
                           [batch])
        want = jax_evaluate_ssd(_GivenPredictions(loc, probs, "jax"), {}, {},
                                [batch])
        assert got == pytest.approx(want, abs=1e-12), (got, want)
        assert got["mAP50"] == 1.0 and 0.0 < got["mAP"] < 1.0


# -- color twist ----------------------------------------------------------------


def test_color_twist_matches_jax_at_fixed_parameters():
    """On N(0, 1) images (the synthetic loader's), within 1e-6: the output
    lies in [0, 1]; neutral parameters leave [0, 1] images as they are."""
    x = np.random.default_rng(11).normal(size=(B, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax_color_twist(jnp.asarray(x), **_twist(True)))
    got = color_twist(torch.from_numpy(x), **_twist()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.min() == 0.0 and got.max() == 1.0
    u = np.random.default_rng(12).uniform(0.1, 0.9, (B, 8, 8, 3)).astype(np.float32)
    one, zero = torch.ones(B), torch.zeros(B)
    np.testing.assert_allclose(color_twist(torch.from_numpy(u), zero, one, one,
                                           one).numpy(), u, atol=1e-5)


def test_color_twist_draws_cover_the_reference_ranges():
    """The port draws each parameter uniform over its range from the
    step's generator: within the range, mean at its middle, repeatable."""
    g = torch.Generator().manual_seed(13)
    p = sample_color_twist_params(g, 4000)
    again = sample_color_twist_params(torch.Generator().manual_seed(13), 4000)
    for k, (lo, hi) in dict(hue_deg=(-0.5, 0.5), saturation=(0.5, 1.5),
                            brightness=(0.875, 1.125),
                            contrast=(0.5, 1.5)).items():
        x = p[k]
        assert x.shape == (4000,) and torch.equal(x, again[k])
        assert lo <= float(x.min()) and float(x.max()) <= hi
        assert abs(float(x.mean()) - (lo + hi) / 2) < 0.05 * (hi - lo)
        assert float(x.std()) == pytest.approx((hi - lo) / math.sqrt(12),
                                               rel=0.05)
    assert not torch.equal(p["saturation"], p["contrast"])


def test_loss_fn_twists_with_the_generators_draws():
    """With ``color_jitter`` (the default) the loss is the one of the images
    twisted by the parameters the step's generator draws."""
    pm = SSD300(C, torch.float32).eval()
    pm.init_weights_(torch.Generator().manual_seed(0))
    raw = next(iter(SyntheticSSDLoader(B, dboxes300_coco(), num_classes=C,
                                       steps=1, seed=14)))
    batch = _torch_batch(raw)
    task = SSDTask(C, torch.float32)
    with torch.no_grad():
        loss, _ = task.loss_fn(pm, {}, batch, torch.Generator().manual_seed(15))
        params = sample_color_twist_params(torch.Generator().manual_seed(15), B)
        twisted = {**batch, "image": color_twist(batch["image"], **params)}
        want, _ = dataclasses.replace(task, color_jitter=False).loss_fn(
            pm, {}, twisted, torch.Generator())
        plain, _ = dataclasses.replace(task, color_jitter=False).loss_fn(
            pm, {}, batch, torch.Generator())
    assert float(loss) == float(want) != float(plain)


def test_predict_fn_matches_jax_decode_and_softmax():
    """``predict_fn``'s boxes and probabilities against JAX's decode and
    softmax of its own eval forward, within 1e-5 of the largest entry; the
    model's mode is put back."""
    loc, conf = _jax_forward()[0]
    want_boxes = np.asarray(jax_decode(jax_dboxes(), jnp.asarray(loc)))
    want_probs = np.asarray(jax.nn.softmax(jnp.asarray(conf), -1))
    pm = _port()
    boxes, probs = SSDTask(C, torch.float32).predict_fn(
        pm, None, torch.from_numpy(_batch(2)["image"]))
    assert pm.training
    assert _rel(boxes, want_boxes) <= 1e-5 and _rel(probs, want_probs) <= 1e-5


# -- weights ---------------------------------------------------------------------


def test_full_width_weights_round_trip_through_convert_ssd300():
    """At 81 classes: a JAX tree with JAX's shapes and random values goes
    through the bridge into the port's model (strict names and shapes),
    then the port's ``state_dict`` through JAX's ``convert_ssd300`` (the
    reference's names and head layout) gives the same tree back, bit for
    bit."""
    shapes = _jax_shapes(81)
    tree = _draw(shapes, 16)
    model = SSD300(81, torch.float32)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           ssd300_state_dict_from_jax(
                               tree["params"], tree["batch_stats"]).items()},
                          strict=True)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    params, stats = convert_ssd300(sd, 81)
    for want, got in ((tree["params"], params), (tree["batch_stats"], stats)):
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert set(map(jax.tree_util.keystr, flat_w)) == \
            set(map(jax.tree_util.keystr, flat_g))
        by_name = {jax.tree_util.keystr(k): v for k, v in flat_g.items()}
        for k, w in flat_w.items():
            np.testing.assert_array_equal(by_name[jax.tree_util.keystr(k)], w)
    # the heads' channels are permuted: JAX's kernel read as it is differs
    for head in ("loc0", "conf5"):
        kernel = np.transpose(tree["params"][head]["kernel"], (3, 2, 0, 1))
        name = f"{head[:-1]}.{head[-1]}.weight"
        assert kernel.shape == sd[name].shape
        assert not np.array_equal(kernel, sd[name])
    assert sum(t.numel() for t in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            shapes["params"]))


# -- the CLI ---------------------------------------------------------------------


def _raport(path: Path) -> list[dict]:
    return [json.loads(line[len("DLLL "):]) for line in path.read_text().splitlines()
            if line.startswith("DLLL ")]


def test_cli_trains_ssd300_on_the_cpu_and_resumes(tmp_path):
    """2 steps at B=2 (bf16, bench.py's optimizer), then ``--resume`` for a
    second epoch of 2: every loss finite, checkpoints at steps 2 and 4, no
    kernel of the port launched."""
    before = (fa.launches, emb.launches, quant.launches)
    args = ["ssd300", "--device", "cpu", "--batch-size", "2",
            "--steps-per-epoch", "2", "--workspace", str(tmp_path),
            "--lr", "2.6e-3", "--momentum", "0.9", "--weight-decay", "0",
            "--lr-schedule", "constant"]
    loss = []
    for extra, steps in (([], 2), (["--resume", "--epochs", "2"], 4)):
        state, _ = cli([*args, *extra])
        assert state.step == steps and state.model.dtype == torch.bfloat16
        loss += [r["data"]["train.loss"] for r in
                 _raport(tmp_path / "ssd300_raport.json")
                 if "train.loss" in r.get("data", {})]
    assert (fa.launches, emb.launches, quant.launches) == before
    assert len(loss) == 4 and all(math.isfinite(x) for x in loss)
    assert {p.name for p in (tmp_path / "ssd300_ckpt").glob("ckpt_*.pt")} == \
        {"ckpt_2.pt", "ckpt_4.pt"}


@pytest.mark.parametrize("flag,value", [("--data-backend", "dali"),
                                        ("--mesh-data", "2")])
def test_cli_refuses_unported_flags(tmp_path, flag, value):
    # --mesh-* is ported: a mesh of 2 ranks in one process is JAX's error
    error, match = (ValueError, "!= 1 devices") if flag == "--mesh-data" \
        else (SystemExit, "not ported")
    with pytest.raises(error, match=match):
        cli(["ssd300", "--device", "cpu", flag, value, "--workspace",
             str(tmp_path)])


def test_cli_default_rate_is_common_configs_not_configs_yml(monkeypatch,
                                                            tmp_path):
    """ROADMAP Queue 3 quirk 8g, kept on purpose: without a config file
    ``ssd300`` inherits ``CommonConfig`` (lr 0.1, cosine, no weight decay,
    one epoch), not configs.yml's SSD300 recipe (lr 0.0052, step, 5e-4);
    and the step policy decays at epochs 30, 60 and 80, not the
    reference's 43 and 54. The port's schedules equal JAX's
    ``_make_schedule`` on both configs."""
    seen = {}
    monkeypatch.setitem(cli_main.MODELS, "ssd300",
                        lambda cfg: seen.setdefault("cfg", cfg))
    cli(["ssd300", "--workspace", str(tmp_path)])
    cfg = seen["cfg"]
    assert (cfg.lr, cfg.lr_schedule, cfg.weight_decay, cfg.epochs,
            cfg.momentum, cfg.warmup_epochs) == (0.1, "cosine", 0.0, 1, 0.9, 0)
    jcfg = jax_cli.CommonConfig()
    assert (jcfg.lr, jcfg.lr_schedule, jcfg.weight_decay, jcfg.epochs) == \
        (cfg.lr, cfg.lr_schedule, cfg.weight_decay, cfg.epochs)
    spe = 10
    for c, j in ((cfg, jcfg), (dataclasses.replace(
            cfg, lr=0.0052, lr_schedule="step", warmup_epochs=1, epochs=90),
            dataclasses.replace(jcfg, lr=0.0052, lr_schedule="step",
                                warmup_epochs=1, epochs=90))):
        got = cli_main._make_schedule(c, spe)
        want = jax_cli._make_schedule(j, spe)
        steps = [0, 5, 9, 10, 429, 430, 540, 299, 300, 600, 800, 899]
        assert [got(s) for s in steps] == pytest.approx(
            [float(want(jnp.int32(s))) for s in steps], rel=1e-6)
    step = cli_main._make_schedule(dataclasses.replace(
        cfg, lr=1.0, lr_schedule="step"), spe)
    assert [step(e * spe) for e in (29, 30, 43, 54, 60, 80)] == pytest.approx(
        [1.0, 0.1, 0.1, 0.1, 0.01, 0.001])  # no decay at 43 or 54
