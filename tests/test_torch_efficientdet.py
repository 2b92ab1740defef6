"""Port parity: EfficientDet-D0 and the detection ops it calls, against the
JAX package.

- ``efficientdet_anchors`` equal to JAX's at 512 (D0's 49,104 anchors) and
  128.
- ``box_iou``, ``match_proposals`` and ``batched_nms`` equal to JAX's on
  random boxes with tied IoUs and tied scores, with fewer survivors than
  ``max_out``; the port's NMS computes one IoU row a pick where JAX builds
  the N x N matrix.
- The model at D0's widths on 128 x 128 images, B=2, 90 classes, weights
  drawn in numpy for JAX's shapes and carried over with
  ``efficientdet_state_dict_from_jax``. Both sides in fp32 (TF32 off, JAX at
  "highest", jitted once with XLA's quick code generation; XLA's float64
  convolutions on the CPU are too slow for these tests). The backbone's
  stochastic depth takes the port's draws: ``jax.random.bernoulli`` is
  replaced, inside the test, by the comparison of the port's uniforms with
  the survival probability.
- Eval mode (BN on its running statistics), where fp32 is well
  conditioned: class and box outputs within 1e-5 of the largest entry, the
  loss and its focal and Huber parts within 1e-5, and every gradient as
  ``chip_smoke.py`` phase 19 holds them: each error over its tensor's
  largest entry, or 1e-3 of the largest entry of all where that is more (a
  few fusion weights have gradients of 1e-11 to 1e-9 of the largest), within
  1e-4, and over the largest of all within 1e-5 (readings 4e-5, 4e-7); a
  fusion weight below 0 (ReLU'd away) has a gradient of exactly 0 on both
  sides.
- Training mode (batch statistics, stochastic depth): the loss and its
  parts within 1e-4, the BN running statistics within 1e-4 of each tensor's
  largest entry. At 128 P7 is 1 x 1 and P6 2 x 2, so the batch statistics
  there are of 2 and 8 values a channel, and the training-mode gradients
  through them are as ill-conditioned in fp32 as ResNet-50's (1.4e-4 of the
  largest entry of all apart, up to 2 of a shift-invariant tensor's own);
  JAX's training-mode gradient is not compiled here (26 s on the CPU), the
  eval-mode one holds the backward.
- ``predict`` (sigmoid, per-class offset, NMS, top 100) equal to JAX's: the
  same picks, labels and valid mask, boxes and scores within 1e-5.
- The CLI on synthetic batches and on a COCO tree of the JPEG fixtures, with
  val box AP.
"""

import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.models import efficientdet as jax_det
from deeplearningexamples_tpu.ops import detection as jax_ops
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.data.jpeg_trees import coco_tree
from deeplearningexamples_tpu_torch.models.efficientdet import (
    EfficientDet,
    EfficientDetConfig,
    EfficientDetTask,
    efficientdet_anchors,
)
from deeplearningexamples_tpu_torch.ops import detection
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    efficientdet_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

B, S, G = 2, 128, 8
FLOOR = 1e-3
# (outputs and loss of the largest, each gradient of its own, of all)
TOL = {"eval": (1e-5, 1e-4, 1e-5), "train": (1e-4,)}
STOL = 1e-4
FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jit(f):
    return jax.jit(f, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


@pytest.mark.parametrize("size", [512, 128])
def test_anchors_equal_jax(size):
    got = efficientdet_anchors(EfficientDetConfig(image_size=size))
    want = jax_det.efficientdet_anchors(jax_det.EfficientDetConfig(
        image_size=size))
    assert got.shape == want.shape == ((49_104 if size == 512 else 3069), 4)
    np.testing.assert_array_equal(got, want)


def _boxes(rng, n, scale=100.0):
    lt = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(1, scale / 2, (n, 2))
    return np.concatenate([lt, lt + wh], 1).astype(np.float32)


def test_box_iou_and_match_proposals_equal_jax():
    rng = np.random.default_rng(0)
    gt, anchors = _boxes(rng, 6), _boxes(rng, 300)
    anchors[10:13] = gt[0]  # three anchors tied for gt 0's best IoU
    anchors[20] = [5, 5, 5, 9]  # zero area
    want = np.asarray(jax_ops.box_iou(gt, anchors))
    got = detection.box_iou(torch.from_numpy(gt), torch.from_numpy(anchors))
    np.testing.assert_array_equal(got.numpy(), want)
    iou = np.where(np.arange(6)[:, None] < 5, want, -1.0).astype(np.float32)
    for hi, lo in [(0.5, 0.4), (0.7, 0.3)]:
        for low_quality in (True, False):
            want_m = np.asarray(jax_ops.match_proposals(
                iou, high_threshold=hi, low_threshold=lo,
                allow_low_quality=low_quality))
            got_m = detection.match_proposals(
                torch.from_numpy(iou), high_threshold=hi, low_threshold=lo,
                allow_low_quality=low_quality)
            np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert set(want_m.tolist()) >= {-1, -2}


@pytest.mark.parametrize("threshold", [-np.inf, 0.5])
def test_batched_nms_equals_jax_with_ties(threshold):
    """Clusters of overlapping boxes, scores rounded to two decimals (many
    ties, which both take in index order); with the score threshold fewer
    than ``max_out`` survive and the tail is -1 and invalid."""
    rng = np.random.default_rng(1)
    centers = rng.uniform(0, 400, (12, 2))
    boxes, scores = [], []
    for c in centers:
        for _ in range(25):
            xy = c + rng.normal(0, 6, 2)
            wh = rng.uniform(20, 40, 2)
            boxes.append([*xy, *(xy + wh)])
    boxes = np.asarray(boxes, np.float32)
    boxes[40] = boxes[41]  # a duplicate box
    scores = np.round(rng.uniform(0, 1, len(boxes)), 2).astype(np.float32)
    got_all = detection.batched_nms(
        torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
        torch.from_numpy(np.stack([scores, scores[::-1].copy()])),
        iou_threshold=0.4, max_out=80, score_threshold=threshold)
    for i, (b, s) in enumerate([(boxes, scores),
                                (boxes[::-1].copy(), scores[::-1].copy())]):
        idx, valid = jax_ops.batched_nms(b, s, iou_threshold=0.4, max_out=80,
                                         score_threshold=threshold)
        np.testing.assert_array_equal(got_all[0][i].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_all[1][i].numpy(), np.asarray(valid))
        one = detection.batched_nms(torch.from_numpy(b), torch.from_numpy(s),
                                    iou_threshold=0.4, max_out=80,
                                    score_threshold=threshold)
        np.testing.assert_array_equal(one[0].numpy(), np.asarray(idx))
    if threshold > 0:
        assert not np.asarray(valid).all() and (np.asarray(idx)[
            ~np.asarray(valid)] == -1).all()


# -- the model ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _variables():
    jm = jax_det.EfficientDet(jax_det.EfficientDetConfig(image_size=S),
                              jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((B, S, S, 3)), train=False))
    rng = np.random.default_rng(2)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, 1 / np.sqrt(fan_in), shape)
        if name == "scale":
            return rng.normal(1.0, 0.3, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name.endswith("_weights"):  # BiFPN fusion weights, one negative
            return rng.uniform(-0.2, 1.5, shape)
        return rng.normal(0.0, 0.1, shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, a: leaf(p, a).astype(np.float32), shapes)


def _batch():
    rng = np.random.default_rng(3)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    valid = np.zeros((B, G), bool)
    for i, n in enumerate([5, 2]):
        boxes[i, :n] = _boxes(rng, n, S * 0.8)
        labels[i, :n] = rng.integers(0, 90, n)
        valid[i, :n] = True
    return {"image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
            "boxes": boxes, "labels": labels, "valid": valid}


def _draws(model: EfficientDet) -> list[np.ndarray]:
    """The port's stochastic-depth uniforms from generator seed 5, per
    block that drops, in order."""
    blocks = [b for st in model.backbone.layers for b in st.values()]
    sizes = [B for b in blocks if b.drops]
    u = torch.rand(sum(sizes), generator=torch.Generator().manual_seed(5))
    return [p.numpy() for p in torch.split(u, sizes)]


class _EvalApply:
    """JAX's model with ``apply`` always in eval mode, so that JAX's own
    ``loss_fn`` computes the eval-mode loss."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, images, train, mutable=None, rngs=None):
        out = self.model.apply(variables, images, train=False)
        if mutable is None:
            return out
        return out, {"batch_stats": variables["batch_stats"]}


@functools.lru_cache(maxsize=None)
def _jax32():
    """JAX in fp32, one jitted call: {"eval": (cls, box, loss, (cls_loss,
    box_loss), grads), "train": (loss, (cls_loss, box_loss), new batch
    stats), "predict": predict's four outputs}."""
    v = _variables()
    batch = _batch()
    task = jax_det.EfficientDetTask(jax_det.EfficientDetConfig(image_size=S),
                                    jnp.float32, max_gt=G)
    draws = iter(_draws(_port()))  # the training forward's, in block order

    def bernoulli(key, p, shape):
        return jnp.asarray(next(draws)).reshape(shape) < p

    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        eval_task = jax_det.EfficientDetTask(task.cfg, jnp.float32, max_gt=G)
        eval_task.model = _EvalApply(task.model)

        def f(v, batch):
            def loss(t, params):
                return t.loss_fn(params, v["batch_stats"], batch,
                                 jax.random.key(0))

            (lv, (_, m)), g = jax.value_and_grad(
                functools.partial(loss, eval_task), has_aux=True)(v["params"])
            cls, box = task.model.apply(v, batch["image"], train=False)
            lt, (ms, mt) = loss(task, v["params"])
            return {"eval": (cls, box, lv, (m["cls_loss"], m["box_loss"]), g),
                    "train": (lt, (mt["cls_loss"], mt["box_loss"]), ms),
                    "predict": task.predict(v["params"], v["batch_stats"],
                                            batch["image"])}

        return jax.tree_util.tree_map(np.asarray, _jit(f)(v, batch))


def _port() -> EfficientDet:
    v = _variables()
    pm = EfficientDet(EfficientDetConfig(image_size=S), torch.float32)
    sd = efficientdet_state_dict_from_jax(v["params"], v["batch_stats"])
    pm.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                        sd.items()}, strict=True)
    return pm


@pytest.fixture(autouse=True)
def _exact_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _losses_close(got, want, tol):
    loss, (cls_loss, box_loss) = want
    for g, w in [(got[0], loss), (got[1]["cls_loss"], cls_loss),
                 (got[1]["box_loss"], box_loss)]:
        assert abs(float(g) - float(w)) <= tol * abs(float(w))
    assert float(cls_loss) > 0 and float(box_loss) > 0


def test_eval_forward_loss_and_gradients_match_jax():
    """BN on its running statistics: the class and box outputs, the loss and
    its focal and Huber parts, and every gradient."""
    want_cls, want_box, want_loss, want_parts, grads = _jax32()["eval"]
    tol = TOL["eval"]
    pm = _port().eval()
    task = EfficientDetTask(EfficientDetConfig(image_size=S), torch.float32,
                            max_gt=G)
    batch = _torch_batch()
    with torch.no_grad():
        cls, box = pm(batch["image"].permute(0, 3, 1, 2))
    assert cls.shape == (B, 3069, 90) and box.shape == (B, 3069, 4)
    assert _rel(cls, want_cls) <= tol[0] and _rel(box, want_box) <= tol[0]
    loss, (_, metrics) = task.loss_fn(pm, task.model_state(pm), batch, None)
    loss.backward()
    _losses_close((loss, metrics), (want_loss, want_parts), tol[0])
    want = efficientdet_state_dict_from_jax(grads)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    err = {n: float((got[n].double() - torch.from_numpy(w).double()).abs()
                    .max()) for n, w in want.items()}
    # a fusion weight below 0 (ReLU'd away) has a gradient of exactly 0
    zero = [n for n, w in want.items() if not np.abs(w).any()]
    assert zero and all(not got[n].any() for n in zero)
    own = max((e / max(float(np.abs(want[n]).max()), FLOOR * top), n)
              for n, e in err.items() if n not in zero)
    of_all = max((e / top, n) for n, e in err.items())
    assert own[0] <= tol[1], own
    assert of_all[0] <= tol[2], of_all


def test_training_loss_and_statistics_match_jax():
    """A training forward (batch statistics, the backbone's stochastic
    depth on the same draws): the loss, its parts, and the BN running
    statistics after it."""
    want_loss, want_parts, want_stats = _jax32()["train"]
    pm = _port().train()
    task = EfficientDetTask(EfficientDetConfig(image_size=S), torch.float32,
                            max_gt=G)
    with torch.no_grad():
        loss, (_, metrics) = task.loss_fn(pm, task.model_state(pm),
                                          _torch_batch(),
                                          torch.Generator().manual_seed(5))
    _losses_close((loss, metrics), (want_loss, want_parts), TOL["train"][0])
    stats = efficientdet_state_dict_from_jax({}, want_stats)
    sd = pm.state_dict()
    assert stats and max(_rel(sd[k], w) for k, w in stats.items()) <= STOL


def test_predict_matches_jax():
    boxes, scores, labels, valid = _jax32()["predict"]
    task = EfficientDetTask(EfficientDetConfig(image_size=S), torch.float32)
    pm = _port().train()
    got = task.predict(pm, torch.from_numpy(_batch()["image"]))
    assert pm.training  # the mode is put back
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), labels)
    assert _rel(got[1], scores) <= 1e-5 and _rel(got[0], boxes) <= 1e-5
    assert valid.sum() > 0


# -- the CLI -----------------------------------------------------------------


def test_cli_trains_efficientdet_on_synthetic_batches(tmp_path):
    before = fa.launches
    state, best, val = cli(["efficientdet", "--device", "cpu", "--batch-size",
                            "2", "--image-size", str(S), "--steps-per-epoch",
                            "2", "--lr", "0.01", "--workspace", str(tmp_path)])
    assert fa.launches == before and state.step == 2 and val is None
    assert (tmp_path / "efficientdet_ckpt" / "ckpt_2.pt").exists()


def test_cli_trains_efficientdet_on_coco_with_val_ap(tmp_path):
    if not shutil.which("g++"):
        pytest.skip("the host data plane needs g++, which this host lacks")
    root = coco_tree(sorted(FIXTURES.glob("*.jpg")), tmp_path / "coco", 4, 3)
    state, _, val = cli(["efficientdet", "--device", "cpu", "--data-backend",
                         "coco", "--data-dir", str(root), "--batch-size", "2",
                         "--image-size", str(S), "--lr", "0.01",
                         "--workspace", str(tmp_path / "ws")])
    assert state.step == 2
    assert set(val) == {"val.bbox_mAP", "val.bbox_mAP50"}
    assert all(0.0 <= x <= 1.0 for x in val.values())
