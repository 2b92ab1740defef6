"""Port parity: Mask R-CNN, its detection ops, data and metric, against the
JAX package.

- ``roi_align`` (samples outside the map and boxes below a pixel among
  them) and ``top_k`` equal to JAX's ops run eagerly (``jax.disable_jit``),
  bit for bit (``roi_align`` of one channel within 2^-24: eager XLA then
  sums a bin's samples pairwise); against the jitted ``roi_align`` within
  4e-6 of the largest entry (XLA fuses multiplies and adds). The box
  coders within 1e-6 (XLA's ``log`` and ``exp`` are an ulp from torch's).
  ``fpn_anchors`` equal to JAX's.
- ``_random_subset`` fed JAX's uniforms: the same indices and flags.
- The proposals of random RPN outputs (rounded, so that the top-k meets
  ties) equal to JAX's: the same boxes (within 1e-4 px) and valid mask.
- The model: ``resnet18`` from JAX's ``ARCHS``, 128 x 128 images, B=2, a
  32-wide FPN, 64-wide box head, 6 classes; JAX's variables drawn in numpy
  and carried over with ``maskrcnn_state_dict_from_jax``; both sides in
  fp32 (TF32 off, JAX at "highest", jitted once with XLA's quick code
  generation), the samplers on JAX's draws (``MaskRCNNTask.draws``).
  Eval mode (BN on its running statistics) on pinned proposals (the same
  boxes in both packages; a proposal is a box decoded through ``exp`` of
  RPN deltas, and random RPN weights put its corners 1e-3 px apart between
  any two of JAX, the port and float64, which moves the pooled features by
  6e-5 of their largest entry and flips ReLUs of the mask head; the
  proposals are held by their own test above): each loss term within 1e-5
  of JAX's, every gradient within 1e-3 of its own tensor's largest entry
  and within 1e-5 of the largest entry of all. Training mode (batch
  statistics, which the backbone updates, and the proposals of its RPN):
  each term within 1e-4 and the BN running statistics within 1e-4 of each
  tensor's largest entry. A random ResNet's training-mode forward is 1e-5
  to 2e-5 from float64 in fp32 at these sizes in either package (4 x 4
  maps at C5), and its gradients through the batch statistics 2.5e-2 of a
  tensor's own largest entry apart (as ResNet-50's, ``chip_smoke.py``
  phase 19): the eval-mode step holds the backward.
- ``predict``: the same valid mask and labels, boxes, scores and masks
  within 1e-4 of the largest entry (on its own proposals, so 1e-3 px
  apart: readings 2.6e-5 and 3.1e-5 for boxes and scores).
- ``rasterize_polygons``, ``SyntheticDetectionLoader(with_masks=True)``,
  ``CocoRawLoader(with_masks=True)`` (two epochs, train and eval, on a COCO
  tree of the JPEG fixtures with polygons), ``paste_mask`` and ``MaskMAP``
  equal to JAX's.
- The heads' names round-trip through JAX's ``convert_maskrcnn_heads``.
- The CLI on the CPU (the model at the width above): synthetic batches
  with the quirks of JAX's
  ``run_maskrcnn`` pinned (without a config file the rate is
  ``CommonConfig.lr``, 0.1; configs.yml's ``weight_decay`` reaches no
  optimizer; the step policy decays at epochs 30, 60 and 80 after a warmup
  epoch), and a COCO run that logs box and mask mAP.
"""

import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.data import coco as jax_coco
from deeplearningexamples_tpu.data import det_synthetic as jax_synth
from deeplearningexamples_tpu.models import maskrcnn as jm
from deeplearningexamples_tpu.models.ssd import coco_eval as jax_eval
from deeplearningexamples_tpu.ops import detection as jax_ops
from deeplearningexamples_tpu.utils.torch_import import convert_maskrcnn_heads
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.data import coco, det_synthetic
from deeplearningexamples_tpu_torch.data.jpeg_trees import coco_tree
from deeplearningexamples_tpu_torch.models import maskrcnn as tm
from deeplearningexamples_tpu_torch.models.ssd import coco_eval
from deeplearningexamples_tpu_torch.ops import detection
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    maskrcnn_state_dict_from_jax,
)
from torch_parity import draw, jit, load, raport_losses, rel, worst
from torch_threads import torch_one_thread  # noqa: F401

B, S, G, MG = 2, 128, 4, 32
CFG = dict(backbone="resnet18", image_size=S, num_classes=6, fpn_width=32,
           head_fc_dim=64, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=64,
           rpn_batch_per_image=64, roi_batch_per_image=32)
# (each loss term; a gradient over its own largest entry, over the largest
# of all): eval mode; the training-mode terms and BN statistics
TOL_EVAL = (1e-5, 1e-3, 1e-5)
TOL_TRAIN = 1e-4
TOL_JIT = 4e-6  # the port's roi_align against JAX's jitted one
# predict's boxes, scores and masks, on its own proposals (readings 2.6e-5,
# 3.1e-5, below)
TOL_PREDICT = 1e-4
FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _exact_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _boxes(rng, n, lo=-20.0, hi=60.0, side=40.0):
    lt = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([lt, lt + rng.uniform(0, side, (n, 2))],
                          1).astype(np.float32)


# -- the ops ------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_roi_align_equals_jax(scale):
    """Samples beyond the map (boxes from -20 px, past the far edge), boxes
    below a pixel, and a grid of 0/1 values as the mask targets sample."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(13, 11, 5)).astype(np.float32)
    boxes = _boxes(rng, 40)
    boxes[0] = [3.0, 3.0, 3.2, 3.3]  # sub-pixel: floored at 1 px
    boxes[1] = [-30.0, -30.0, -25.0, -26.0]  # every sample outside
    got = detection.roi_align(_t(feats), _t(boxes), output_size=7,
                              spatial_scale=scale).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_ops.roi_align(feats, boxes, output_size=7,
                                            spatial_scale=scale))
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and got[0].any()
    jitted = jax_ops.roi_align(feats, boxes, output_size=7, spatial_scale=scale)
    assert rel(got, jitted) <= TOL_JIT
    # one channel (a mask grid): eager XLA sums a bin's four samples
    # pairwise there, the port (and XLA above one channel) in order
    grid = (rng.uniform(size=(32, 32, 1)) > 0.5).astype(np.float32)
    got = detection.roi_align(_t(grid), _t(boxes[:6]), output_size=28,
                              spatial_scale=0.5).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_ops.roi_align(grid, boxes[:6], output_size=28,
                                            spatial_scale=0.5))
    assert np.abs(got - want).max() <= 2.0 ** -24


def test_box_coders_anchors_and_top_k_equal_jax():
    rng = np.random.default_rng(1)
    anchors, gt = _boxes(rng, 64, 0, 80), _boxes(rng, 64, 0, 80)
    gt[0, 2:] = gt[0, :2]  # degenerate: floored at 1e-3
    deltas = rng.normal(0, 2, (64, 4)).astype(np.float32)
    deltas[1, 2:] = [9.0, -9.0]  # clamped to log(1000 / 16)
    for w in [(1.0, 1.0, 1.0, 1.0), tm.ROI_BOX_WEIGHTS]:
        with jax.disable_jit():
            enc = np.asarray(jax_ops.encode_boxes(anchors, gt, w))
            dec = np.asarray(jax_ops.decode_boxes(anchors, deltas, w))
        # XLA's log and exp are not torch's: an ulp apart
        assert rel(detection.encode_boxes(_t(anchors), _t(gt), w), enc) <= 1e-6
        assert rel(detection.decode_boxes(_t(anchors), _t(deltas), w),
                   dec) <= 1e-6
        assert np.isfinite(enc).all()
    for size in (128, 800):
        got = tm.fpn_anchors(tm.MaskRCNNConfig(image_size=size))
        want = jm.fpn_anchors(jm.MaskRCNNConfig(image_size=size))
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
    x = np.round(rng.normal(size=(3, 500)), 1).astype(np.float32)  # ties
    val, idx = tm.top_k(_t(x), 70)
    want_val, want_idx = jax.lax.top_k(x, 70)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_val))


@pytest.mark.parametrize("n_true", [3, 400])
def test_random_subset_on_jax_draws_equals_jax(n_true):
    """Fewer True entries than slots (the rest flagged off) and more."""
    rng = np.random.default_rng(2)
    mask = np.zeros(1000, bool)
    mask[rng.choice(1000, n_true, replace=False)] = True
    key = jax.random.key(n_true)
    want_idx, want_ok = jm._random_subset(key, jnp.asarray(mask), 64)
    u = np.asarray(jax.random.uniform(key, mask.shape))
    idx, ok = tm._random_subset(_t(u), _t(mask), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert int(ok.sum()) == min(n_true, 64)


def _jtask():
    return jm.MaskRCNNTask(jm.MaskRCNNConfig(**CFG), jnp.float32)


def _task():
    return tm.MaskRCNNTask(tm.MaskRCNNConfig(**CFG), torch.float32)


def test_proposals_equal_jax():
    rng = np.random.default_rng(3)
    n = [a.shape[0] for a in tm.fpn_anchors(tm.MaskRCNNConfig(**CFG))]
    logits = [np.round(rng.normal(size=(B, k)), 1).astype(np.float32)
              for k in n]
    deltas = [rng.normal(0, 0.3, (B, k, 4)).astype(np.float32) for k in n]
    want_boxes, want_valid = jax.jit(jax.vmap(_jtask()._proposals_one))(
        logits, deltas)
    boxes, valid = _task().proposals([_t(x) for x in logits],
                                     [_t(x) for x in deltas])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               rtol=0, atol=1e-4)
    assert valid.all() and boxes.shape == (B, CFG["rpn_post_nms_top_n"], 4)


# -- the model ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _variables():
    shapes = jax.eval_shape(lambda: _jtask().model.init(
        jax.random.key(0), jnp.zeros((1, S, S, 3)), train=False))
    return draw(shapes, 4)


def _batch():
    rng = np.random.default_rng(5)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    valid = np.zeros((B, G), bool)
    masks = np.zeros((B, G, MG, MG), np.float32)
    for i, n in enumerate([3, 1]):
        c = rng.uniform(30, 90, (n, 2))
        wh = rng.uniform(20, 60, (n, 2))
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], 1)
        labels[i, :n] = rng.integers(0, CFG["num_classes"] - 1, n)
        valid[i, :n] = True
        for g in range(n):
            x1, y1, x2, y2 = (boxes[i, g] * MG / S).astype(int)
            masks[i, g, max(y1, 0):y2, max(x1, 0):x2] = 1.0
    return {"image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
            "boxes": boxes, "labels": labels, "valid": valid, "masks": masks}


KEY = 6


def _jax_draws() -> dict:
    """JAX's sampler uniforms for ``loss_fn(..., key(KEY))``: per image i
    ``split(rng, 2B + 1)[i]`` (RPN) and ``[B + i]`` (ROIs), each split into
    (pos, neg)."""
    keys = jax.random.split(jax.random.key(KEY), 2 * B + 1)
    a = sum(x.shape[0] for x in jm.fpn_anchors(jm.MaskRCNNConfig(**CFG)))
    r = CFG["rpn_post_nms_top_n"] + G
    out = {k: [] for k in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg")}
    for i in range(B):
        for part, key, n in (("rpn", keys[i], a), ("roi", keys[B + i], r)):
            rp, rn = jax.random.split(key)
            out[f"{part}_pos"].append(np.asarray(jax.random.uniform(rp, (n,))))
            out[f"{part}_neg"].append(np.asarray(jax.random.uniform(rn, (n,))))
    return {k: np.stack(v) for k, v in out.items()}


def _pinned_proposals():
    """(boxes (64, 4), valid (64,)): each image's gt boxes jittered by up to
    4 px, then random boxes, the last four slots dead; the eval-mode step
    runs on these in both packages (for each image)."""
    rng = np.random.default_rng(9)
    gt = _batch()["boxes"][:, :3].reshape(-1, 4)
    jitter = gt + rng.uniform(-4, 4, gt.shape).astype(np.float32)
    boxes = np.concatenate([jitter, np.clip(_boxes(rng, 64 - len(gt), 0, 90),
                                            0, S)])
    valid = np.arange(64) < 60
    return boxes.astype(np.float32), valid


class _EvalApply:
    """JAX's model with every ``apply`` in eval mode, so that JAX's own
    ``loss_fn`` computes the eval-mode loss."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, mutable=None, **kw):
        if "train" in kw:
            kw["train"] = False
        out = self.model.apply(variables, *args, **kw)
        return out if mutable is None else (
            out, {"batch_stats": variables["batch_stats"]})


@functools.lru_cache(maxsize=None)
def _jax32() -> dict:
    """JAX in fp32, one jitted call: {"eval": (loss, terms, grads),
    "train": (loss, terms, new batch stats), "predict": predict's five
    outputs}."""
    v, batch = _variables(), _batch()
    task, eval_task = _jtask(), _jtask()
    eval_task.model = _EvalApply(eval_task.model)
    boxes, valid = _pinned_proposals()
    eval_task._proposals_one = lambda logits, deltas: (boxes, valid)

    def f(v, batch):
        key = jax.random.key(KEY)
        (le, (_, me)), g = jax.value_and_grad(eval_task.loss_fn, has_aux=True)(
            v["params"], v["batch_stats"], batch, key)
        lt, (ms, mt) = task.loss_fn(v["params"], v["batch_stats"], batch, key)
        return {"eval": (le, me, g), "train": (lt, mt, ms),
                "predict": task.predict(v["params"], v["batch_stats"],
                                        batch["image"], max_out=16)}

    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, jit(f)(v, batch))


def _port(train: bool, pinned: bool = False):
    v = _variables()
    model = load(tm.MaskRCNN(tm.MaskRCNNConfig(**CFG), torch.float32),
                 maskrcnn_state_dict_from_jax(v["params"], v["batch_stats"]))
    task = _task()
    draws = {k: _t(x) for k, x in _jax_draws().items()}
    task.draws = lambda generator, batch: draws
    if pinned:
        boxes, valid = (_t(x)[None].expand(B, *x.shape)
                        for x in _pinned_proposals())
        task.proposals = lambda logits, deltas: (boxes, valid)
    return task, model.train(train)


def _terms_close(got_loss, got, want_loss, want, tol):
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) <= tol, (k, float(got[k]), want[k])
        assert float(want[k]) > 0, k
    assert rel(float(got_loss), want_loss) <= tol


def test_eval_loss_and_gradients_match_jax():
    want_loss, want_terms, grads = _jax32()["eval"]
    task, model = _port(train=False, pinned=True)
    batch = {k: _t(x) for k, x in _batch().items()}
    loss, (_, terms) = task.loss_fn(model, task.model_state(model), batch,
                                    torch.Generator())
    loss.backward()
    _terms_close(loss.detach(), terms, want_loss, want_terms, TOL_EVAL[0])
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    own, of_all = worst(got, maskrcnn_state_dict_from_jax(grads))
    assert own[0] <= TOL_EVAL[1], own
    assert of_all[0] <= TOL_EVAL[2], of_all


def test_training_loss_and_statistics_match_jax():
    want_loss, want_terms, want_stats = _jax32()["train"]
    task, model = _port(train=True)
    batch = {k: _t(x) for k, x in _batch().items()}
    with torch.no_grad():
        loss, (_, terms) = task.loss_fn(model, task.model_state(model), batch,
                                        torch.Generator())
    _terms_close(loss, terms, want_loss, want_terms, TOL_TRAIN)
    stats = maskrcnn_state_dict_from_jax(_variables()["params"], want_stats)
    sd = model.state_dict()
    running = [k for k in stats if "running_" in k]
    assert running and max(rel(sd[k], stats[k]) for k in running) <= TOL_TRAIN


def test_predict_matches_jax():
    boxes, scores, labels, valid, masks = _jax32()["predict"]
    task, model = _port(train=True)
    got = task.predict(model, _t(_batch()["image"]), max_out=16)
    assert model.training  # the mode is put back
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), labels)
    for g, w in zip((got[0], got[1], got[4]), (boxes, scores, masks)):
        assert rel(g, w) <= TOL_PREDICT
    assert valid.sum() > 0 and masks.shape == (B, 16, 28, 28)


def test_heads_round_trip_through_jax_converter():
    params = _variables()["params"]
    sd = maskrcnn_state_dict_from_jax(params)
    back = convert_maskrcnn_heads({k: v for k, v in sd.items()
                                   if not k.startswith("backbone.")})
    for ours, theirs in (("fpn", "fpn"), ("rpn", "rpn_head"),
                         ("box", "box_head"), ("mask", "mask_head")):
        got = jax.tree_util.tree_leaves_with_path(back[ours])
        want = dict(jax.tree_util.tree_leaves_with_path(params[theirs]))
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_array_equal(leaf, want[path])


# -- data and metric -----------------------------------------------------------


def test_rasterize_polygons_and_synthetic_masks_equal_jax():
    rng = np.random.default_rng(7)
    for flip in (False, True):
        polys = [rng.uniform(0, 1, 2 * k) for k in (3, 5, 8)]
        polys.append(np.array([0.1, 0.1, 0.9, 0.1]))  # two points: skipped
        window = (0.1, 0.2, 0.8, 0.9)
        got = coco.rasterize_polygons(polys, 48, window, flip)
        np.testing.assert_array_equal(
            got, jax_coco.rasterize_polygons(polys, 48, window, flip))
        assert 0 < got.sum() < got.size
    ours = det_synthetic.SyntheticDetectionLoader(2, 96, 80, max_gt=5, steps=2,
                                                  with_masks=True, seed=3)
    theirs = jax_synth.SyntheticDetectionLoader(2, 96, 80, max_gt=5, steps=2,
                                                with_masks=True, seed=3)
    for got, want in zip(ours, theirs, strict=True):
        assert got.keys() == want.keys() and "masks" in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    if not shutil.which("g++"):
        pytest.skip("the host data plane needs g++, which this host lacks")
    return coco_tree(sorted(FIXTURES.glob("*.jpg")),
                     tmp_path_factory.mktemp("coco"), 6, 3, seed=2,
                     polygons=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_coco_loader_with_masks_equals_jax(tree, train):
    split = "train" if train else "val"
    args = (str(tree / f"{split}2017"),
            str(tree / "annotations" / f"instances_{split}2017.json"))
    ours = coco.CocoRawLoader(coco.CocoDetectionDataset(*args), 2, 64,
                              max_gt=4, train=train, seed=5, n_threads=2,
                              with_masks=True, mask_grid=32)
    theirs = jax_coco.CocoRawLoader(jax_coco.CocoDetectionDataset(*args), 2,
                                    64, max_gt=4, train=train, seed=5,
                                    n_threads=2, with_masks=True, mask_grid=32)
    with_masks = 0
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and "masks" in g
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), w[k], k)
            with_masks += int(g["masks"].sum() > 0)
    assert with_masks


def test_paste_mask_and_mask_map_equal_jax():
    """Detections near the ground truth (boxes jittered, masks mostly
    set), the ground truth's masks rasterized diamonds, three classes."""
    rng = np.random.default_rng(8)
    ours, theirs = coco_eval.MaskMAP(image_size=100.0), \
        jax_eval.MaskMAP(image_size=100.0)
    for _ in range(3):
        gt_boxes = _boxes(rng, 3, 0, 60)
        gt_labels = rng.integers(0, 3, 3)
        gt_masks = np.stack([coco.rasterize_polygons([np.array([
            (x1 + x2) / 2, y1, x2, (y1 + y2) / 2, (x1 + x2) / 2, y2, x1,
            (y1 + y2) / 2]) / 100.0], 64) for x1, y1, x2, y2 in gt_boxes])
        det_boxes = np.concatenate([gt_boxes + rng.uniform(
            -3, 3, gt_boxes.shape).astype(np.float32), _boxes(rng, 2, 0, 60)])
        det_masks = (rng.uniform(size=(5, 28, 28)) < 0.8).astype(np.float32)
        det_labels = np.concatenate([gt_labels, rng.integers(0, 3, 2)])
        det_scores = rng.uniform(size=5).astype(np.float32)
        for b, m in zip(det_boxes, det_masks):
            np.testing.assert_array_equal(
                coco_eval.paste_mask(b, m, 64, 100.0),
                jax_eval.paste_mask(b, m, 64, 100.0))
        for ev in (ours, theirs):
            ev.add_image_masks(det_boxes, det_masks, det_labels, det_scores,
                               gt_masks, gt_labels)
    got, want = ours.compute(), theirs.compute()
    assert got == want and got["mAP50"] > 0


# -- the CLI ------------------------------------------------------------------


@pytest.fixture
def small_cli(monkeypatch):
    """The CLI's Mask R-CNN at the tests' width (its image size is the
    command's)."""
    kw = {k: v for k, v in CFG.items() if k != "image_size"}
    monkeypatch.setattr(tm, "MaskRCNNConfig",
                        functools.partial(tm.MaskRCNNConfig, **kw))


def test_cli_trains_maskrcnn_with_jaxs_quirks(tmp_path, monkeypatch,
                                               small_cli):
    """Without a config file the rate is ``CommonConfig.lr``; with
    configs.yml's section the step policy at 0.02 (a warmup epoch, decays
    at epochs 30, 60 and 80) and its ``weight_decay`` reaches no
    optimizer."""
    calls = []
    orig = opt.sgd
    monkeypatch.setattr(opt, "sgd", lambda *a, **k: calls.append((a, k))
                        or orig(*a, **k))
    base = ["maskrcnn", "--device", "cpu", "--batch-size", "2",
            "--image-size", "64", "--steps-per-epoch", "2"]
    state, _, val = cli(base + ["--workspace", str(tmp_path / "a")])
    assert state.step == 2 and val is None
    (lr, mom), kw = calls[0]  # cosine over the run
    assert lr(0) == pytest.approx(0.1) and mom == 0.9 and not kw
    assert (tmp_path / "a" / "maskrcnn_ckpt" / "ckpt_2.pt").exists()
    losses = raport_losses(tmp_path / "a" / "maskrcnn_raport.json")
    assert len(losses) == 2 and np.isfinite(losses).all()
    cli(base + ["--config-file", str(ROOT / "configs.yml"), "--epochs", "1",
                "--workspace", str(tmp_path / "b")])
    (lr, mom), kw = calls[1]
    assert not kw and mom == 0.9  # no weight decay
    want = jax_cli._make_schedule(jax_cli.CommonConfig(
        lr=0.02, lr_schedule="step", warmup_epochs=1, epochs=12), 2)
    for step in (0, 1, 2, 59, 60, 119, 120, 160):
        assert lr(step) == pytest.approx(float(want(step)), rel=1e-6), step
    assert lr(0) == pytest.approx(0.01) and lr(1) == pytest.approx(0.02)
    assert lr(59) == pytest.approx(0.02) and lr(60) == pytest.approx(0.002)
    assert lr(120) == pytest.approx(2e-4) and lr(160) == pytest.approx(2e-5)
    report = (tmp_path / "b" / "maskrcnn_raport.json").read_text()
    assert '"weight_decay": 0.0001' in report


def test_cli_maskrcnn_on_coco_logs_box_and_mask_map(tree, tmp_path,
                                                    small_cli):
    state, _, val = cli(["maskrcnn", "--device", "cpu", "--data-backend",
                         "coco", "--data-dir", str(tree), "--batch-size", "2",
                         "--image-size", "64", "--lr", "1e-3", "--amp",
                         "false", "--workspace", str(tmp_path)])
    assert state.step == 3
    assert set(val) == {"val.bbox_mAP", "val.bbox_mAP50", "val.segm_mAP",
                        "val.segm_mAP50"}
    assert all(0.0 <= x <= 1.0 for x in val.values())
    report = (tmp_path / "maskrcnn_raport.json").read_text()
    assert "val.segm_mAP" in report
