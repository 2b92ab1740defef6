"""Port parity: Jasper and QuartzNet, the CTC loss, greedy decoding, the
offline Jasper endpoint, wav2vec 2.0 (pretraining and CTC fine-tuning) and
the ``jasper`` and ``wav2vec2`` commands, in torch against the JAX package.

The models run at small widths: Jasper 5x3, JASPER_10x5DR and
QUARTZNET_15x5 keep their blocks, kernels, strides, dilations, dense panes
and separable convolutions, with the channels / 32, at most 2 repeats a
block and dropout 0, over 16 mels, 64 frames and a vocab of 12; wav2vec2
has 3 convolutions of 16, 2 layers of 32, 2 heads, a 16-tap positional
convolution in 4 groups and a 2 x 8 codebook, over 800 samples (39
frames). The JAX side is fp32 at "highest" precision, its Pallas attention
in interpret mode, jitted once per function; the port is fp32 on one thread.
JAX's parameters are drawn in numpy for its own shapes and carried into the
port by the bridge, which also carries JAX's gradients across.

Random draws cannot match ``jax.random``: the tests make JAX's draws (the
Gumbel uniforms, the negatives' indices, the CTC model's time mask) from
its own keys and hand them to the port's ``draws`` methods, with hidden
dropout at 0; the port's own draws are held to their distributions.

Tolerances, relative to the largest entry of the JAX tensor: forwards
1e-5 (Jasper's log-probabilities 1e-4: a training-mode BN's variance is
E[x^2] - E[x]^2 in flax), the BN running statistics 1e-5; losses 1e-5
relative; every gradient within 1e-3 of its own largest entry and 1e-5 of
the largest entry of all (2e-5 for Jasper and QuartzNet, whose gradients
pass through training-mode BN statistics: QuartzNet's pointwise kernels read
1.1e-5 against JAX compiled with XLA's quick code generation, under 1e-5
against its default); the CTC loss and its gradient
against ``optax.ctc_loss`` 1e-5; greedy decoding, the endpoints' tokens and
the round trips through JAX's converters exactly.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.models import asr as jax_asr
from deeplearningexamples_tpu.models import wav2vec2 as jax_w2v
from deeplearningexamples_tpu.serving import recipes as jax_recipes
from deeplearningexamples_tpu.utils.torch_import import (
    convert_jasper,
    convert_wav2vec2,
)
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.core.losses import ctc_loss
from deeplearningexamples_tpu_torch.models import asr, wav2vec2
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.serving import recipes
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    jasper_state_dict_from_jax,
    wav2vec2_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

FTOL = 1e-5
LOGP_TOL = 1e-4
LTOL = 1e-5
GTOL = (1e-3, 1e-5)
JASPER_GTOL = (1e-3, 2e-5)
CTC_TOL = 1e-5

N_MELS, VOCAB, B, FRAMES, LABELS = 16, 12, 3, 64, 6
FEAT_LENGTHS = (64, 50, 37)
LABEL_LENGTHS = (6, 4, 2)
W2V_KW = dict(conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)), d_model=32,
              n_heads=2, n_layers=2, d_ff=64, dropout=0.0, conv_pos=16,
              conv_pos_groups=4, n_groups=2, n_entries=8, codevector_dim=16,
              mask_span=2, n_negatives=5)
AUDIO = 800


@pytest.fixture(autouse=True)
def _exact_fp32():
    with jax.default_matmul_precision("highest"):
        yield


def _jit(f):
    """``jax.jit`` with XLA's quick CPU code generation: these functions run
    once or twice, so compiling dominates."""
    return jax.jit(f, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _worst(got: dict, want: dict) -> tuple[tuple, tuple]:
    """The worst (error, name) over each tensor's largest entry and over the
    largest entry of all. A key projection's bias moves every score of a
    query row by the same amount, which the softmax cancels: its gradient is
    0 but for rounding, and is held to the second only."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return (max((_rel(got[n], w), n) for n, w in want.items()
                if not n.endswith("k_proj.bias")),
            max((float(np.abs(np.asarray(got[n], np.float64) - w).max()) / top,
                 n) for n, w in want.items()))


def _draw(shapes, seed: int):
    """Variables of the JAX model's shapes, drawn in numpy: scales 1 + 0.2
    N(0, 1), biases and running means 0.1 N(0, 1), running variances U(0.5,
    1.5), every other leaf N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name == "scale":
            out = 1.0 + 0.2 * rng.normal(size=x.shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("bias", "mean"):
            out = 0.1 * rng.normal(size=x.shape)
        elif len(x.shape) == 1:  # mask_embedding
            out = rng.uniform(size=x.shape)
        else:
            out = rng.normal(size=x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return model


def _sd_numpy(model: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _grads(model: torch.nn.Module) -> dict:
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the CTC loss and greedy decoding ---------------------------------------------


def _ctc_case(seed=0, t=20, c=6):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, t, c)).astype(np.float32) * 2
    labels = np.array([[1, 1, 2, 3], [4, 2, 2, 0], [5, 0, 0, 0]], np.int32)
    lpad = np.array([[0, 0, 0, 0], [0, 0, 0, 1], [0, 1, 1, 1]], np.float32)
    fpad = np.zeros((3, t), np.float32)
    fpad[1, 15:] = 1.0
    fpad[2, 9:] = 1.0
    return logits, fpad, labels, lpad


def test_ctc_loss_and_gradient_match_optax_through_log_softmax():
    """Log-softmax outputs in, as the models feed them: the loss and the
    gradient with respect to the logits before that log-softmax."""
    logits, fpad, labels, lpad = _ctc_case()

    def f(x):
        return jnp.sum(optax.ctc_loss(jax.nn.log_softmax(x), fpad, labels,
                                      lpad) * jnp.arange(1.0, 4.0))

    want_loss = optax.ctc_loss(jax.nn.log_softmax(logits), fpad, labels, lpad)
    want_grad = jax.grad(f)(logits)
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(fpad),
                   torch.from_numpy(labels), torch.from_numpy(lpad))
    (got * torch.arange(1.0, 4.0)).sum().backward()
    assert _rel(got.detach().numpy(), want_loss) < CTC_TOL
    assert _rel(x.grad.numpy(), want_grad) < CTC_TOL


def test_ctc_loss_on_an_infeasible_label_is_inf_where_optax_is_finite():
    """Five frames cannot emit ``1 1 1`` (repeats need blanks between):
    optax's ``log_epsilon`` gives a large finite loss, ``F.ctc_loss``
    ``inf``. Feasible rows agree."""
    logits, fpad, labels, lpad = _ctc_case(t=5)
    labels = labels.copy()
    labels[0] = [1, 1, 1, 2]
    fpad[:] = 0.0
    want = np.asarray(optax.ctc_loss(logits, fpad, labels, lpad))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(fpad),
                   torch.from_numpy(labels), torch.from_numpy(lpad)).numpy()
    assert np.isfinite(want[0]) and want[0] > 1e4
    assert np.isinf(got[0])
    assert _rel(got[1:], want[1:]) < CTC_TOL


def test_greedy_ctc_decode_matches_jax():
    logp = np.random.default_rng(1).normal(size=(4, 30, 5))
    logp[:, ::3, 0] += 5.0  # blanks between some repeats
    assert asr.greedy_ctc_decode(logp) == jax_asr.greedy_ctc_decode(logp)
    assert asr.greedy_ctc_decode(np.eye(3)[[1, 1, 0, 1, 2, 2]][None]) == [[1, 1, 2]]


# -- Jasper and QuartzNet ------------------------------------------------------------


def _small(cfg: jax_asr.JasperConfig) -> dict:
    """The config's blocks with the channels / 32, at most 2 repeats and no
    dropout, as keyword arguments of ``JasperBlock``."""
    return dict(n_mels=N_MELS, vocab_size=VOCAB, blocks=tuple(
        dict(dataclasses.asdict(b), channels=b.channels // 32,
             repeats=min(b.repeats, 2), dropout=0.0) for b in cfg.blocks))


CONFIGS = {"5x3": _small(jax_asr.JasperConfig()),
           "10x5dr": _small(jax_asr.JASPER_10x5DR),
           "quartznet": _small(jax_asr.QUARTZNET_15x5)}


def _cfgs(name: str):
    kw = CONFIGS[name]
    return (jax_asr.JasperConfig(kw["n_mels"], kw["vocab_size"], tuple(
                jax_asr.JasperBlock(**b) for b in kw["blocks"])),
            asr.JasperConfig(kw["n_mels"], kw["vocab_size"], tuple(
                asr.JasperBlock(**b) for b in kw["blocks"])))


@functools.lru_cache(maxsize=None)
def _jasper_vars(name: str):
    task = jax_asr.JasperTask(_cfgs(name)[0], jnp.float32)
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0), FRAMES, B))
    params, state = _draw(shapes, 1)
    return params, state["batch_stats"]


@functools.lru_cache(maxsize=None)
def _asr_batch() -> dict:
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(B, FRAMES, N_MELS)).astype(np.float32)
    fpad = np.zeros((B, FRAMES), np.float32)
    for i, n in enumerate(FEAT_LENGTHS):
        fpad[i, n:] = 1.0
    labels = rng.integers(1, VOCAB, (B, LABELS)).astype(np.int32)
    lpad = np.zeros((B, LABELS), np.float32)
    for i, n in enumerate(LABEL_LENGTHS):
        lpad[i, n:] = 1.0
        labels[i, n:] = 0
    return {"feats": feats, "feat_paddings": fpad, "labels": labels,
            "label_paddings": lpad}


def _jasper_port(name: str, train: bool) -> asr.Jasper:
    params, stats = _jasper_vars(name)
    model = _load(asr.Jasper(_cfgs(name)[1], torch.float32),
                  jasper_state_dict_from_jax(params, stats))
    return model.train(train)


@functools.lru_cache(maxsize=None)
def _jasper_jax(name: str):
    """JAX's eval forward, training forward (with its new batch statistics)
    and loss with gradients, on ``_asr_batch()``."""
    task = jax_asr.JasperTask(_cfgs(name)[0], jnp.float32)
    params, stats = _jasper_vars(name)
    b = _asr_batch()

    def run(params, stats):
        v = {"params": params, "batch_stats": stats}
        ev = task.model.apply(v, b["feats"], train=False)
        tr, mut = task.model.apply(v, b["feats"], train=True,
                                   mutable=["batch_stats"])
        (loss, _), grads = jax.value_and_grad(
            lambda p: task.loss_fn(p, {"batch_stats": stats}, b,
                                   jax.random.key(0)), has_aux=True)(params)
        return ev, tr, mut["batch_stats"], loss, grads

    return jax.tree_util.tree_map(np.asarray, _jit(run)(params, stats))


@pytest.mark.parametrize("name,train", [("5x3", False), ("5x3", True),
                                        ("10x5dr", True), ("quartznet", True)])
def test_jasper_forward_and_bn_statistics_match_jax(name, train):
    ev, tr, new_stats, _, _ = _jasper_jax(name)
    model = _jasper_port(name, train)
    with torch.no_grad():
        got = model(torch.from_numpy(_asr_batch()["feats"])).numpy()
    want = tr if train else ev
    assert got.shape == want.shape == (B, FRAMES // 2, VOCAB)
    assert _rel(got, want) < LOGP_TOL
    if train:
        want_sd = jasper_state_dict_from_jax(_jasper_vars(name)[0], new_stats)
        stats = {k: v for k, v in want_sd.items() if ".running_" in k}
        got_sd = _sd_numpy(model)
        own, _ = _worst(got_sd, stats)
        assert own[0] < FTOL, own


@pytest.mark.parametrize("name", ["5x3", "10x5dr", "quartznet"])
def test_jasper_loss_and_gradients_match_jax(name):
    _, _, _, loss, grads = _jasper_jax(name)
    model = _jasper_port(name, True)
    task = asr.JasperTask(_cfgs(name)[1], torch.float32)
    got, _ = task.loss_fn(model, task.model_state(model), _tb(_asr_batch()),
                          torch.Generator())
    got.backward()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    own, top = _worst(_grads(model), jasper_state_dict_from_jax(grads))
    assert own[0] < JASPER_GTOL[0], own
    assert top[0] < JASPER_GTOL[1], top


@pytest.mark.parametrize("name", ["5x3", "10x5dr"])
def test_jasper_round_trips_through_convert_jasper(name):
    params, stats = _jasper_vars(name)
    model = _jasper_port(name, False)
    back_p, back_s = convert_jasper(_sd_numpy(model), _cfgs(name)[0].blocks)
    for got, want in ((back_p, params), (back_s, stats)):
        got, want = _flat(got), _flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jasper_offline_endpoint_matches_jaxs():
    """Ragged ``feat_len`` with garbage in the padded tail: the tokens and
    their counts equal JAX's recipe's on the same features."""
    name = "5x3"
    params, stats = _jasper_vars(name)
    jtask = jax_asr.JasperTask(_cfgs(name)[0], jnp.float32)
    kw = dict(max_frames=FRAMES, max_tokens=16, batch_buckets=(1, 2, 4))
    jax_ep = jax_recipes.jasper_offline_endpoint(
        jtask, params, {"batch_stats": stats}, **kw)
    ep = recipes.jasper_offline_endpoint(
        asr.JasperTask(_cfgs(name)[1], torch.float32),
        _jasper_port(name, True), **kw)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(4, FRAMES, N_MELS)).astype(np.float32) * 3
    lens = np.array([[64], [40], [17], [1]], np.int32)
    try:
        futures = [(ep.batcher.submit({"feats": f, "feat_len": n}),
                    jax_ep.batcher.submit({"feats": f, "feat_len": n}))
                   for f, n in zip(feats, lens)]
        n_tokens = []
        for mine, theirs in futures:
            a, b = mine.result(120), theirs.result(120)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["n_tokens"], b["n_tokens"])
            n_tokens.append(int(a["n_tokens"][0]))
        assert max(n_tokens) > 0
    finally:
        ep.batcher.close()
        jax_ep.batcher.close()


# -- wav2vec 2.0 -----------------------------------------------------------------------


W2V_MODES = {"base": {}, "large": dict(extractor_mode="layer_norm",
                                       layer_norm_first=True)}


@functools.lru_cache(maxsize=None)
def _w2v_params(mode: str = "base", ctc: bool = False):
    cfg = jax_w2v.Wav2Vec2Config(**W2V_KW, **W2V_MODES[mode])
    task = (jax_w2v.Wav2Vec2CtcTask(cfg, VOCAB, jnp.float32) if ctc else
            jax_w2v.Wav2Vec2Task(cfg, jnp.float32))
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0), AUDIO, B)[0])
    return _draw(shapes, 3)


@functools.lru_cache(maxsize=None)
def _w2v_batch() -> dict:
    rng = np.random.default_rng(4)
    t = jax_w2v.Wav2Vec2Task(jax_w2v.Wav2Vec2Config(**W2V_KW))._n_frames(AUDIO)
    labels = rng.integers(1, VOCAB, (B, LABELS)).astype(np.int32)
    lpad = np.zeros((B, LABELS), np.float32)
    fpad = np.zeros((B, t), np.float32)
    for i, (n, f) in enumerate(zip(LABEL_LENGTHS, (t, 30, 21))):
        lpad[i, n:] = 1.0
        labels[i, n:] = 0
        fpad[i, f:] = 1.0
    return {"audio": (0.1 * rng.normal(size=(B, AUDIO))).astype(np.float32),
            "mask": jax_w2v.sample_spans_mask(rng, B, t, 0.5, 2),
            "frame_paddings": fpad, "labels": labels, "label_paddings": lpad}


def _w2v_cfg(mode: str = "base") -> wav2vec2.Wav2Vec2Config:
    return wav2vec2.Wav2Vec2Config(**W2V_KW, **W2V_MODES[mode])


def _w2v_port(mode: str = "base") -> wav2vec2.Wav2Vec2:
    return _load(wav2vec2.Wav2Vec2(_w2v_cfg(mode), torch.float32),
                 wav2vec2_state_dict_from_jax(_w2v_params(mode)))


def _jax_draws(key, b, t):
    """What JAX's ``Wav2Vec2Task.loss_fn`` draws from ``key``."""
    cfg = jax_w2v.Wav2Vec2Config(**W2V_KW)
    _, r_quant, r_neg = jax.random.split(key, 3)
    u = jax.random.uniform(r_quant, (b, t, cfg.n_groups, cfg.n_entries),
                           minval=1e-6, maxval=1.0 - 1e-6)
    k = min(cfg.n_negatives, t - 1)
    neg = jax.random.randint(r_neg, (b, t, k), 0, t - 1)
    return {"uniform": torch.from_numpy(np.asarray(u)),
            "negatives": torch.from_numpy(np.asarray(neg)).long()}


@pytest.mark.parametrize("mode,noise", [("base", False), ("base", True),
                                        ("large", True)])
def test_wav2vec2_forward_matches_jax(mode, noise):
    """c, q and the perplexity: the plain argmax, or the Gumbel noise from
    JAX's uniforms; BASE's GroupNorm post-LN and the LARGE recipe's
    per-conv LayerNorm pre-LN."""
    cfg = jax_w2v.Wav2Vec2Config(**W2V_KW, **W2V_MODES[mode])
    model = jax_w2v.Wav2Vec2(cfg, jnp.float32)
    b = _w2v_batch()
    key = jax.random.key(5) if noise else None
    out = _jit(lambda p: model.apply(
        {"params": p}, b["audio"], b["mask"], rngs_quant=key,
        deterministic=key is None))(_w2v_params(mode))
    c, q, perp = (np.asarray(x) for x in out)
    uniform = None
    if noise:
        uniform = torch.from_numpy(np.asarray(jax.random.uniform(
            key, (B, c.shape[1], 2, 8), minval=1e-6, maxval=1.0 - 1e-6)))
    with torch.no_grad():
        got = _w2v_port(mode)(torch.from_numpy(b["audio"]),
                              torch.from_numpy(b["mask"]), uniform=uniform)
    for g, w in zip(got, (c, q, perp)):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < FTOL


@functools.lru_cache(maxsize=None)
def _w2v_jax_loss():
    task = jax_w2v.Wav2Vec2Task(jax_w2v.Wav2Vec2Config(**W2V_KW), jnp.float32)
    b = {k: _w2v_batch()[k] for k in ("audio", "mask")}
    f = jax.value_and_grad(lambda p: task.loss_fn(p, {}, b, jax.random.key(9)),
                           has_aux=True)
    return jax.tree_util.tree_map(np.asarray, _jit(f)(_w2v_params()))


def test_wav2vec2_loss_and_gradients_match_jax(monkeypatch):
    (loss, (_, metrics)), grads = _w2v_jax_loss()
    task = wav2vec2.Wav2Vec2Task(_w2v_cfg(), torch.float32)
    b = _w2v_batch()
    t = b["mask"].shape[1]
    monkeypatch.setattr(task, "draws", lambda g, bb, tt, dev: _jax_draws(
        jax.random.key(9), bb, tt))
    model = _w2v_port()
    got, (_, got_m) = task.loss_fn(model, {}, _tb({k: b[k] for k in
                                                   ("audio", "mask")}),
                                   torch.Generator())
    got.backward()
    assert t == 39
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    for k in ("contrastive", "diversity"):
        assert abs(float(got_m[k]) - float(metrics[k])) < LTOL * abs(
            float(metrics[k])), k
    own, top = _worst(_grads(model), wav2vec2_state_dict_from_jax(grads))
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top


def test_wav2vec2_ctc_loss_and_gradients_match_jax(monkeypatch):
    cfg = jax_w2v.Wav2Vec2Config(**W2V_KW)
    jtask = jax_w2v.Wav2Vec2CtcTask(cfg, VOCAB, jnp.float32)
    b = {k: v for k, v in _w2v_batch().items() if k != "mask"}
    key = jax.random.key(11)
    (loss, _), grads = jax.tree_util.tree_map(np.asarray, _jit(
        jax.value_and_grad(lambda p: jtask.loss_fn(p, {}, b, key),
                           has_aux=True))(_w2v_params("base", True)))
    r_mask, _ = jax.random.split(key)
    mask = np.asarray(jax.random.bernoulli(r_mask, jtask.mask_prob,
                                           b["frame_paddings"].shape))
    task = wav2vec2.Wav2Vec2CtcTask(_w2v_cfg(), VOCAB, torch.float32)
    monkeypatch.setattr(task, "draws", lambda *a: torch.from_numpy(mask))
    model = _load(wav2vec2.Wav2Vec2ForCTC(_w2v_cfg(), VOCAB, torch.float32),
                  wav2vec2_state_dict_from_jax(_w2v_params("base", True)))
    got, _ = task.loss_fn(model, {}, _tb(b), torch.Generator())
    got.backward()
    assert mask.any()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    own, top = _worst(_grads(model), wav2vec2_state_dict_from_jax(grads))
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top
    decoded = asr.greedy_ctc_decode(model(_tb(b)["audio"]).detach().numpy())
    assert len(decoded) == B


@pytest.mark.parametrize("mode", ["base", "large"])
def test_wav2vec2_round_trips_through_convert_wav2vec2(mode):
    params = _w2v_params(mode)
    cfg = _w2v_cfg(mode)
    back = convert_wav2vec2(_sd_numpy(_w2v_port(mode)), cfg.n_layers,
                            len(cfg.conv_layers), cfg.extractor_mode,
                            cfg.n_groups, cfg.n_entries)
    got, want = _flat(back), _flat(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_wav2vec2_draws_keep_their_distributions():
    """The port's own draws: Gumbel uniforms in [1e-6, 1 - 1e-6) with mean
    1/2, negatives uniform over the T - 1 other frames (never the positive
    after the shift), the CTC model's time mask at ``mask_prob``."""
    task = wav2vec2.Wav2Vec2Task(_w2v_cfg())
    g = torch.Generator().manual_seed(0)
    d = task.draws(g, 64, 39, "cpu")
    u = d["uniform"]
    assert u.shape == (64, 39, 2, 8)
    assert float(u.min()) >= 1e-6 and float(u.max()) < 1.0 - 1e-6
    assert abs(float(u.mean()) - 0.5) < 0.01
    neg = d["negatives"]
    assert neg.shape == (64, 39, 5) and int(neg.min()) == 0 and int(neg.max()) == 37
    counts = np.bincount(neg.flatten().numpy(), minlength=38) / neg.numel()
    assert np.abs(counts - 1 / 38).max() < 0.01
    shifted = torch.where(neg >= torch.arange(39)[None, :, None], neg + 1, neg)
    assert not (shifted == torch.arange(39)[None, :, None]).any()
    ctc = wav2vec2.Wav2Vec2CtcTask(_w2v_cfg())
    m = ctc.draws(g, 200, 500, "cpu")
    assert m.dtype == torch.bool and abs(float(m.float().mean()) - 0.05) < 0.005
    # a fresh draw each step
    assert not torch.equal(task.draws(g, 2, 39, "cpu")["uniform"],
                           task.draws(g, 2, 39, "cpu")["uniform"])


def test_wav2vec2_step_launches_k1_and_k2_once_per_layer(monkeypatch):
    """With the CUDA entry points standing in for the kernels (their plain
    versions, counted): K1 once and K2's two kernels once per layer, with
    no mask and no dropout."""
    seen = []

    def fwd(q, k, v, key_mask, causal, scale, layout, rate, seed, b_offset):
        fa.launches += 1
        seen.append((key_mask is None, rate, causal))
        return fa.mha_reference(q, k, v, key_mask, causal, scale,
                                layout=layout)

    def bwd(q, k, v, key_mask, out, lse, dout, causal, scale, layout, rate,
            seed, b_offset):
        fa.launches_bwd_dq += 1
        fa.launches_bwd_dkv += 1
        return fa.mha_backward_reference(q, k, v, key_mask, out, lse, dout,
                                         causal, scale, layout=layout)

    monkeypatch.setattr(fa, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(fa, "_flash_cuda", fwd)
    monkeypatch.setattr(fa, "_flash_bwd_cuda", bwd)
    for n in ("launches", "launches_bwd_dq", "launches_bwd_dkv"):
        monkeypatch.setattr(fa, n, 0)
    task = wav2vec2.Wav2Vec2Task(_w2v_cfg(), torch.float32)
    b = _tb({k: _w2v_batch()[k] for k in ("audio", "mask")})
    loss, _ = task.loss_fn(_w2v_port(), {}, b, torch.Generator())
    loss.backward()
    n = W2V_KW["n_layers"]
    assert (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv) == (n, n, n)
    assert set(seen) == {(True, 0.0, False)}


# -- full-width shapes -----------------------------------------------------------------


def _n_params(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", ["5x3", "10x5dr", "quartznet", "wav2vec2",
                                  "wav2vec2-ctc"])
def test_full_width_parameter_counts_match_jax(name):
    """The full configurations (JASPER_10x5DR's 330M parameters built on the
    meta device): the same number of parameters and BN statistics."""
    if name.startswith("wav2vec2"):
        ctc = name.endswith("ctc")
        jtask = (jax_w2v.Wav2Vec2CtcTask(dtype=jnp.float32) if ctc
                 else jax_w2v.Wav2Vec2Task(dtype=jnp.float32))
        params = jax.eval_shape(lambda: jtask.init(jax.random.key(0))[0])
        stats = {}
        with torch.device("meta"):
            model = (wav2vec2.Wav2Vec2ForCTC() if ctc else wav2vec2.Wav2Vec2())
    else:
        jcfg = {"5x3": jax_asr.JasperConfig(), "10x5dr": jax_asr.JASPER_10x5DR,
                "quartznet": jax_asr.QUARTZNET_15x5}[name]
        cfg = {"5x3": asr.JasperConfig(), "10x5dr": asr.JASPER_10x5DR,
               "quartznet": asr.QUARTZNET_15x5}[name]
        jtask = jax_asr.JasperTask(jcfg, jnp.float32)
        params, state = jax.eval_shape(lambda: jtask.init(jax.random.key(0)))
        stats = state["batch_stats"]
        with torch.device("meta"):
            model = asr.Jasper(cfg)
    assert sum(p.numel() for p in model.parameters()) == _n_params(params)
    assert sum(b.numel() for b in model.buffers()) == _n_params(stats)


# -- the commands ------------------------------------------------------------------------


@pytest.fixture
def small_asr(monkeypatch):
    """The commands' tasks at the small widths (Jasper's synthetic features
    keep the CLI's 64 mels and 256 frames; wav2vec2's audio its 16000
    samples)."""
    jcfg = _cfgs("5x3")[1]
    jasper_cls, w2v_cls = asr.JasperTask, wav2vec2.Wav2Vec2Task
    monkeypatch.setattr(asr, "JasperTask", lambda dtype: jasper_cls(
        dataclasses.replace(jcfg, n_mels=64), dtype))
    monkeypatch.setattr(wav2vec2, "Wav2Vec2Task", lambda dtype: w2v_cls(
        _w2v_cfg(), dtype))


def _losses(path) -> list[float]:
    rows = [json.loads(line.removeprefix("DLLL "))
            for line in path.read_text().splitlines() if line.strip()]
    return [r["data"]["train.loss"] for r in rows
            if "train.loss" in r.get("data", {})]


def test_cli_trains_jasper_on_the_cpu(tmp_path, small_asr):
    """8 bf16 steps over 4 repeated batches at ``--lr 1e-3``: finite and
    falling, the BN statistics carried in the state."""
    state, _ = cli(["jasper", "--batch-size", "2", "--steps-per-epoch", "4",
                    "--epochs", "2", "--lr", "1e-3", "--device", "cpu",
                    "--workspace", str(tmp_path)])
    assert state.step == 8 and state.model.dtype == torch.bfloat16
    assert any(".running_var" in k for k in state.model_state)
    losses = _losses(tmp_path / "jasper_raport.json")
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert (tmp_path / "jasper_ckpt").exists()


def test_cli_trains_wav2vec2_on_the_cpu(tmp_path, small_asr):
    state, _ = cli(["wav2vec2", "--batch-size", "2", "--steps-per-epoch", "2",
                    "--lr", "5e-4", "--device", "cpu", "--workspace",
                    str(tmp_path)])
    assert state.step == 2
    losses = _losses(tmp_path / "wav2vec2_raport.json")
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_cli_synthetic_batches_are_jaxs():
    """The synthetic batches (and the rates) of JAX's ``_breadth_spec``:
    the same numpy draws from the same seed."""
    for name in ("jasper", "wav2vec2"):
        jcfg = jax_cli.CommonConfig(batch_size=2, lr=1e-3)
        pcfg = cli_main.CommonConfig(batch_size=2, lr=1e-3, device="cpu")
        _, _, jax_batch, _ = jax_cli._breadth_spec(name, jcfg)
        _, _, port_batch, _ = cli_main._breadth_spec(name, pcfg)
        for _ in range(2):
            want, got = jax_batch(), port_batch()
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("command,default", [("jasper", 1e-3),
                                             ("wav2vec2", 5e-4)])
def test_cli_rate_never_falls_back_from_common_config(tmp_path, small_asr,
                                                      monkeypatch, command,
                                                      default):
    """``cfg.lr or <default>`` with ``CommonConfig.lr = 0.1``: without
    ``--lr`` the rate is 0.1, as in JAX; wav2vec2's AdamW decays at 0.01."""
    rates = []
    fn = "adamw" if command == "wav2vec2" else "adam"
    orig = getattr(opt, fn)
    monkeypatch.setattr(opt, fn, lambda lr, *a, **k: rates.append(
        (lr, k.get("weight_decay"))) or orig(lr, *a, **k))
    cli([command, "--batch-size", "2", "--steps-per-epoch", "1", "--device",
         "cpu", "--workspace", str(tmp_path)])
    want = (0.1, 0.01) if command == "wav2vec2" else (0.1, None)
    assert rates == [want] and default not in rates[0]
