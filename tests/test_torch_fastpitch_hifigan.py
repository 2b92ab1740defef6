"""Port parity: FastPitch, HiFi-GAN (generator, discriminators and the
alternating GAN steps), the FastPitch -> HiFi-GAN endpoint and the
``fastpitch`` and ``hifigan`` commands, in torch against the JAX package.

The models run at small widths (FastPitch 2 + 2 blocks, d 32, one head of
16, text 8, mel 40; HiFi-GAN x4 x2 upsampling from 16 channels, two
periods, two scales, JAX's configurable discriminator widths), the JAX side
in fp32 at "highest" precision, its Pallas attention in interpret mode,
jitted once per function and shared by the tests; the port in fp32 on one
thread. JAX's parameters are drawn in numpy for its own shapes and carried
into the port by the bridge, which also carries JAX's gradients across.

Hidden dropout is 0 on both sides (its bits cannot match ``jax.random``);
FastPitch's attention dropout stays at 0.1, its four per-block seeds taken
from one list on both sides (JAX's ``FastPitch._seed`` and the port's
``attention_seed`` replaced inside the tests), so K1's hash drops the same
probabilities.

Tolerances, relative to the largest entry of the JAX tensor: outputs 1e-5
(the mel 2e-5: it sums 2 blocks of 48-wide convolutions); losses 1e-5
relative; every gradient within 1e-4 of its own largest entry and 1e-5 of
the largest entry of all; ``length_regulate``, ``average_over_durations``,
the durations of ``infer`` and the round trips through JAX's converters bit
for bit; three alternating GAN steps under Adam 1e-4 relative on the
parameters (an Adam step moves an entry by about lr whatever its gradient,
so a rounding-level gradient difference stays at rounding level).
"""

import functools
import itertools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.models.tts import fastpitch as jax_fp
from deeplearningexamples_tpu.models.tts import hifigan as jax_hifi
from deeplearningexamples_tpu.serving import recipes as jax_recipes
from deeplearningexamples_tpu.utils.torch_import import (
    convert_fastpitch,
    convert_hifigan_generator,
)
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.models import tts
from deeplearningexamples_tpu_torch.models.tts import fastpitch, hifigan
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.serving import recipes
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    fastpitch_state_dict_from_jax,
    hifigan_discriminators_state_dict_from_jax,
    hifigan_generator_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

FTOL = 1e-5
MEL_TOL = 2e-5
LTOL = 1e-5
GTOL = (1e-4, 1e-5)
STEP_TOL = 1e-4

FP_KW = dict(n_symbols=32, d_model=32, n_heads=1, head_dim=16,
             encoder_layers=2, decoder_layers=2, conv_filters=48, n_mels=8,
             max_mel_len=40, predictor_filters=16, dropout=0.0,
             predictor_dropout=0.0, dropatt=0.1)
HIFI_KW = dict(n_mels=8, upsample_rates=(4, 2), upsample_kernels=(8, 4),
               upsample_initial_channel=16, resblock_kernels=(3, 5),
               resblock_dilations=((1, 3), (1, 2)), periods=(2, 3),
               segment_length=640, hop_length=8, mpd_channels=(4, 8, 8),
               msd_channels=(4, 8, 16, 16), msd_scales=2)
SEEDS = (123456789, -987654321, 5, -2**31)  # enc 0, enc 1, dec 0, dec 1
B, T, L = 3, 8, 40
TEXT_LENGTHS = (8, 5, 3)


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
    top = max(float(np.abs(w).max()) for w in want.values())
    return (max((_rel(got[n], w), n) for n, w in want.items()),
            max((float(np.abs(np.asarray(got[n], np.float64) - w).max()) / top,
                 n) for n, w in want.items()))


def _draw(shapes, seed: int):
    """Parameters of the JAX model's shapes, drawn in numpy: LayerNorm
    scales 1 + 0.2 N(0, 1), biases 0.1 N(0, 1), every other leaf N(0, 1 /
    fan_in) (the embedding N(0, 1))."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name == "scale":
            out = 1.0 + 0.2 * rng.normal(size=x.shape)
        elif name == "bias":
            out = 0.1 * rng.normal(size=x.shape)
        elif name == "embedding":
            out = rng.normal(size=x.shape)
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


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- FastPitch: the shared JAX side ------------------------------------------


def _jax_seeds():
    """JAX's ``FastPitch._seed`` giving ``SEEDS`` in order, inside a
    ``with``."""
    it = itertools.cycle(SEEDS)
    return mock.patch.object(
        jax_fp.FastPitch, "_seed",
        lambda self, det: None if det else jnp.int32(next(it)))


def _port_seeds():
    it = itertools.cycle(SEEDS)
    return mock.patch.object(fastpitch, "attention_seed",
                             lambda generator: next(it))


@functools.lru_cache(maxsize=None)
def _fp_params():
    task = jax_fp.FastPitchTask(jax_fp.FastPitchConfig(**FP_KW), jnp.float32)
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0), T, B)[0])
    return _draw(shapes, 1)


@functools.lru_cache(maxsize=None)
def _fp_batch() -> dict:
    rng = np.random.default_rng(2)
    text = rng.integers(1, 32, (B, T)).astype(np.int32)
    dur = rng.integers(0, 7, (B, T)).astype(np.int32)
    for i, n in enumerate(TEXT_LENGTHS):
        text[i, n:] = 0
        dur[i, n:] = 0
    dur[0, 0] = 30  # row 0's total passes L: its tail is cut
    mel = rng.normal(size=(B, L, 8)).astype(np.float32)
    mel[:, ::7] = 0.0  # frames of zero energy, skipped by the average
    return {"text": text, "durations": dur,
            "pitch": rng.normal(size=(B, T)).astype(np.float32), "mel": mel}


def _fp_port(dtype=torch.float32) -> fastpitch.FastPitch:
    model = fastpitch.FastPitch(fastpitch.FastPitchConfig(**FP_KW), dtype)
    return _load(model, fastpitch_state_dict_from_jax(_fp_params()))


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _fp_jax_forward():
    """JAX's deterministic and dropout forwards on ``_fp_batch()``."""
    task = jax_fp.FastPitchTask(jax_fp.FastPitchConfig(**FP_KW), jnp.float32)
    b = _fp_batch()

    def both(params):
        args = (b["text"], b["durations"], b["pitch"])
        ev = task.model.apply({"params": params}, *args, max_mel_len=L)
        tr = task.model.apply({"params": params}, *args, max_mel_len=L,
                              deterministic=False,
                              rngs={"dropout": jax.random.key(0)})
        return ev, tr

    with _jax_seeds():
        out = _jit(both)(_fp_params())
    return jax.tree_util.tree_map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _fp_jax_loss_grad():
    task = jax_fp.FastPitchTask(jax_fp.FastPitchConfig(**FP_KW), jnp.float32)

    def f(params, batch):
        return task.loss_fn(params, {}, batch, jax.random.key(0))

    with _jax_seeds():
        out = _jit(jax.value_and_grad(f, has_aux=True))(_fp_params(),
                                                           _fp_batch())
    return jax.tree_util.tree_map(np.asarray, out)


# -- FastPitch -----------------------------------------------------------------


def test_length_regulate_and_average_over_durations_match_jax():
    b = _fp_batch()
    x = np.random.default_rng(3).normal(size=(B, T, 5)).astype(np.float32)
    want, want_mask = jax_fp.length_regulate(jnp.asarray(x),
                                             jnp.asarray(b["durations"]), L)
    got, got_mask = fastpitch.length_regulate(
        torch.from_numpy(x), torch.from_numpy(b["durations"]), L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    energy = np.linalg.norm(b["mel"], axis=-1)
    want = jax_fp.average_over_durations(jnp.asarray(energy),
                                         jnp.asarray(b["durations"]))
    got = fastpitch.average_over_durations(torch.from_numpy(energy),
                                           torch.from_numpy(b["durations"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got.numpy()[b["durations"] == 0] == 0).all()


def test_positional_table_is_jaxs_and_not_interleaved():
    want = jax_fp._positional(2048, 32)
    got = fastpitch.FastPitch(fastpitch.FastPitchConfig(**FP_KW)).pos.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :16], np.sin(np.arange(2048)[:, None]
                                  / 10000 ** (np.arange(0, 32, 2) / 32)
                                  ).astype(np.float32))


@pytest.mark.parametrize("mode", ["deterministic", "dropatt"])
def test_fastpitch_forward_matches_jax(mode):
    ev, tr = _fp_jax_forward()
    want = ev if mode == "deterministic" else tr
    b = _tb(_fp_batch())
    gen = None if mode == "deterministic" else torch.Generator()
    with _port_seeds(), torch.no_grad():
        got = _fp_port()(b["text"], b["durations"], b["pitch"], max_mel_len=L,
                         generator=gen)
    mel, log_dur, pitch, energy, mask = (t.numpy() for t in got)
    assert _rel(mel, want[0]) < MEL_TOL
    for g, w in ((log_dur, want[1]), (pitch, want[2]), (energy, want[3])):
        assert _rel(g, w) < FTOL
    np.testing.assert_array_equal(mask, want[4])
    if mode == "dropatt":  # the dropout moved the mel
        assert _rel(ev[0], tr[0]) > 1e-3


def test_fastpitch_loss_and_gradients_match_jax():
    (loss, (_, metrics)), grads = _fp_jax_loss_grad()
    model = _fp_port()
    task = fastpitch.FastPitchTask(fastpitch.FastPitchConfig(**FP_KW),
                                   torch.float32)
    with _port_seeds():
        got, (_, got_m) = task.loss_fn(model, {}, _tb(_fp_batch()),
                                       torch.Generator())
    got.backward()
    assert abs(got.item() - float(loss)) < LTOL * abs(float(loss))
    for k in ("mel_loss", "dur_loss", "energy_loss"):
        assert abs(float(got_m[k]) - float(metrics[k])) < LTOL * abs(
            float(metrics[k])), k
    own, top = _worst(_grads(model), fastpitch_state_dict_from_jax(grads))
    assert own[0] < GTOL[0], own
    assert top[0] < GTOL[1], top


@pytest.mark.parametrize("dur_bias", [None, 2.5], ids=["drawn", "saturating"])
def test_fastpitch_infer_matches_jax(dur_bias):
    """``infer`` at pace 0.8; with the duration head's bias at 2.5 (about 11
    frames a symbol) rows pass ``max_mel_len`` and ``mel_len`` saturates."""
    params = _fp_params()
    if dur_bias is not None:
        params = jax.tree_util.tree_map(lambda x: x, params)
        params["duration_predictor"]["fc"]["bias"] = np.full((1,), dur_bias,
                                                             np.float32)
    task = jax_fp.FastPitchTask(jax_fp.FastPitchConfig(**FP_KW), jnp.float32)
    text = _fp_batch()["text"]
    mel, mel_len = _jit(lambda p, t: task.model.apply(
        {"params": p}, t, pace=0.8, method=task.model.infer))(params, text)
    model = _load(fastpitch.FastPitch(fastpitch.FastPitchConfig(**FP_KW),
                                      torch.float32),
                  fastpitch_state_dict_from_jax(params))
    got_mel, got_len = model.infer(torch.from_numpy(text), pace=0.8)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(mel_len))
    assert _rel(got_mel.numpy(), mel) < MEL_TOL
    if dur_bias is not None:
        assert (got_len.numpy() == FP_KW["max_mel_len"]).any()
        assert (got_len.numpy() < FP_KW["max_mel_len"]).any()


def test_fastpitch_round_trips_through_convert_fastpitch():
    params = _fp_params()
    sd = fastpitch_state_dict_from_jax(params)
    model = _load(fastpitch.FastPitch(fastpitch.FastPitchConfig(**FP_KW)), sd)
    back = convert_fastpitch(_sd_numpy(model), 2, 2)
    _assert_same_tree(back, params)


def test_fastpitch_dropout_seeds_are_int32_and_fresh_per_block():
    g = torch.Generator().manual_seed(0)
    seeds = [fastpitch.attention_seed(g) for _ in range(2000)]
    assert min(seeds) >= -2**31 and max(seeds) < 2**31 - 1
    assert len(set(seeds)) == len(seeds)
    assert abs(np.mean(seeds) / 2**31) < 0.1  # centred on 0, as JAX's
    calls = []
    with mock.patch.object(fastpitch, "attention_seed",
                           lambda gen: calls.append(1) or 7):
        _fp_port()(*(_tb(_fp_batch())[k] for k in ("text", "durations",
                                                   "pitch")),
                   max_mel_len=L, generator=torch.Generator())
    assert len(calls) == FP_KW["encoder_layers"] + FP_KW["decoder_layers"]


# -- HiFi-GAN: the shared JAX side -------------------------------------------


@functools.lru_cache(maxsize=None)
def _hifi_params():
    task = jax_hifi.HiFiGanTask(jax_hifi.HiFiGanConfig(**HIFI_KW), jnp.float32)
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0)))
    return _draw(shapes[0], 3), _draw(shapes[1], 4)


@functools.lru_cache(maxsize=None)
def _hifi_batch() -> dict:
    rng = np.random.default_rng(5)
    return {"mel": rng.normal(size=(2, 80, 8)).astype(np.float32),
            "audio": (0.3 * rng.normal(size=(2, 640))).astype(np.float32)}


def _hifi_port():
    g, d = _hifi_params()
    cfg = hifigan.HiFiGanConfig(**HIFI_KW)
    gen = _load(hifigan.HiFiGanGenerator(cfg, torch.float32),
                hifigan_generator_state_dict_from_jax(g))
    disc = _load(hifigan.HiFiGanDiscriminators(cfg, torch.float32),
                 hifigan_discriminators_state_dict_from_jax(d))
    return gen, disc


# -- HiFi-GAN --------------------------------------------------------------------


def test_generator_output_length_and_values_match_jax():
    g, _ = _hifi_params()
    task = jax_hifi.HiFiGanTask(jax_hifi.HiFiGanConfig(**HIFI_KW), jnp.float32)
    mel = _hifi_batch()["mel"][:, :13]  # an odd length
    want = np.asarray(_jit(lambda p, m: task.gen.apply({"params": p}, m))(
        g, mel))
    gen, _ = _hifi_port()
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 13 * 8)
    assert _rel(got, want) < FTOL


@pytest.mark.parametrize("t", [640, 634], ids=["segment", "ragged"])
def test_discriminators_match_jax(t):
    _, d = _hifi_params()
    task = jax_hifi.HiFiGanTask(jax_hifi.HiFiGanConfig(**HIFI_KW), jnp.float32)
    audio = _hifi_batch()["audio"][:, :t]
    scores, feats = jax.tree_util.tree_map(np.asarray, _jit(
        lambda p, a: task.disc.apply({"params": p}, a))(d, audio))
    _, disc = _hifi_port()
    with torch.no_grad():
        got_s, got_f = disc(torch.from_numpy(audio))
    assert len(got_s) == len(scores) == 4
    for gs, ws in zip(got_s, scores):
        assert gs.shape == ws.shape
        assert _rel(gs.numpy(), ws) < FTOL
    for gfs, wfs in zip(got_f, feats):
        for gf, wf in zip(gfs, wfs):
            # NCHW / NCW against NHWC / NWC
            gf = gf.numpy()
            gf = gf.transpose(0, 2, 3, 1) if gf.ndim == 4 else gf.transpose(0, 2, 1)
            assert gf.shape == wf.shape
            assert _rel(gf, wf) < FTOL


def test_mel_matches_jax():
    task = jax_hifi.HiFiGanTask(jax_hifi.HiFiGanConfig(**HIFI_KW), jnp.float32)
    audio = _hifi_batch()["audio"]
    want = np.asarray(_jit(task._mel)(audio))
    got = hifigan.HiFiGanTask(hifigan.HiFiGanConfig(**HIFI_KW),
                              torch.float32).mel(torch.from_numpy(audio))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_d_step_and_g_step_alternate_like_jax():
    """Three ``d_step``, ``g_step`` pairs under Adam (b1 0.8, b2 0.99): the
    losses and every parameter after them."""
    cfg = HIFI_KW
    jtask = jax_hifi.HiFiGanTask(jax_hifi.HiFiGanConfig(**cfg), jnp.float32)
    g_tx = optax.adam(1e-3, b1=0.8, b2=0.99)
    d_tx = optax.adam(1e-3, b1=0.8, b2=0.99)
    g, d = _hifi_params()
    g_opt, d_opt = g_tx.init(g), d_tx.init(d)
    g_step, d_step = jtask.make_steps(g_tx, d_tx)
    batch = _hifi_batch()
    want = []
    for _ in range(3):
        d, d_opt, dl = d_step(d, d_opt, g, batch)
        g, g_opt, gl, aux = g_step(g, g_opt, d, batch)
        want.append((float(dl), float(gl), float(aux["mel_l1"])))

    task = hifigan.HiFiGanTask(hifigan.HiFiGanConfig(**cfg), torch.float32)
    gen, disc = _hifi_port()
    pg_tx = opt.adam(1e-3, b1=0.8, b2=0.99)
    pd_tx = opt.adam(1e-3, b1=0.8, b2=0.99)
    pg_opt = pg_tx.init(dict(gen.named_parameters()))
    pd_opt = pd_tx.init(dict(disc.named_parameters()))
    pg_step, pd_step = task.make_steps(pg_tx, pd_tx)
    tb = _tb(batch)
    for wd, wg, wm in want:
        pd_opt, dl = pd_step(disc, pd_opt, gen, tb)
        pg_opt, gl, aux = pg_step(gen, pg_opt, disc, tb)
        for got_v, want_v in ((dl, wd), (gl, wg), (aux["mel_l1"], wm)):
            assert abs(float(got_v) - want_v) < LTOL * 10 * abs(want_v)
    for port, tree, conv in ((gen, g, hifigan_generator_state_dict_from_jax),
                             (disc, d, hifigan_discriminators_state_dict_from_jax)):
        own, _ = _worst(_sd_numpy(port), conv(jax.tree_util.tree_map(
            np.asarray, tree)))
        assert own[0] < STEP_TOL, own


def test_generator_round_trips_through_convert_hifigan_generator():
    g, _ = _hifi_params()
    gen, _ = _hifi_port()
    back = convert_hifigan_generator(_sd_numpy(gen), 2, 2, 2)
    _assert_same_tree(back, g)


# -- full-width shapes -----------------------------------------------------------


def _n_params(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


def test_full_width_parameter_counts_match_jax():
    with torch.device("meta"):
        fp = fastpitch.FastPitch()
        gen = hifigan.HiFiGanGenerator()
        disc = hifigan.HiFiGanDiscriminators()
    jfp = jax_fp.FastPitchTask(dtype=jnp.float32)
    jfp_params = jax.eval_shape(lambda: jfp.init(jax.random.key(0))[0])
    jh = jax_hifi.HiFiGanTask(dtype=jnp.float32)
    jg, jd = jax.eval_shape(lambda: jh.init(jax.random.key(0)))
    for model, tree in ((fp, jfp_params), (gen, jg), (disc, jd)):
        assert sum(p.numel() for p in model.parameters()) == _n_params(tree)


# -- the endpoint ---------------------------------------------------------------------


def test_fastpitch_hifigan_endpoint_matches_jaxs():
    fp_task = jax_fp.FastPitchTask(jax_fp.FastPitchConfig(**FP_KW), jnp.float32)
    hf_task = jax_hifi.HiFiGanTask(jax_hifi.HiFiGanConfig(**HIFI_KW),
                                   jnp.float32)
    g, _ = _hifi_params()
    kw = dict(max_text_len=T, max_mel_len=24, batch_buckets=(1, 2, 4))
    jax_ep = jax_recipes.fastpitch_hifigan_endpoint(fp_task, _fp_params(),
                                                    hf_task, g, **kw)
    gen, _ = _hifi_port()
    ep = recipes.fastpitch_hifigan_endpoint(
        fastpitch.FastPitchTask(fastpitch.FastPitchConfig(**FP_KW)),
        _fp_port(), hifigan.HiFiGanTask(hifigan.HiFiGanConfig(**HIFI_KW)),
        gen, **kw)
    try:
        futures = [(ep.batcher.submit({"text": t}),
                    jax_ep.batcher.submit({"text": t}))
                   for t in _fp_batch()["text"]]
        for mine, theirs in futures:
            a, b = mine.result(120), theirs.result(120)
            assert a["audio"].shape == (24 * 8,)
            np.testing.assert_array_equal(a["mel_len"], b["mel_len"])
            np.testing.assert_array_equal(a["audio_len"], a["mel_len"] * 8)
            assert _rel(a["audio"], b["audio"]) < MEL_TOL
    finally:
        ep.batcher.close()
        jax_ep.batcher.close()


@pytest.mark.parametrize("bad", [dict(n_mels=16), dict(hop_length=16)])
def test_fastpitch_hifigan_endpoint_checks_mels_and_hop(bad):
    hcfg = hifigan.HiFiGanConfig(**{**HIFI_KW, **bad})
    with pytest.raises(ValueError):
        recipes.fastpitch_hifigan_endpoint(
            fastpitch.FastPitchTask(fastpitch.FastPitchConfig(**FP_KW)),
            None, hifigan.HiFiGanTask(hcfg), None)


# -- the kernels on the path ------------------------------------------------------


def test_fastpitch_step_launches_k1_and_k2_once_per_block(monkeypatch):
    """With the CUDA entry points standing in for the kernels (their plain
    versions, counted), a training step launches K1 once and K2's two
    kernels once per block, and ``infer`` K1 once per block; bshd, the key
    mask and dropout reach them."""
    seen = []

    def fwd(q, k, v, key_mask, causal, scale, layout, rate, seed, b_offset):
        fa.launches += 1
        seen.append((layout, key_mask is not None, rate))
        return fa.mha_reference(q, k, v, key_mask, causal, scale, layout=layout,
                                dropout_rate=rate, dropout_seed=seed)

    def bwd(q, k, v, key_mask, out, lse, dout, causal, scale, layout, rate,
            seed, b_offset):
        fa.launches_bwd_dq += 1
        fa.launches_bwd_dkv += 1
        return fa.mha_backward_reference(q, k, v, key_mask, out, lse, dout,
                                         causal, scale, layout=layout,
                                         dropout_rate=rate, dropout_seed=seed)

    monkeypatch.setattr(fa, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(fa, "_flash_cuda", fwd)
    monkeypatch.setattr(fa, "_flash_bwd_cuda", bwd)
    for n in ("launches", "launches_bwd_dq", "launches_bwd_dkv"):
        monkeypatch.setattr(fa, n, 0)
    task = fastpitch.FastPitchTask(fastpitch.FastPitchConfig(**FP_KW),
                                   torch.float32)
    loss, _ = task.loss_fn(_fp_port(), {}, _tb(_fp_batch()), torch.Generator())
    loss.backward()
    blocks = FP_KW["encoder_layers"] + FP_KW["decoder_layers"]
    assert (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv) == (
        blocks, blocks, blocks)
    assert set(seen) == {("bshd", True, 0.1)}
    _fp_port().infer(torch.from_numpy(_fp_batch()["text"]))
    assert fa.launches == 2 * blocks


# -- the commands ---------------------------------------------------------------------


@pytest.fixture
def small_speech(monkeypatch):
    """The commands' tasks at the small widths (the synthetic mel is the
    config's ``max_mel_len`` frames, 40 here)."""
    fp_cls, hifi_cls = tts.FastPitchTask, tts.HiFiGanTask
    monkeypatch.setattr(tts, "FastPitchTask", lambda dtype: fp_cls(
        fastpitch.FastPitchConfig(**FP_KW), dtype))
    monkeypatch.setattr(tts, "HiFiGanTask", lambda dtype: hifi_cls(
        hifigan.HiFiGanConfig(**HIFI_KW), dtype))


def _losses(path) -> list[float]:
    rows = [json.loads(line.removeprefix("DLLL "))
            for line in path.read_text().splitlines() if line.strip()]
    return [r["data"]["train.loss"] for r in rows
            if "train.loss" in r.get("data", {})]


def test_cli_trains_fastpitch_on_the_cpu(tmp_path, small_speech):
    """8 bf16 steps over 4 repeated batches at ``--lr 1e-3``: the loss is
    finite and falls."""
    state, _ = cli(["fastpitch", "--batch-size", "2", "--steps-per-epoch", "4",
                    "--epochs", "2", "--lr", "1e-3", "--device", "cpu",
                    "--workspace", str(tmp_path)])
    assert state.step == 8 and state.model.dtype == torch.bfloat16
    losses = _losses(tmp_path / "fastpitch_raport.json")
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_cli_trains_hifigan_on_the_cpu(tmp_path, small_speech):
    gen, disc, out = cli(["hifigan", "--batch-size", "2", "--steps-per-epoch",
                          "2", "--epochs", "2", "--lr", "2e-4", "--device",
                          "cpu", "--workspace", str(tmp_path)])
    assert set(out) == {"train.d_loss", "train.g_loss", "train.mel_l1"}
    assert all(np.isfinite(v) for v in out.values())
    assert next(gen.parameters()).device.type == "cpu"


@pytest.mark.parametrize("command,default", [("fastpitch", 1e-3),
                                             ("hifigan", 2e-4)])
def test_cli_rate_never_falls_back_from_common_config(tmp_path, small_speech,
                                                      monkeypatch, command,
                                                      default):
    """``cfg.lr or <default>`` with ``CommonConfig.lr = 0.1``: without
    ``--lr`` the rate is 0.1 in the port, as in JAX; the default is never
    reached."""
    assert jax_cli.CommonConfig().lr == cli_main.CommonConfig().lr == 0.1
    rates = []
    adam = opt.adam
    monkeypatch.setattr(opt, "adam", lambda lr, *a, **k: rates.append(lr)
                        or adam(lr, *a, **k))
    cli([command, "--batch-size", "2", "--steps-per-epoch", "1", "--device",
         "cpu", "--workspace", str(tmp_path)])
    assert rates and set(rates) == {0.1} and default not in rates
