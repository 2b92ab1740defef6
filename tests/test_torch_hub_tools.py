"""Port parity: the model repository (``serving/export.py``), the checkpoint
tools (``utils/checkpoint_tools.py``), ``utils/profiling.py`` and the hub
(``hub.py``), in torch against the JAX package.

- The repository round-trips a ``state_dict`` bit for bit and loads it
  strictly; its ``config.json`` is JAX's, key for key, for the same
  arguments. ``strip_checkpoint`` (with and without EMA) keeps the chosen
  parameters and the BN statistics, drops the optimizer, and writes JAX's
  ``config.json`` for the same step and flag.
- ``classify_image`` on a fixture JPEG through each package's host data
  plane, a small ResNet (JAX's variables drawn in numpy, carried across by
  the bridge): the same top-k labels, probabilities within 1e-5.
- ``StepTimer`` on the same clock readings: JAX's summary exactly.
- ``hub.list_models()`` is JAX's. For resnet50, gpunet-0, fastpitch, hifigan
  and tft one reference-named ``.pth`` (the port's seeded ``state_dict``;
  ResNet-50's with torch BN's ``num_batches_tracked`` counters, GPUNet's
  under the reference's ``network.{child}`` names) goes through both
  packages' ``hub.load`` (JAX's converters), and the forwards agree within
  1e-5 of the largest entry (ResNet-50 and GPUNet-0 at full width, 1e-4:
  50 and 60 fp32 layers of random weights). A model repository loads back
  through ``hub.load`` bit for bit.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearningexamples_tpu import hub as jax_hub
from deeplearningexamples_tpu.core.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from deeplearningexamples_tpu.core.train import create_train_state as jax_state
from deeplearningexamples_tpu.models import convnets as jax_convnets
from deeplearningexamples_tpu.models import tft as jax_tft
from deeplearningexamples_tpu.models.tts import (
    FastPitchConfig as JaxFastPitchConfig,
)
from deeplearningexamples_tpu.models.tts import HiFiGanConfig as JaxHiFiGanConfig
from deeplearningexamples_tpu.serving import (
    save_model_repository as jax_save_repository,
)
from deeplearningexamples_tpu.utils import checkpoint_tools as jax_tools
from deeplearningexamples_tpu.utils import profiling as jax_profiling
from deeplearningexamples_tpu_torch import hub
from deeplearningexamples_tpu_torch.core import optimizers as opt
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager
from deeplearningexamples_tpu_torch.core.train import create_train_state
from deeplearningexamples_tpu_torch.models import asr, convnets, ncf, tft
from deeplearningexamples_tpu_torch.models.tts import (FastPitchConfig,
                                                       HiFiGanConfig)
from deeplearningexamples_tpu_torch.serving import (load_model_repository,
                                                    save_model_repository)
from deeplearningexamples_tpu_torch.utils import checkpoint_tools, profiling
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    resnet_state_dict_from_jax,
)
from torch_parity import draw, jit, load, rel
from torch_threads import torch_one_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent / "data" / "jpeg" / \
    "landscape_256x192.jpg"
SPEC = {"x": ((4,), "float32"), "ids": ((2, 3), "int32")}
NCF_KW = dict(nb_users=20, nb_items=30, mf_dim=4, mlp_layer_sizes=(8, 4),
              dropout=0.0)


def _ncf(seed: int) -> ncf.NeuMF:
    return hub.create("ncf", seed=seed, device="cpu",
                      cfg=ncf.NcfConfig(**NCF_KW), dtype=torch.float32)


def _config(path) -> dict:
    return json.loads(Path(path, "config.json").read_text())


# -- the model repository and the checkpoint tools ---------------------------


def test_model_repository_round_trip_and_jaxs_config(tmp_path):
    model = _ncf(1)
    kw = dict(input_spec=SPEC, output_names=("y",), batch_buckets=(1, 4),
              precision="fp32", metadata={"step": 3})
    got = save_model_repository(str(tmp_path / "port"), "ncf",
                                model.state_dict(), **kw)
    want = jax_save_repository(str(tmp_path / "jax"), "ncf",
                               {"w": np.zeros(2, np.float32)}, **kw)
    assert _config(got) == _config(want)
    other = _ncf(2)
    sd, config = load_model_repository(str(tmp_path / "port"), "ncf", other)
    assert config == _config(got)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v) and torch.equal(other.state_dict()[k], v)
    with pytest.raises(RuntimeError):  # strict: a model of other shapes
        load_model_repository(str(tmp_path / "port"), "ncf", hub.create(
            "ncf", device="cpu", cfg=ncf.NcfConfig(**{**NCF_KW, "mf_dim": 8})))


def _jasper() -> tuple[asr.JasperTask, asr.Jasper]:
    cfg = asr.JasperConfig(n_mels=8, vocab_size=5, blocks=(
        asr.JasperBlock(1, 8, 3, 0.0, residual=False),))
    task = asr.JasperTask(cfg, torch.float32)
    return task, task.init(torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("use_ema", [True, False])
def test_strip_checkpoint_keeps_weights_and_statistics(tmp_path, use_ema):
    """A Jasper block (BN buffers in the model state) at step 7: the
    repository holds the EMA or the live parameters and the statistics, no
    optimizer state, and JAX's ``config.json`` for the same step and flag."""
    task, model = _jasper()
    state = create_train_state(model, opt.sgd(0.1, 0.9), 0,
                               model_state=task.model_state(model), ema=True)
    with torch.no_grad():
        for n, p in state.params.items():
            state.ema_params[n].copy_(p + 1.0)
        for b in state.model_state.values():
            b.fill_(0.5)
    state.step = 7
    CheckpointManager(str(tmp_path / "ckpt")).save(7, state)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    if use_ema:
        want.update({n: p.clone() for n, p in state.ema_params.items()})

    _, fresh = _jasper()  # the template: other weights, restored in place
    template = create_train_state(fresh, opt.sgd(0.1, 0.9), 1,
                                  model_state=task.model_state(fresh),
                                  ema=True)
    spec = {"feats": ((16, 8), "float32")}
    out = checkpoint_tools.strip_checkpoint(
        str(tmp_path / "ckpt"), template, str(tmp_path / "repo"), "jasper",
        spec, use_ema=use_ema)
    _, served = _jasper()
    sd, config = load_model_repository(str(tmp_path / "repo"), "jasper",
                                       served)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    assert any(".running_mean" in k and (v == 0.5).all() for k, v in
               sd.items())

    jstate = jax_state({"w": jnp.arange(4.0)}, optax.sgd(0.1), jax.random.key(0),
                       {"batch_stats": {"m": jnp.ones(2)}}, ema=True)
    jstate = jstate.replace(step=jnp.asarray(7, jnp.int32))
    JaxCheckpointManager(str(tmp_path / "jckpt")).save(7, jstate)
    jout = jax_tools.strip_checkpoint(
        str(tmp_path / "jckpt"), jstate, str(tmp_path / "jrepo"), "jasper",
        spec, use_ema=use_ema)
    assert config == _config(out) == _config(jout)
    assert config["metadata"] == {"step": 7, "ema": use_ema}


def test_classify_image_matches_jax():
    arch = dict(layers=(1, 1, 1, 1), widths=(8, 8, 8, 8))
    jmodel = jax_convnets.ResNet(jax_convnets.ResNetArch(**arch),
                                 num_classes=5, dtype=jnp.float32)
    v = draw(jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)), 3)
    model = load(convnets.ResNet(convnets.ResNetArch(**arch), 5,
                                 torch.float32),
                 resnet_state_dict_from_jax(v["params"], v["batch_stats"]))
    labels = ["a", "b", "c", "d", "e"]
    got = checkpoint_tools.classify_image(model, str(FIXTURE), labels,
                                          image_size=64, top_k=3)
    want = jax_tools.classify_image(jmodel, v, str(FIXTURE), labels,
                                    image_size=64, top_k=3)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=0, atol=1e-5)
    assert model.training  # the mode is put back


def test_step_timer_matches_jax(monkeypatch, tmp_path):
    """The same clock readings give JAX's summary; ``mark_sync`` takes a
    tensor; ``trace`` writes a Chrome trace."""
    ticks = [0.0, 0.010, 1.0, 1.013, 2.0, 2.011, 3.0, 3.030, 4.0, 4.012,
             5.0, 5.017]

    def run(module, value):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(warmup=1)
        for i in range(len(ticks) // 2 - 1):
            timer.start()
            timer.stop()
        timer.start()
        out = timer.mark_sync(value)
        return out, timer.summary(batch_size=8)

    got = run(profiling, torch.tensor(2.5))
    want = run(jax_profiling, jnp.asarray(2.5))
    assert got == want and len(got[1]) == 5
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# -- the hub -----------------------------------------------------------------


def test_hub_lists_jaxs_models_and_refuses_as_jax(tmp_path, monkeypatch):
    assert hub.list_models() == jax_hub.list_models()
    monkeypatch.setitem(jax_hub._INIT, "ncf", lambda model, rng: None)
    with pytest.raises(KeyError):
        hub.create("not-a-model")
    path = tmp_path / "ncf.pth"
    torch.save(_ncf(0).state_dict(), path)
    for package in (hub, jax_hub):
        with pytest.raises(NotImplementedError, match="no torch converter"):
            package.load("ncf", pretrained=str(path), **(
                {"device": "cpu", "cfg": ncf.NcfConfig(**NCF_KW)}
                if package is hub else {}))


def test_hub_loads_a_model_repository(tmp_path):
    model = _ncf(5)
    save_model_repository(str(tmp_path), "ncf", model.state_dict(),
                          {"user": ((1,), "int32")})
    got = hub.load("ncf", pretrained=str(tmp_path / "ncf") + "/",
                   device="cpu", cfg=ncf.NcfConfig(**NCF_KW),
                   dtype=torch.float32)
    assert not got.training
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v)


def _reference_gpunet(sd: dict, arch) -> dict:
    """The port's GPUNet ``state_dict`` under the reference's names (the
    inverse of ``hub.gpunet_from_reference``), children named as the
    reference's stages, with torch BN's counters."""
    kinds = ["head", *(layer.kind for layer in arch.layers), "tail"]
    srcs = ["stem", *(f"layers.{i}" for i in range(len(arch.layers))), ""]
    out = {}
    for c, (kind, src) in enumerate(zip(kinds, srcs)):
        for ref, part in hub._GPUNET_PARTS[kind].items():
            prefix = f"{src}.{part}" if src else part
            for k, v in sd.items():
                if k.rsplit(".", 1)[0] == prefix:
                    leaf = k.rsplit(".", 1)[1]
                    if part.startswith("se.") and leaf == "weight":
                        v = v[:, :, None, None]
                    out[f"network.stage{c}_{kind}.{ref}.{leaf}"] = v
                    if leaf == "running_var":
                        out[f"network.stage{c}_{kind}.{ref}"
                            ".num_batches_tracked"] = torch.tensor(3)
    assert len(out) == len(sd) + sum(k.endswith("running_var") for k in sd)
    return out


def _hub_cases():
    fcfg = dict(n_symbols=32, d_model=16, n_heads=1, head_dim=16,
                encoder_layers=1, decoder_layers=1, conv_filters=32, n_mels=8,
                max_mel_len=64, predictor_filters=8, energy=True)
    hcfg = dict(n_mels=8, upsample_rates=(4, 2), upsample_kernels=(8, 4),
                upsample_initial_channel=16, resblock_kernels=(3,),
                resblock_dilations=((1, 3),), segment_length=256,
                hop_length=8)
    tcfg = dict(hidden=8, n_heads=1, encoder_len=8, horizon=4, dropout=0.0)
    return {
        "resnet50": ({}, {}, 1e-4),
        "gpunet-0": ({}, {}, 1e-4),
        "fastpitch": ({"cfg": FastPitchConfig(**fcfg)},
                      {"cfg": JaxFastPitchConfig(**fcfg)}, 1e-5),
        "hifigan": ({"cfg": HiFiGanConfig(**hcfg)},
                    {"cfg": JaxHiFiGanConfig(**hcfg)}, 1e-5),
        "tft": ({"cfg": tft.TFTConfig(**tcfg)},
                {"cfg": jax_tft.TFTConfig(**tcfg)}, 1e-5),
    }


def _forwards(name, model, jmodel, variables):
    """(port output, JAX output) on one seeded input."""
    rng = np.random.default_rng(7)
    if name in ("resnet50", "gpunet-0"):
        x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        return got, jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, x)
    if name == "fastpitch":
        text = np.array([[3, 7, 11, 2, 9, 0, 0, 0]], np.int32)
        with torch.no_grad():
            mel, _ = model.infer(torch.from_numpy(text), max_mel_len=16)
        want, _ = jit(lambda v, t: jmodel.apply(
            v, t, max_mel_len=16, method=jmodel.infer))(variables, text)
        return mel, want
    if name == "hifigan":
        mel = rng.normal(size=(1, 16, 8)).astype(np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(mel))
        return got, jit(lambda v, m: jmodel.apply(v, m))(variables, mel)
    cfg = model.cfg
    x = {"s_cat": np.zeros((2, cfg.num_static_vars), np.int32),
         "k_cont": rng.normal(size=(2, cfg.example_length, cfg.n_known)),
         "target": rng.normal(size=(2, cfg.encoder_len, 1)),
         "o_cont": rng.normal(size=(2, cfg.encoder_len, cfg.n_observed_cont))}
    x = {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in x.items()}
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in x.items()})
    return got, jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, x)


@pytest.mark.parametrize("name", list(_hub_cases()))
def test_hub_loads_a_reference_checkpoint_as_jax(name, tmp_path, monkeypatch):
    port_kw, jax_kw, tol = _hub_cases()[name]
    seeded = hub.create(name, seed=3, device="cpu", dtype=torch.float32,
                        **port_kw)
    sd = seeded.state_dict()
    if name == "resnet50":
        sd = {**sd, **{k.replace("running_var", "num_batches_tracked"):
                       torch.tensor(5) for k in sd if "running_var" in k}}
    if name == "gpunet-0":
        sd = _reference_gpunet(sd, seeded.arch)
    path = tmp_path / f"{name}.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    model = hub.load(name, pretrained=str(path), seed=4, device="cpu",
                     dtype=torch.float32, **port_kw)
    for k, v in seeded.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # JAX's init of the full-width model is thrown away by its converter
    monkeypatch.setitem(jax_hub._INIT, name, lambda model, rng: None)
    jmodel, variables = jax_hub.load(name, pretrained=str(path),
                                     dtype=jnp.float32, **jax_kw)
    with jax.default_matmul_precision("highest"):
        got, want = _forwards(name, model, jmodel, variables)
    assert rel(got.numpy(), np.asarray(want)) <= tol
