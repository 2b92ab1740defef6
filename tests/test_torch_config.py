"""Port parity: the YAML layers of the CLI, and the two optimizers that no
command calls, against the JAX package.

The port reads YAML with its own subset reader (``core/yaml_subset.py``):
it must give ``yaml.safe_load``'s result on the files the repository has
and refuse what it does not take, naming the line. Each ported command that
``configs.yml`` has a section for resolves to JAX's config under its
precision and platform layers. ``rmsprop`` and ``dlrm_lr_schedule`` are held
to JAX's on the same numpy inputs.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.core import config as jax_config
from deeplearningexamples_tpu.core.optimizers import (
    dlrm_lr_schedule as jax_dlrm_lr_schedule,
    no_decay_mask as jax_no_decay_mask,
    rmsprop as jax_rmsprop,
)
from deeplearningexamples_tpu.data import criteo as jax_criteo
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.core import config, yaml_subset
from deeplearningexamples_tpu_torch.core.optimizers import (
    dlrm_lr_schedule,
    no_decay_mask,
    rmsprop,
)
from torch_threads import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = str(ROOT / "configs.yml")


def test_reader_equals_safe_load_on_configs_yml():
    assert yaml_subset.load(CONFIGS) == yaml.safe_load(open(CONFIGS))


def test_reader_equals_safe_load_on_a_jax_feature_spec(tmp_path):
    spec = jax_criteo.FeatureSpec(categorical_cardinalities=[5, 17, 3] * 4)
    jax_criteo.write_synthetic_dataset(str(tmp_path), spec, n_rows=4)
    path = tmp_path / "feature_spec.yaml"
    assert yaml_subset.load(str(path)) == yaml.safe_load(path.read_text())
    doc = yaml.safe_load(path.read_text())
    assert yaml_subset.dump(doc) == yaml.safe_dump(doc)


@pytest.mark.parametrize("text", [
    "a: 1e-5", "a: 1.0e-05", "a: 3.0517578125e-05", "a: 1.0e5", "a: -1",
    "a: 1_000", "a: .5", "a: -.inf", "a: 0.0052", "a: 24.0", "a: yes",
    "a: Off", "a: ~", "a: null", "a:", "a: b # c", "a: b#c", "a: v5e-1", "a: benchmark-training", "x",
    "a:\n  b:\n    c: 1\n  d: true\ne: 2\n", "# only a comment\n", "",
])
def test_scalars_resolve_as_pyyaml(text):
    got = yaml_subset.loads(text)
    want = yaml.safe_load(text)
    assert got == want and type(got) is type(want)
    if isinstance(want, dict):
        assert {k: type(v) for k, v in got.items()} == {
            k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("text,line", [
    ("a: {b: 1}", 1), ("a: 1\nb: [1, 2]", 2), ("a: &x 1", 1),
    ("a: 1\nb: *x", 2), ("a: !!str 1", 1), ("a: 1\n---\nb: 2", 2),
    ("a:\n  - 1", 2), ("a: 0x1f", 1), ("a: 010", 1), ("a: 2001-12-14", 1),
    ("a: |\n  x", 1), ("? a\n: 1", 1), ("a: 'x y'", 1), ('a:\n  "b": 1', 2),
])
def test_reader_refuses_what_it_does_not_take(text, line):
    with pytest.raises(yaml_subset.YamlSubsetError, match=f"line {line}:"):
        yaml_subset.loads(text)


# every ported command that configs.yml has a models: section for
COMMANDS = ["resnet50", "efficientnet-b0", "ssd300", "bert-pretrain",
            "bert-squad", "tacotron2", "waveglow", "dlrm", "bart",
            "efficientdet"]
LAYERS = [dict(precision="bf16"), dict(precision="fp32"),
          dict(platform="v5e-1"), dict(precision="fp32", platform="v5p-8")]


@pytest.mark.parametrize("layers", LAYERS, ids=lambda d: "-".join(d.values()))
@pytest.mark.parametrize("model", COMMANDS)
def test_resolved_configs_match_jax(model, layers):
    doc = yaml.safe_load(open(CONFIGS))
    assert model in doc["models"]
    assert config.load_yaml_layers(CONFIGS, model=model, **layers) == \
        jax_config.load_yaml_layers(CONFIGS, model=model, **layers)
    got = config.resolve(cli_main._CONFIG_CLS[model](), yaml_path=CONFIGS,
                         model=model, mode=None, **layers)
    want = jax_config.resolve(jax_cli._CONFIG_CLS.get(model, jax_cli.CommonConfig)(),
                              yaml_path=CONFIGS, model=model, mode=None,
                              **layers)
    shared = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)})
    assert set(doc["models"][model]) <= shared
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
        assert type(getattr(got, name)) is type(getattr(want, name)), name
    assert got.amp == (layers.get("precision") != "fp32")


def test_cli_resolves_defaults_then_the_file_then_the_flags(tmp_path, monkeypatch):
    """``--config-file`` with ``--precision``/``--platform`` on the port's
    CLI, as ``dlx-train``'s ``cli()``; a key the command's config lacks
    raises JAX's ``KeyError``."""
    monkeypatch.setitem(cli_main.MODELS, "bert-pretrain", lambda cfg: cfg)
    monkeypatch.setitem(cli_main.MODELS, "dlrm", lambda cfg: cfg)
    ws = ["--workspace", str(tmp_path)]
    cfg = cli_main.cli(["bert-pretrain", "--config-file", CONFIGS,
                        "--precision", "fp32", "--platform", "v5e-1", *ws])
    assert (cfg.lr, cfg.batch_size, cfg.weight_decay, cfg.amp) == (
        0.006, 64, 0.01, False)
    cfg = cli_main.cli(["bert-pretrain", "--config-file", CONFIGS, "--lr",
                        "0.01", "--amp", "true", "--precision", "fp32", *ws])
    assert (cfg.lr, cfg.amp) == (0.01, True)
    assert cli_main.cli(["bert-pretrain", *ws]).lr == 0.1  # no file: quirk 8b
    # quirk 8c stays: the file gives DLRM its published 24.0
    assert cli_main.cli(["dlrm", "--config-file", CONFIGS, *ws]).lr == 24.0
    bad = tmp_path / "bad.yml"
    bad.write_text("models:\n  dlrm:\n    no_such_key: 0.9\n")
    with pytest.raises(KeyError, match="no_such_key"):
        cli_main.cli(["dlrm", "--config-file", str(bad), *ws])
    with pytest.raises(KeyError, match="no_such_key"):
        jax_config.resolve(jax_cli.DlrmCliConfig(), yaml_path=str(bad),
                           model="dlrm")


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"dense_kernel": rng.normal(size=(6, 4)).astype(np.float32),
            "bias": rng.normal(size=(4,)).astype(np.float32),
            "LayerNorm_scale": rng.normal(size=(4,)).astype(np.float32),
            "embedding_table": rng.normal(size=(5, 3)).astype(np.float32)}


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_rmsprop_matches_jax_over_five_steps(momentum):
    """Decoupled decay under the no-decay mask, eps outside the sqrt, the
    trace, a scheduled rate; 5 steps on the same numpy gradients."""
    params = _params(0)
    sched = lambda count: 0.01 * (1.0 + count)
    jtx = jax_rmsprop(sched, alpha=0.9, momentum=momentum, eps=1e-3,
                      weight_decay=0.05, params_for_mask=params)
    mask = no_decay_mask({k: torch.from_numpy(v) for k, v in params.items()})
    assert mask == jax_no_decay_mask(params)
    tx = rmsprop(sched, alpha=0.9, momentum=momentum, eps=1e-3,
                 weight_decay=0.05, mask=mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    for step in range(5):
        grads = _params(step + 1)
        ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        u, state = tx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                             state, tp)
        tp = {k: tp[k] + u[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert state.count == 5


def test_dlrm_lr_schedule_matches_jax_across_warmup_and_decay():
    kw = dict(base_lr=24.0, warmup_steps=8, warmup_factor=0,
              decay_start_step=20, decay_steps=30, decay_power=2.0,
              end_lr_factor=0.01)
    jsched = jax_dlrm_lr_schedule(**kw)
    sched = dlrm_lr_schedule(**kw)
    steps = range(0, 60)
    got = [sched(s) for s in steps]
    # eager JAX, op by op in fp32, to the bit; under jit XLA rewrites the
    # power and the product, and moves the decay by a few fp32 ulp
    assert got == [float(jsched(jnp.int32(s))) for s in steps]
    jitted = jax.jit(jsched)
    np.testing.assert_allclose(got, [float(jitted(jnp.int32(s))) for s in steps],
                               rtol=2e-6)
    assert got[0] == 3.0 and got[7] == 24.0 and got[20] == 24.0
    assert got[59] == pytest.approx(0.24)
    assert dlrm_lr_schedule(1.0, 0, 0, 5, 5)(2) == float(
        jax_dlrm_lr_schedule(1.0, 0, 0, 5, 5)(jnp.int32(2)))
