"""Port parity: the Criteo binary data path of DLRM against the JAX package.

Both packages write and read the same files (feature spec, label,
numerical and categorical binaries) and give the same batches, bit for bit:
the synthetic writer, the TSV transcoder and the thresholding preprocessor,
the row window and the short eval tail. The feature spec's cardinalities
come back in ``sorted()`` key order in both (the JAX package's order, kept
on purpose), and ``dlrm --data-backend binary`` takes the same first step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deeplearningexamples_tpu.data import criteo as jax_criteo
from deeplearningexamples_tpu.models.dlrm import DlrmConfig as JaxDlrmConfig
from deeplearningexamples_tpu.models.dlrm import DlrmTask as JaxDlrmTask
from deeplearningexamples_tpu_torch.cli.main import DlrmCliConfig, build_dlrm, cli
from deeplearningexamples_tpu_torch.data import criteo
from deeplearningexamples_tpu_torch.utils.jax_bridge import dlrm_state_dict_from_jax

# 26 unequal cardinalities, the largest first: in the sorted() key order
# (0, 1, 10, ..., 19, 2, 20, ..., 25, 3, ..., 9) the last table is cat_9's,
# which is larger than column 25's ids, so no id runs off the joint table
CARDS_26 = [200 - 5 * i for i in range(26)]
SORTED_ORDER = sorted(range(26), key=lambda i: f"cat_{i}.bin")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in ("label.bin", "numerical.bin", "categorical.bin",
                         "feature_spec.yaml")}


def _batches(ds):
    return [{k: np.array(v) for k, v in b.items()} for b in ds]


def _assert_same_batches(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_feature_spec_text_and_the_sorted_cardinality_order(tmp_path):
    """``to_yaml`` writes ``yaml.safe_dump``'s text, and ``from_yaml`` reads
    26 unequal cardinalities back in sorted() key order, as JAX does."""
    spec = criteo.FeatureSpec(categorical_cardinalities=list(CARDS_26))
    spec.to_yaml(str(tmp_path / "port.yaml"))
    jax_criteo.FeatureSpec(categorical_cardinalities=list(CARDS_26)).to_yaml(
        str(tmp_path / "jax.yaml"))
    text = (tmp_path / "port.yaml").read_text()
    assert text == (tmp_path / "jax.yaml").read_text()
    assert yaml.safe_load(text) == yaml.safe_load(
        (tmp_path / "jax.yaml").read_text())
    got = criteo.FeatureSpec.from_yaml(str(tmp_path / "jax.yaml"))
    want = jax_criteo.FeatureSpec.from_yaml(str(tmp_path / "port.yaml"))
    assert (got.categorical_cardinalities, got.num_numerical) == (
        want.categorical_cardinalities, want.num_numerical)
    assert got.num_numerical == 13
    # quirk 8j: not the file's column order
    assert got.categorical_cardinalities == [CARDS_26[i] for i in SORTED_ORDER]
    assert got.categorical_cardinalities[:4] == [200, 195, 150, 145]
    assert got.categorical_cardinalities != CARDS_26


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_synthetic_set(tmp_path, writer):
    """The writers make the same bytes; each reader gives the same batches
    from either's files: the whole set, the 98/2 row window with the eval
    tail, and a two-way shard."""
    cards = [7, 30, 11]
    for name, mod in (("jax", jax_criteo), ("port", criteo)):
        mod.write_synthetic_dataset(str(tmp_path / name),
                                    mod.FeatureSpec(categorical_cardinalities=cards),
                                    n_rows=1003, seed=3)
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    d = str(tmp_path / writer)
    spec = criteo.FeatureSpec.from_yaml(os.path.join(d, "feature_spec.yaml"))
    jspec = jax_criteo.FeatureSpec.from_yaml(os.path.join(d, "feature_spec.yaml"))
    for kw in (dict(batch_size=64),
               dict(batch_size=64, row_range=(0.0, 0.98)),
               dict(batch_size=64, row_range=(0.98, 1.0), drop_last=False),
               dict(batch_size=50, drop_last=False, shard=(1, 2))):
        ds = criteo.CriteoBinaryDataset(d, spec, **kw)
        jds = jax_criteo.CriteoBinaryDataset(d, jspec, **kw)
        assert len(ds) == len(jds)
        _assert_same_batches(_batches(ds), _batches(jds))
    tail = _batches(criteo.CriteoBinaryDataset(
        d, spec, 64, row_range=(0.98, 1.0), drop_last=False))
    assert [len(b["label"]) for b in tail] == [21]  # 1003 - int(1003 * 0.98)
    assert tail[0]["numerical"].min() >= 0.0  # log1p(max(x, 0))


def _tsv(path, rows, seed=0):
    """A Criteo-style TSV: label, 13 ints (some empty), 26 hex ids (some
    empty), ids drawn from a few values per column so that some pass a
    frequency threshold of 3."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            ints = [str(int(v)) if rng.random() > 0.1 else ""
                    for v in rng.integers(-2, 50, 13)]
            cats = [f"{int(v):08x}" if rng.random() > 0.1 else ""
                    for v in rng.integers(0, 6, 26) * 7919]
            f.write("\t".join([str(int(rng.integers(0, 2)))] + ints + cats)
                    + "\n")


def test_transcode_and_preprocess_a_tsv_alike(tmp_path):
    _tsv(tmp_path / "day_0.tsv", 120, seed=0)
    _tsv(tmp_path / "day_1.tsv", 40, seed=1)
    spec_kw = dict(categorical_cardinalities=[13 + i for i in range(26)])
    rows = {}
    for name, mod in (("jax", jax_criteo), ("port", criteo)):
        rows[name] = mod.transcode_tsv(str(tmp_path / "day_0.tsv"),
                                       str(tmp_path / f"tr_{name}"),
                                       mod.FeatureSpec(**spec_kw))
    assert rows["jax"] == rows["port"] == 120
    assert _files(tmp_path / "tr_jax") == _files(tmp_path / "tr_port")
    specs = {}
    for name, mod in (("jax", jax_criteo), ("port", criteo)):
        specs[name] = mod.preprocess_criteo_tsv(
            [str(tmp_path / "day_0.tsv"), str(tmp_path / "day_1.tsv")],
            str(tmp_path / f"pp_{name}"), frequency_threshold=3,
            test_split_last=True)
    assert (specs["jax"].categorical_cardinalities
            == specs["port"].categorical_cardinalities)
    assert max(specs["port"].categorical_cardinalities) > 1
    for split in ("train", "test"):
        assert (_files(tmp_path / "pp_jax" / split)
                == _files(tmp_path / "pp_port" / split))


def test_dlrm_binary_backend_takes_the_first_step_of_jax(tmp_path):
    """``dlrm --data-backend binary`` on a 26-table set: the model's tables
    in the spec's (sorted) order, the loaders over the 98/2 window, and the
    first batch's loss equal to JAX's on the same weights and batch; then
    the CLI trains and evaluates AUC over the trailing rows."""
    data = tmp_path / "criteo"
    criteo.write_synthetic_dataset(
        str(data), criteo.FeatureSpec(categorical_cardinalities=CARDS_26),
        n_rows=700, seed=0)
    cfg = DlrmCliConfig(data_backend="binary", data_dir=str(data),
                        batch_size=64, embedding_dim=16, amp=False,
                        device="cpu", workspace=str(tmp_path / "ws"))
    run = build_dlrm(cfg)
    cards = tuple(CARDS_26[i] for i in SORTED_ORDER)
    assert run.task.cfg.categorical_cardinalities == cards
    assert (len(run.loader), len(run.val_loader)) == (10, 1)
    jtask = JaxDlrmTask(JaxDlrmConfig(categorical_cardinalities=cards,
                                      embedding_dim=16,
                                      bottom_mlp=(512, 256, 16)), jnp.float32)
    params, _ = jtask.init(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = run.state.model
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           dlrm_state_dict_from_jax(params).items()})
    batch = next(iter(run.loader))
    jbatch = next(iter(jax_criteo.CriteoBinaryDataset(
        str(data), jax_criteo.FeatureSpec.from_yaml(
            str(data / "feature_spec.yaml")), 64, row_range=(0.0, 0.98))))
    _assert_same_batches([batch], [jbatch])
    with jax.default_matmul_precision("highest"):
        want, _ = jtask.loss_fn(params, {}, jbatch, None)
    with torch.no_grad():
        got, _ = run.task.loss_fn(
            model, {}, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    state, best = cli(["dlrm", "--data-backend", "binary", "--data-dir",
                       str(data), "--batch-size", "64", "--embedding-dim", "16",
                       "--device", "cpu", "--workspace", str(tmp_path / "ws2")])
    assert state.step == 10 and 0.0 <= best <= 1.0
