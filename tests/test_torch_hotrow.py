"""Port parity: the DLRM hot-row gather (``ops/embedding.hot_gather``) and the
probe that times it (``tools/dlrm_hotrow.py``).

The JAX kernel (``perf/dlrm_hotrow.py``'s ``hot_gather``) issues the TPU's
own row DMAs and has no interpret mode, so the port is held, as the probe
holds its kernel, to ``jnp.take`` when ``hot`` is the head of each table,
and to a numpy model of the probe's rule (``perf/dlrm_hotrow.py:46-49``) when
``hot`` differs from it. On the CPU the port runs its plain version; the card
holds the CUDA kernel to it (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu_torch.ops import embedding as emb
from deeplearningexamples_tpu_torch.tools import dlrm_hotrow
from torch_threads import torch_one_thread  # noqa: F401


def _table(v, d, seed=0):
    return np.random.default_rng(seed).standard_normal((v, d)).astype(np.float32)


def _model(table, hot, ids, rows_per_table, k_hot):
    """perf/dlrm_hotrow.py:46-49, row by row; NaN outside [0, V)."""
    out = np.full((len(ids), table.shape[1]), np.nan, np.float32)
    for n, r in enumerate(ids):
        if 0 <= r < table.shape[0]:
            t, within = divmod(int(r), rows_per_table)
            out[n] = hot[t * k_hot + within] if within < k_hot else table[r]
    return out


@pytest.mark.parametrize("skew", ["uniform", "zipf"])
def test_hot_gather_equals_take_when_hot_is_the_head(skew):
    rpt, batch = 1000, 64
    table = _table(dlrm_hotrow.N_TABLES * rpt, 128)
    ids = dlrm_hotrow.flat_ids(np.random.default_rng(1), skew, batch,
                               rows_per_table=rpt)
    hot = dlrm_hotrow.hot_head(torch.from_numpy(table), rpt)
    assert hot.shape == (dlrm_hotrow.N_TABLES * dlrm_hotrow.K_HOT, 128)
    got = emb.hot_gather(torch.from_numpy(table), hot, torch.from_numpy(ids), rpt,
                         dlrm_hotrow.K_HOT)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    np.testing.assert_array_equal(got.numpy(), want)
    if skew == "zipf":  # the probe's point: most zipf lookups are hot
        assert np.mean(ids % rpt < dlrm_hotrow.K_HOT) > 0.5


@pytest.mark.parametrize("rpt,k_hot,d", [(1000, 256, 128), (50, 1, 6), (7, 7, 16)])
def test_hot_gather_matches_the_rule_when_hot_differs(rpt, k_hot, d):
    """Every hot row from ``hot``, never from the table; ids outside
    [0, V) give NaN rows."""
    n_tables = 5
    table = _table(n_tables * rpt, d)
    hot = _table(n_tables * k_hot, d, seed=9) + 100.0
    rng = np.random.default_rng(2)
    ids = rng.integers(-3, n_tables * rpt + 3, 4001).astype(np.int32)
    ids[:3] = [0, n_tables * rpt - 1, 2**31 - 1]
    got = emb.hot_gather(torch.from_numpy(table), torch.from_numpy(hot),
                         torch.from_numpy(ids), rpt, k_hot)
    np.testing.assert_array_equal(got.numpy(),
                                  _model(table, hot, ids, rpt, k_hot))
    assert emb.launches_hot == 0  # CPU tensors never reach the kernel


def test_hot_gather_checks_what_it_takes():
    table = torch.zeros(100, 8)
    ids = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="hot must be"):
        emb.hot_gather(table, torch.zeros(19, 8), ids, 50, 10)
    with pytest.raises(ValueError, match="rows_per_table"):
        emb.hot_gather(table, torch.zeros(30, 8), ids, 30, 10)
    with pytest.raises(ValueError, match="k_hot"):
        emb.hot_gather(table, torch.zeros(120, 8), ids, 50, 60)
    with pytest.raises(ValueError, match="int32"):
        emb.hot_gather(table, torch.zeros(20, 8), ids.long(), 50, 10)


def test_probe_runs_on_the_cpu(capsys, monkeypatch):
    res = dlrm_hotrow.main(["--device", "cpu", "--batch-size", "128",
                            "--rows-per-table", "500"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("zipf(1.15) hot coverage at K=256: ")
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "F.embedding, uniform", "F.embedding, zipf", "hot_gather (K6), zipf",
        "gather_rows (K4), uniform", "gather_rows (K4), zipf",
        "hot_gather max abs err vs embedding (first block)"]
    assert res["max_abs_err"] == 0.0 and 0.5 < res["hot_frac"] < 1.0
    # its default device is the card, and it refuses to run without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dlrm_hotrow.main([])
