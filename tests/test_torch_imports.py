"""The port and ``chip_smoke.py`` stand without JAX: a CUDA host need not
have jax, flax, optax, orbax or yaml, and no JAX package may be reached."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "flax", "optax", "orbax", "yaml", "deeplearningexamples_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import deeplearningexamples_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("core.train", "core.flat", "core.loop", "core.checkpoint",
             "cli.main", "data.synthetic", "ops.lamb", "ops.dropout"):
    assert f"deeplearningexamples_tpu_torch.{name}" in names, name
import chip_smoke
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # every module of the package: serving, the BERT model and tasks, the
    # training harness (core/), the CLI (cli/) and the data loaders (data/)
    assert int(res.stdout.strip()) >= 37


def test_chip_smoke_fails_without_a_card():
    """On a host without CUDA the script exits non-zero and prints no
    result line."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "torch.cuda.is_available() is false" in res.stderr
