"""Phase 27b of ``chip_smoke.py`` with one planted fault at a time: the
readings that its limits (``TOL_MESH``) have to lie between.

27b runs two gloo ranks on one card (``chip_smoke.py --mesh 27b`` under
``torchrun --nproc-per-node 2``) and holds rank 0's run of each command
against the one-rank run of the same global batch. This script runs it on
the checkout as it is, then on a copy of the checkout in a temporary
directory for each fault below (the kernels are built once, in the
checkout, and the copies take the built library):

- ``local_bn``: BN normalises with the statistics of the rank's own rows
  (no sum over the data axis);
- ``no_grad_mean``: the data axis's gradient mean is skipped;
- ``local_dropout_row``: K1/K2's dropout hash takes the rank's local row
  (batch offset 0), so both ranks draw the masks of rows 0-31.

Each fault runs the commands it can move. Run it on a machine with one CUDA
card, from the repository root::

    python3 scripts/mesh_fault_check.py

It prints one line a run (each command's largest loss difference relative
to the one-rank run's, its parameters' distance from the one-rank run's
over the distance the steps moved them, and for ``resnet50`` the BN running
statistics' distance over their norm, each beside its ``TOL_MESH`` limit),
then one JSON line with every reading.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# name -> (file, [(text, its faulty replacement)], the commands it moves)
FAULTS = {
    "local_bn": (
        "deeplearningexamples_tpu_torch/models/convnets/layers.py",
        [("stats = sum_over_ranks(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]))",
          "stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims)])"),
         ("n = x.numel() // c * current_mesh().size(DATA_AXIS)",
          "n = x.numel() // c")],
        ["resnet50"]),
    "no_grad_mean": (
        "deeplearningexamples_tpu_torch/core/train.py",
        [("all_reduce_mean_(_leaves(grads))", "pass")],
        ["bert", "resnet50"]),
    "local_dropout_row": (
        "deeplearningexamples_tpu_torch/models/bert/modeling.py",
        [("dropout_batch_offset=data_rows(b)[0])", "dropout_batch_offset=0)")],
        ["bert"]),
}
SOUND = ["bert", "resnet50", "dlrm"]


def tol_mesh() -> dict:
    """``chip_smoke.py``'s ``TOL_MESH``, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "TOL_MESH" for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError("TOL_MESH not found in chip_smoke.py")


def plant(root: Path, name: str) -> None:
    """Write fault ``name`` into the copy at ``root``; each text must occur
    exactly once."""
    path, edits, _ = FAULTS[name]
    src = (root / path).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times "
                             f"in {path}")
        src = src.replace(old, new)
    (root / path).write_text(src)


def run_27b(root: Path, names: list[str]) -> dict:
    """Rank 0's ``MESH`` readings of 27b for ``names``, run in ``root``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", str(root / "chip_smoke.py"), "--mesh",
           "27b", *names]
    env = {**os.environ, "DLX_DIST_BACKEND": "gloo", "PYTHONPATH": str(root)}
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        raise RuntimeError(f"27b in {root} exited {proc.returncode}")
    got: dict = {}
    for line in proc.stdout.splitlines():
        if line.startswith("MESH "):
            rec = json.loads(line[5:])
            if rec["rank"] == 0:
                got.update({k: v for k, v in rec.items() if k != "rank"})
    return got


def readings(got: dict) -> dict:
    """Each command's readings, as 27b computes what it checks."""
    out = {}
    for name, r in got.items():
        out[name] = {
            "loss": max(abs(x - y) / abs(y)
                        for x, y in zip(r["losses"], r["ref_losses"])),
            "param_of_move": r["param_diff"] / r["param_move"],
        }
        if "stats_diff" in r:
            out[name]["stats"] = r["stats_diff"]
    return out


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from deeplearningexamples_tpu_torch.ops import _build

    _build.load("kernels")  # built once; the copies take the library
    tol = tol_mesh()
    results = {"sound": readings(run_27b(ROOT, SOUND))}
    with tempfile.TemporaryDirectory(prefix="mesh_faults_") as tmp:
        for fault, (_, _, names) in FAULTS.items():
            copy = Path(tmp) / fault
            shutil.copytree(ROOT, copy, symlinks=True, ignore=shutil.ignore_patterns(
                ".git", "chiprun_out", "workspace", "__pycache__"))
            plant(copy, fault)
            results[fault] = readings(run_27b(copy, names))
            shutil.rmtree(copy)
    for run, per_name in results.items():
        print(f"[{run}] " + "; ".join(
            f"{name}: " + ", ".join(
                f"{k} {v:.3e} ({'within' if v <= tol[k] else 'over'} "
                f"{tol[k]})" for k, v in r.items())
            for name, r in per_name.items()), flush=True)
    print(json.dumps({"tol_mesh": tol, "readings": results}), flush=True)


if __name__ == "__main__":
    main()
