"""Phases 27b and 32 of ``chip_smoke.py`` with one planted fault at a
time: the readings that their limits (``TOL_MESH``; ``TOL_FAMILY`` and
``TOL_FAMILY_GRAD``) have to lie between.

27b and 32 run two gloo ranks on one card (``chip_smoke.py --mesh 27b`` or
``--mesh 32`` under ``torchrun --nproc-per-node 2``) and hold rank 0's run
of each command against the one-rank run of the same global batch. This
script runs them on the checkout as it is, then on a copy of the checkout
in a temporary directory for each fault below (the kernels are built once,
in the checkout, and the copies take the built library). Phase 27b:

- ``local_bn``: BN normalises with the statistics of the rank's own rows
  (no sum over the data axis);
- ``no_grad_mean``: the data axis's gradient mean is skipped;
- ``local_dropout_row``: K1/K2's dropout hash takes the rank's local row
  (batch offset 0), so both ranks draw the masks of rows 0-31.

Phase 32:

- ``per_rank_tokens``: the label-smoothed loss (``transformer``, ``bart``,
  ``gnmt``) divides by the rank's own target tokens (run on
  ``transformer-padded``, whose ranks hold 117 and 28 targets: the CLI's
  synthetic batches give every row as many);
- ``per_rank_perplexity``: wav2vec 2.0's codebook perplexity is of the
  rank's own frames' mean;
- ``local_dropout_shape``: ``tts.layers.Dropout`` (Tacotron2's) draws its
  mask at the rank's own rows.

Each fault runs the commands it can move. Run it on a machine with one CUDA
card, from the repository root::

    python3 scripts/mesh_fault_check.py [27b] [32]

(both phases without an argument). It prints one line a run (27b: each
command's largest loss difference relative to the one-rank run's, its
parameters' distance from the one-rank run's over the distance the steps
moved them, and for ``resnet50`` the BN running statistics' distance over
their norm; 32: the loss difference, the worst first-step gradient and BN
statistic, and whether the ranks' parameters are equal; each beside its
limit), then one JSON line with every reading.
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
FAULTS_32 = {
    "per_rank_tokens": (
        "deeplearningexamples_tpu_torch/models/translation/transformer.py",
        [("return data_mean((ce * valid).sum(), valid.sum())",
          "return (ce * valid).sum() / valid.sum().clamp(min=1.0)")],
        ["transformer-padded"]),
    "per_rank_perplexity": (
        "deeplearningexamples_tpu_torch/models/wav2vec2.py",
        [("avg = sum_over_ranks(torch.softmax(logits, -1).sum((0, 1))) / n",
          "avg = torch.softmax(logits, -1).mean((0, 1))")],
        ["wav2vec2"]),
    "local_dropout_shape": (
        "deeplearningexamples_tpu_torch/models/tts/layers.py",
        [("mask = draw_rows(lambda rows: x.new_empty((rows, *x.shape[1:]))\n"
          "                         .bernoulli_(keep, generator=generator), "
          "x.shape[0])",
          "mask = torch.empty_like(x).bernoulli_(keep, generator=generator)")],
        ["tacotron2"]),
}
SOUND_32 = ["transformer-padded", "wav2vec2", "tacotron2"]


def tol(name: str = "TOL_MESH") -> dict:
    """``chip_smoke.py``'s limits ``name``, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{name} not found in chip_smoke.py")


def plant(root: Path, name: str) -> None:
    """Write fault ``name`` into the copy at ``root``; each text must occur
    exactly once."""
    path, edits, _ = {**FAULTS, **FAULTS_32}[name]
    src = (root / path).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times "
                             f"in {path}")
        src = src.replace(old, new)
    (root / path).write_text(src)


def run_phase(root: Path, phase: str, names: list[str]) -> list[dict]:
    """Each rank's ``MESH`` readings of ``phase`` (27b or 32) for
    ``names``, run in ``root``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", str(root / "chip_smoke.py"), "--mesh",
           phase, *names]
    env = {**os.environ, "DLX_DIST_BACKEND": "gloo", "PYTHONPATH": str(root)}
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        raise RuntimeError(f"{phase} in {root} exited {proc.returncode}")
    got: list[dict] = [{}, {}]
    for line in proc.stdout.splitlines():
        if line.startswith("MESH "):
            rec = json.loads(line[5:])
            got[rec["rank"]].update({k: v for k, v in rec.items()
                                     if k != "rank"})
    return got


def run_27b(root: Path, names: list[str]) -> dict:
    """Rank 0's ``MESH`` readings of 27b for ``names``, run in ``root``."""
    return run_phase(root, "27b", names)[0]


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


def readings_32(got: list[dict]) -> dict:
    """Each command's readings, as phase 32 computes what it checks."""
    r0, r1 = got

    def loss(r, n):
        return max(abs(x - y) / abs(y) for x, y in zip(r["losses"][:n],
                                                       r["ref_losses"][:n]))

    return {name: {
        "loss": loss(r, 1), "loss_steps": loss(r, len(r["losses"])),
        "grad": r["grad_err"][0], "worst_tensor": r["grad_err"][1],
        "grad_of": r["grad_err"][2], "stats": r["stats_err"][0],
        "ranks_equal": r["digest"] == r1[name]["digest"],
    } for name, r in r0.items()}


def limits_32(name: str) -> dict:
    fam, grad = tol("TOL_FAMILY"), tol("TOL_FAMILY_GRAD")
    return {"loss": fam["loss"], "loss_steps": fam["loss_steps"],
            "grad": grad.get(name, fam["grad"]), "stats": fam["stats"]}


def _copy(tmp: str, fault: str) -> Path:
    copy = Path(tmp) / fault
    shutil.copytree(ROOT, copy, symlinks=True, ignore=shutil.ignore_patterns(
        ".git", "chiprun_out", "workspace", "__pycache__"))
    plant(copy, fault)
    return copy


def main(phases: list[str]) -> None:
    sys.path.insert(0, str(ROOT))
    from deeplearningexamples_tpu_torch.ops import _build

    _build.load("kernels")  # built once; the copies take the library
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="mesh_faults_") as tmp:
        if "27b" in phases:
            results["27b"] = {"sound": readings(run_27b(ROOT, SOUND))}
            for fault, (_, _, names) in FAULTS.items():
                copy = _copy(tmp, fault)
                results["27b"][fault] = readings(run_27b(copy, names))
                shutil.rmtree(copy)
        if "32" in phases:
            results["32"] = {"sound": readings_32(
                run_phase(ROOT, "32", SOUND_32))}
            for fault, (_, _, names) in FAULTS_32.items():
                copy = _copy(tmp, fault)
                results["32"][fault] = readings_32(run_phase(copy, "32",
                                                             names))
                shutil.rmtree(copy)
    for run, per_name in results.get("27b", {}).items():
        lim = tol()
        print(f"[27b {run}] " + "; ".join(
            f"{name}: " + ", ".join(
                f"{k} {v:.3e} ({'within' if v <= lim[k] else 'over'} "
                f"{lim[k]})" for k, v in r.items())
            for name, r in per_name.items()), flush=True)
    for run, per_name in results.get("32", {}).items():
        print(f"[32 {run}] " + "; ".join(
            f"{name}: " + ", ".join(
                f"{k} {r[k]:.3e} ({'within' if r[k] <= lim else 'over'} "
                f"{lim})" for k, lim in limits_32(name).items())
            + f", worst tensor {r['worst_tensor']:.3e} ({r['grad_of']}), ranks "
            + ("equal" if r["ranks_equal"] else "apart")
            for name, r in per_name.items()), flush=True)
    print(json.dumps({"tol_mesh": tol(), "tol_family": tol("TOL_FAMILY"),
                      "tol_family_grad": tol("TOL_FAMILY_GRAD"),
                      "readings": results}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["27b", "32"])
