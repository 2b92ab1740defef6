"""Phase 31a of ``chip_smoke.py`` with one planted fault at a time: the
readings that its limits (``TOL_SEQ``) have to lie between.

31a runs ``bert-pretrain --phase2 --attention-impl ring --mesh-data 1
--mesh-sequence 2`` on two gloo ranks on one card (``chip_smoke.py --mesh 31
a`` under ``torchrun --nproc-per-node 2``) and holds the run against the
one-rank ``--attention-impl flash`` run of the same seed and batches (rank
0) and the one-rank ring run (rank 1). This
script runs it on the checkout as it is, then on a copy of the checkout in a
temporary directory for each fault below (the kernels are built once, in the
checkout, and the copies take the built library):

- ``rank_seeded_generator``: the train state's dropout generator is seeded
  with the global rank added, so the sequence ranks draw different hidden
  dropout masks and attention seeds (at ``--mesh-sequence 1`` it is the
  sound run);
- ``local_dropout_positions``: the ring's dropout hash takes the block's
  local query and key positions, so its keep mask is not K1's.

(A ring that rotates the wrong way is the same permutation at two ranks;
the CPU tests hold the direction at four.) Run it on a machine with one CUDA
card, from the repository root::

    python3 scripts/ring_fault_check.py

It prints one line a run (against each one-rank run, the largest loss
difference relative to its losses and the parameters' distance from its
over the distance the steps moved them, each beside its ``TOL_SEQ`` limit;
whether the two ranks' parameters are equal bit for bit; and each step's
loss difference from the flash run's), then one JSON line with every
reading.
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

# name -> (file, [(text, its faulty replacement)])
FAULTS = {
    "rank_seeded_generator": (
        "deeplearningexamples_tpu_torch/cli/main.py",
        [("    state = create_train_state(model, tx, cfg.seed + 1, params=params)\n"
          "    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)\n"
          "    return BertPretrainRun(",
          "    state = create_train_state(model, tx, cfg.seed + 1 + current_mesh().rank,\n"
          "                               params=params)\n"
          "    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)\n"
          "    return BertPretrainRun(")]),
    "local_dropout_positions": (
        "deeplearningexamples_tpu_torch/ops/ring_attention.py",
        [("        qpos = i * sl + torch.arange(sl, device=dev)",
          "        qpos = torch.arange(sl, device=dev)"),
         ("            kpos = src * sl + torch.arange(sl, device=dev)",
          "            kpos = torch.arange(sl, device=dev)")]),
}


def tol_seq() -> dict:
    """``chip_smoke.py``'s ``TOL_SEQ``, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "TOL_SEQ" for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError("TOL_SEQ not found in chip_smoke.py")


def plant(root: Path, name: str) -> None:
    """Write fault ``name`` into the copy at ``root``; each text must occur
    exactly once."""
    path, edits = FAULTS[name]
    src = (root / path).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times "
                             f"in {path}")
        src = src.replace(old, new)
    (root / path).write_text(src)


def run_31a(root: Path) -> list[dict]:
    """Both ranks' ``MESH`` readings of 31a, run in ``root``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", str(root / "chip_smoke.py"), "--mesh",
           "31", "a"]
    env = {**os.environ, "DLX_DIST_BACKEND": "gloo", "PYTHONPATH": str(root)}
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        raise RuntimeError(f"31a in {root} exited {proc.returncode}")
    ranks: dict = {}
    for line in proc.stdout.splitlines():
        if line.startswith("MESH "):
            rec = json.loads(line[5:])
            ranks[rec["rank"]] = rec["a"]
    return [ranks[0], ranks[1]]


def readings(r0: dict, r1: dict) -> dict:
    """What 31a checks, as it computes it."""
    steps = [abs(x - y) / abs(y) for x, y in zip(r0["losses"], r0["ref_losses"])]
    return {
        "loss": max(steps),
        "param_of_move": r0["param_diff"] / r0["param_move"],
        "ring_loss": max(abs(x - y) / abs(y)
                         for x, y in zip(r1["losses"], r1["ref_losses"])),
        "ring_param_of_move": r1["param_diff"] / r1["param_move"],
        "ranks_equal": r0["digest"] == r1["digest"]
        and r0["losses"] == r1["losses"],
        "steps": steps,
    }


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from deeplearningexamples_tpu_torch.ops import _build

    _build.load("kernels")  # built once; the copies take the library
    tol = tol_seq()
    results = {"sound": readings(*run_31a(ROOT))}
    with tempfile.TemporaryDirectory(prefix="ring_faults_") as tmp:
        for fault in FAULTS:
            copy = Path(tmp) / fault
            shutil.copytree(ROOT, copy, symlinks=True, ignore=shutil.ignore_patterns(
                ".git", "chiprun_out", "workspace", "__pycache__"))
            plant(copy, fault)
            results[fault] = readings(*run_31a(copy))
            shutil.rmtree(copy)
    for run, r in results.items():
        print(f"[{run}] " + ", ".join(
            f"{k} {r[k]:.3e} ({'within' if r[k] <= tol[k] else 'over'} "
            f"{tol[k]})" for k in tol) + f", ranks equal {r['ranks_equal']}"
            + ", each step's loss " + " ".join(f"{x:.3e}" for x in r["steps"]),
            flush=True)
    print(json.dumps({"tol_seq": tol, "readings": results}), flush=True)


if __name__ == "__main__":
    main()
