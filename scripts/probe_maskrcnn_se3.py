"""The memory and step time of the SE(3)-Transformer at the reference's QM9
width by batch size, and of ``maskrcnn --config-file configs.yml``, on one
card: the readings that chose ``chip_smoke.py`` phase 29's SE(3) batch.

- ``SE3RegressionTask(SE3Config())`` (7 layers, degrees 0-3, 32 channels,
  8 heads) on 29 atoms at B = 8, 32 and 48: three Adam steps each on CUDA
  events and the peak memory (an out-of-memory batch prints "OOM");
- ``maskrcnn --config-file configs.yml`` (R50-FPN, 800 x 800, B=16, bf16),
  6 steps through the CLI on CUDA events, its peak memory and the calls of
  the proposals' NMS.

Run it on a machine with one CUDA card, from the repository root::

    python3 scripts/probe_maskrcnn_se3.py

It prints one JSON object.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import deeplearningexamples_tpu_torch.cli.main as cm  # noqa: E402
from deeplearningexamples_tpu_torch.cli.main import cli  # noqa: E402
from deeplearningexamples_tpu_torch.core.optimizers import adam  # noqa: E402
from deeplearningexamples_tpu_torch.core.train import (  # noqa: E402
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.models import maskrcnn as M  # noqa: E402
from deeplearningexamples_tpu_torch.models.se3_transformer import (  # noqa: E402
    SE3Config,
    SE3RegressionTask,
)


def se3(b: int, n: int = 29, steps: int = 3) -> dict:
    task = SE3RegressionTask(SE3Config())
    model = task.init(torch.Generator().manual_seed(0), "cuda")
    tx = adam(1e-3)
    state = create_train_state(model, tx, 1)
    step = make_train_step(task.loss_fn, tx)
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32) * 2
    species = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (b, n))]
    batch = {"positions": torch.tensor(pos, device="cuda"),
             "species": torch.tensor(species, device="cuda"),
             "mask": torch.ones(b, n, device="cuda"),
             "target": torch.ones(b, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, metrics = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return {"b": b, "ms": ms, "loss": float(metrics["loss"]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main() -> None:
    out = {"card": torch.cuda.get_device_name(0)}
    for b in (8, 32, 48):
        try:
            out[f"se3_{b}"] = se3(b)
        except torch.OutOfMemoryError:
            out[f"se3_{b}"] = "OOM"
        torch.cuda.empty_cache()

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    nms_calls = [0]
    orig_nms = M.batched_nms

    def counting(*a, **k):
        nms_calls[0] += 1
        return orig_nms(*a, **k)

    events = []
    orig_loop = cm.train_loop

    def loop(state, train_step, *a, **k):
        def step(state, batch):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = train_step(state, batch)
            e1.record()
            events.append((e0, e1))
            return res
        return orig_loop(state, step, *a, **k)

    M.batched_nms, cm.train_loop = counting, loop
    try:
        with tempfile.TemporaryDirectory() as ws:
            cli(["maskrcnn", "--config-file", "configs.yml",
                 "--steps-per-epoch", "6", "--epochs", "1", "--workspace",
                 ws])
    finally:
        M.batched_nms, cm.train_loop = orig_nms, orig_loop
    torch.cuda.synchronize()
    out["maskrcnn"] = {"ms": [a.elapsed_time(b) for a, b in events],
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "wall": time.time() - t0, "nms_calls": nms_calls[0]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
