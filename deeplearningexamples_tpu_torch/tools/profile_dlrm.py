"""Where one DLRM training step spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_dlrm [--out F]``
builds ``dlrm`` as the CLI does at full width (26 tables of 100,000 rows,
D=128, bf16 compute, B=65,536, dual SGD) at the CLI's default lr 0.1, with
uniform and with zipf(1.15) indices, and for each:

- times 10 steps on the host clock, each ending in ``synchronize()``;
- traces 3 steps with ``torch.profiler`` and sums device kernel time by the
  part of the step that launched it: the row gather (K4), the MLPs' GEMMs,
  the dot interaction's batched products, the embedding's scatter backward
  (everything under its autograd node: the sort, the gather in sorted
  order, the run bounds and the segment sum),
  ``grad_norm``, the SGD update, and the rest (casts, ReLU, BCE, concats);
  the device idle share is the part of the unprofiled step time that the
  traced kernels do not cover.

It needs a CUDA card and prints one JSON object per skew, with the card's
name and power limit, and also writes them all to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ..cli.main import DlrmCliConfig, build_dlrm, to_device
from ..data.synthetic import SyntheticDlrmLoader
from .profile_pretrain import _union_us, device_kernels

# (part, test on the kernel's name and the names of the ops above it), in
# the order they are tried
PARTS = [
    ("K4 gather_rows", lambda k, ops: "gather_rows_kernel" in k),
    ("scatter backward", lambda k, ops: any("EmbeddingLookupBackward" in o
                                            for o in ops)),
    ("interaction bmm", lambda k, ops: "aten::bmm" in ops),
    ("GEMMs (MLPs)", lambda k, ops: "aten::addmm" in ops or "aten::mm" in ops),
    ("grad_norm", lambda k, ops: any("norm" in o for o in ops)),
    ("SGD update", lambda k, ops: any(o.startswith("aten::_foreach_")
                                      for o in ops)),
]


def _part(kernel: str, ops: list[str]) -> str:
    for part, test in PARTS:
        if test(kernel, ops):
            return part
    return "other"


def _ancestors(event) -> list[str]:
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    return names


def profile(skew: str, steps: int = 10, traced: int = 3) -> dict:
    cfg = DlrmCliConfig(batch_size=65_536, steps_per_epoch=steps)
    run = build_dlrm(cfg)
    loader = SyntheticDlrmLoader(cfg.batch_size, [cfg.cardinality] * cfg.num_tables,
                                 steps=1, skew=skew)
    batch = next(to_device(loader, cfg.device))
    state = run.state
    for _ in range(2):  # warm-up: kernel loads, allocator
        state, _ = run.train_step(state, batch)
    torch.cuda.synchronize()

    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = run.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            state, m = run.train_step(state, batch)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    intervals, by_name = [], {}
    for e in device_kernels(events):
        intervals.append((e.time_range.start, e.time_range.end))
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    busy_us = _union_us(intervals)
    by_part: dict[str, float] = {}
    by_op: dict[tuple[str, str, str], float] = {}  # (part, op, kernel)
    for e in events:  # each op with the kernels it launched itself
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            ops = _ancestors(e)
            part = _part(k.name, ops)
            by_part[part] = by_part.get(part, 0.0) + k.duration
            # the op that launched it and the autograd node above it, if any
            node = next((o for o in ops if o.startswith("autograd::")), "")
            key = (part, f"{e.name} {node}".strip(), k.name[:80])
            by_op[key] = by_op.get(key, 0.0) + k.duration

    per_step = {k: v / traced / 1e3 for k, v in sorted(by_part.items())}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:16]
    median = statistics.median(step_ms)
    return {
        "skew": skew,
        "batch_size": cfg.batch_size,
        "loss_last": float(m["loss"]),
        "step_ms_median": median,
        "step_ms": step_ms,
        "samples_per_s": cfg.batch_size / median * 1e3,
        "traced_steps": traced,
        # kernel time by part; its total falls short of all kernels' where
        # the profiler linked a kernel to no op
        "kernel_ms_per_step": per_step,
        "attributed_ms_per_step": sum(per_step.values()),
        "kernel_ms_total_per_step": sum(by_name.values()) / traced / 1e3,
        "device_busy_ms_per_step": busy_us / traced / 1e3,
        "window_ms_per_step": window_us / traced / 1e3,
        # the profiler slows the host, so the traced window is longer than a
        # step; the idle share is taken against the unprofiled step time
        "device_idle_share": 1.0 - busy_us / traced / 1e3 / median,
        "traced_window_idle_share": 1.0 - busy_us / window_us,
        # (part, launching op and autograd node, kernel, ms per step)
        "top_kernels_ms_per_step": [(*key, t / traced / 1e3) for key, t in top],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main() -> None:
    parser = argparse.ArgumentParser(__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="a JSON file for the results")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    results = []
    for skew in ("uniform", "zipf"):
        torch.cuda.reset_peak_memory_stats()
        res = {"card": card, **profile(skew)}
        print(json.dumps(res), flush=True)
        results.append(res)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
