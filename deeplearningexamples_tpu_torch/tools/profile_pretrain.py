"""Where one BERT-Large pretraining step spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_pretrain [--out F]``
builds ``bert-pretrain`` as the CLI does (BERT-Large, bf16, B=64, S=128, 20
predictions, dropout 0.1, LAMB with bf16 moments), once with the tree LAMB
and once with ``--flat-lamb``, and for each:

- times 10 steps on the host clock, each ending in ``synchronize()``;
- traces 3 steps with ``torch.profiler`` and sums device kernel time by
  kind: the flash forward (K1), the flash backward's two kernels (K2), the
  flat LAMB passes (K3), GEMMs, and the rest; the device idle share is the
  part of the unprofiled step time that the traced kernels do not cover;
- times the optimizer update alone (``tx.update``) with CUDA events.

It needs a CUDA card and prints one JSON object per mode, with the card's
name and power limit, and also writes them all to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import torch

from ..cli.main import BertCliConfig, build_bert_pretrain, to_device

KINDS = [
    # the bf16 instances are the *_mma_kernel ones, the fp32 the others
    ("K1 flash_fwd", re.compile(r"flash_fwd_(mma_)?kernel")),
    ("K2 flash_bwd", re.compile(r"flash_bwd_(dq|dkv)_(mma_)?kernel")),
    # not multi_tensor_apply_kernel, the foreach ops' kernel
    ("K3 flat_lamb", re.compile(r"::(moments|apply)_kernel<")),
    ("GEMM", re.compile(r"gemm|nvjet|xmma|cutlass|cublas|sm90_", re.I)),
]


def _kind(name: str) -> str:
    for kind, pat in KINDS:
        if pat.search(name):
            return kind
    return "other"


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def trace_steps(step, steps: int, traced: int, warmup: int = 2) -> dict:
    """Runs ``step()`` ``warmup`` times, then ``steps`` times on the host
    clock (each ending in ``synchronize()``), then ``traced`` times under
    ``torch.profiler``; sums the traced device kernel time by kind and by
    name per step. The profiler slows the host, so the traced window is
    longer than a step: the device idle share is taken against the
    unprofiled step time."""
    for _ in range(warmup):  # kernel loads, allocator
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        intervals.append((e.time_range.start, e.time_range.end))
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    busy_us = _union_us(intervals)
    median = statistics.median(step_ms)
    per_step = {k: v / traced / 1e3 for k, v in sorted(by_kind.items())}
    total = sum(per_step.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "step_ms_median": median,
        "step_ms": step_ms,
        "traced_steps": traced,
        "kernel_ms_per_step": per_step,
        "kernel_ms_total_per_step": total,
        "kernel_share": {k: v / total for k, v in per_step.items()},
        "device_busy_ms_per_step": busy_us / traced / 1e3,
        "window_ms_per_step": window_us / traced / 1e3,
        "device_idle_share": 1.0 - busy_us / traced / 1e3 / median,
        "traced_window_idle_share": 1.0 - busy_us / window_us,
        "top_kernels_ms_per_step": [(n[:120], t / traced / 1e3) for n, t in top],
    }


def profile(flat: bool, steps: int = 10, traced: int = 3) -> dict:
    cfg = BertCliConfig(bert_model="large", batch_size=64, seq_len=128,
                        max_predictions=20, steps_per_epoch=steps,
                        flat_lamb=flat)
    run = build_bert_pretrain(cfg)
    batch = next(to_device(run.loader, cfg.device))
    last = {"state": run.state}

    def step():
        last["state"], last["metrics"] = run.train_step(last["state"], batch)

    res = trace_steps(step, steps, traced)

    # the optimizer update alone, on the device, with CUDA events
    state = last["state"]
    opt_ms = []
    params = state.params
    grads = params.grad if isinstance(params, torch.Tensor) else \
        {n: p.grad for n, p in params.items()}
    tx = run.tx
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            tx.update(grads, state.opt_state, params)
        end.record()
        torch.cuda.synchronize()
        opt_ms.append(start.elapsed_time(end))

    return {
        "mode": "flat" if flat else "tree",
        "loss_last": float(last["metrics"]["loss"]),
        **res,
        "optimizer_update_ms": statistics.median(opt_ms),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def run_main(doc: str, profiles) -> None:
    """The profiling tools' command line: ``--out F``. Iterates
    ``profiles()`` (a generator of result dicts) on the card, prints each
    result as one JSON object with the card's name and power limit, and
    writes them all to ``--out`` when given."""
    parser = argparse.ArgumentParser(doc.splitlines()[0])
    parser.add_argument("--out", default=None, help="a JSON file for the results")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    results = []
    for res in profiles():
        res = {"card": card, **res}
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


def _profiles():
    for flat in (False, True):
        torch.cuda.reset_peak_memory_stats()
        yield profile(flat)
        torch.cuda.empty_cache()


def main() -> None:
    run_main(__doc__, _profiles)


if __name__ == "__main__":
    main()
