"""Where one BERT-Large training step spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_pretrain [--task
pretrain|squad] [--out F]``. With ``--task pretrain`` (the default) it
builds ``bert-pretrain`` as the CLI does (BERT-Large, bf16, B=64, S=128, 20
predictions, dropout 0.1, LAMB with bf16 moments), once with the tree LAMB
and once with ``--flat-lamb``; with ``--task squad`` it builds
``bert-squad`` (BERT-Large, bf16, B=32, S=384, dropout 0.1, lr 3e-5), once
with ``--optimizer bert_adam`` and once with ``adamw``. For each:

- times 10 steps on the host clock, each ending in ``synchronize()``;
- traces 3 steps with ``torch.profiler`` and sums device kernel time by
  kind: the flash forward (K1), the flash backward's two kernels (K2), the
  flat LAMB passes (K3), GEMMs, the optimizer (the other kernels launched
  inside the train step's ``optimizer`` span: gradient norms, the update
  and its addition to the weights), and the rest; the device idle share is
  the part of the unprofiled step time that the traced kernels do not cover;
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

from ..cli.main import (
    BertCliConfig,
    SquadCliConfig,
    build_bert_pretrain,
    build_bert_squad,
    to_device,
)

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


def device_kernels(events) -> list:
    """The traced events that ran on the card, without the card-side copies
    of ``record_function`` spans (the train step's ``optimizer``), which
    the profiler also places on the device timeline."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != "optimizer"]


def _in_span(event, name: str) -> bool:
    while event is not None:
        if event.name == name:
            return True
        event = event.cpu_parent
    return False


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def trace_steps(step, steps: int, traced: int, warmup: int = 2,
                kind=_kind) -> dict:
    """Runs ``step()`` ``warmup`` times, then ``steps`` times on the host
    clock (each ending in ``synchronize()``), then ``traced`` times under
    ``torch.profiler``; sums the traced device kernel time by ``kind(name)``
    and by name per step (kernels of the ``optimizer`` span that ``kind``
    calls "other" count as "optimizer"). The profiler slows the host, so the
    traced window is longer than a step: the device idle share is taken
    against the unprofiled step time."""
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
    for e in device_kernels(prof.events()):
        dur = e.time_range.end - e.time_range.start
        intervals.append((e.time_range.start, e.time_range.end))
        by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    # kernels the name does not place, launched inside the optimizer span
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels \
                and _in_span(e, "optimizer"):
            for k in e.kernels:
                if kind(k.name) == "other":
                    by_kind["other"] -= k.duration
                    by_kind["optimizer"] = by_kind.get("optimizer", 0.0) + k.duration
    busy_us = _union_us(intervals)
    median = statistics.median(step_ms)
    per_step = {k: v / traced / 1e3 for k, v in sorted(by_kind.items())}
    total = sum(per_step.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "step_ms_median": median,
        "step_ms_least": min(step_ms),
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


def _profile_run(mode: str, tx, state, train_step, batch, steps: int,
                 traced: int) -> dict:
    """``trace_steps`` over ``train_step`` on one batch, then the optimizer
    update alone on CUDA events."""
    last = {"state": state}

    def step():
        last["state"], last["metrics"] = train_step(last["state"], batch)

    res = trace_steps(step, steps, traced)

    # the optimizer update alone, on the device, with CUDA events
    state = last["state"]
    opt_ms = []
    params = state.params
    grads = params.grad if isinstance(params, torch.Tensor) else \
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in params.items()}
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
        "mode": mode,
        "loss_last": float(last["metrics"]["loss"]),
        **res,
        "optimizer_update_ms": statistics.median(opt_ms),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def profile(flat: bool, steps: int = 10, traced: int = 3) -> dict:
    cfg = BertCliConfig(bert_model="large", batch_size=64, seq_len=128,
                        max_predictions=20, steps_per_epoch=steps,
                        flat_lamb=flat)
    run = build_bert_pretrain(cfg)
    batch = next(to_device(run.loader, cfg.device))
    return _profile_run("flat" if flat else "tree", run.tx, run.state,
                        run.train_step, batch, steps, traced)


def profile_squad(optimizer: str, steps: int = 10, traced: int = 3) -> dict:
    cfg = SquadCliConfig(bert_model="large", batch_size=32,
                         max_seq_length=384, steps_per_epoch=steps, lr=3e-5,
                         optimizer=optimizer)
    _, run = build_bert_squad(cfg)
    batch = next(to_device(run.loader, cfg.device))
    return _profile_run(f"squad {optimizer}", run.tx, run.state,
                        run.train_step, batch, steps, traced)


def run_main(doc: str, profiles, tasks: tuple[str, ...] = (),
             flag: str = "--task") -> None:
    """The profiling tools' command line: ``--out F``, and ``flag`` (``--task
    T`` by default) when ``tasks`` names some (the first is the default).
    Iterates ``profiles()`` or ``profiles(task)`` (a generator of result
    dicts) on the card, prints each result as one JSON object with the
    card's name and power limit, and writes them all to ``--out`` when
    given."""
    parser = argparse.ArgumentParser(doc.splitlines()[0])
    parser.add_argument("--out", default=None, help="a JSON file for the results")
    if tasks:
        parser.add_argument(flag, dest="task", choices=tasks, default=tasks[0],
                            help="the training step to profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    results = []
    for res in (profiles(args.task) if tasks else profiles()):
        res = {"card": card, **res}
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


def _profiles(task: str):
    modes = [False, True] if task == "pretrain" else ["bert_adam", "adamw"]
    for mode in modes:
        torch.cuda.reset_peak_memory_stats()
        yield profile(mode) if task == "pretrain" else profile_squad(mode)
        torch.cuda.empty_cache()


def main() -> None:
    run_main(__doc__, _profiles, tasks=("pretrain", "squad"))


if __name__ == "__main__":
    main()
