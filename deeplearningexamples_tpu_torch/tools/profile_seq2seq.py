"""Where one encoder-decoder training step spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_seq2seq [--model
transformer|bart-large] [--steps N] [--traced N] [--out F]`` builds, bf16:

- ``transformer`` (the default): the CLI's ``transformer`` command
  (``build_transformer``): ``TransformerConfig()`` (6+6 layers, d 512, a
  vocab of 33,712 padded to 33,792), B=128, source 64 and target 63 after
  the shift, AdamW at lr 5e-4;
- ``bart-large``: ``BartConfig()`` (12+12 layers, d 1024, a vocab of 50,265
  padded to 50,304), B=8, source 1024 and target 128 (random ids, no pads),
  AdamW at lr 1e-3 with decay 0.01, as the CLI's ``bart`` optimises.

It times ``--steps`` steps (10) on the host clock, each ending in
``synchronize()``, then traces ``--traced`` steps (3) with
``torch.profiler`` and sums device kernel time by part: K1 (the flash
forward kernel), K2 (the backward's dq and dk/dv kernels), the GEMMs of the
tied vocab projection and its backward (the ``vocab_projection`` span),
the other GEMMs, the optimizer (the train step's ``optimizer`` span), and
elementwise and other (LayerNorm, GELU/ReLU, the log-softmax and loss,
embedding lookups, casts). A backward kernel goes to the part of the
forward op its autograd node came from (``profile_tts.attribute``). It also
reports kernel launches per step, the device idle share and the peak device
memory, and tokens/s (source plus target tokens a step). It needs a CUDA
card and prints one JSON object with the card's name and power limit, and
also writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..cli.main import CommonConfig, build_transformer, to_device
from ..core.optimizers import adamw
from ..core.train import create_train_state, make_train_step
from ..models.bart import BartConfig, BartTask
from .profile_pretrain import _union_us, device_kernels
from .profile_tts import attribute

MODELS = ("transformer", "bart-large")
BART_SHAPE = dict(batch=8, src=1024, tgt=128)

PARTS = [
    ("K1 flash_fwd", lambda ops, k: "flash_fwd" in k),
    ("K2 flash_bwd", lambda ops, k: "flash_bwd" in k),
    ("optimizer", lambda ops, k: "optimizer" in ops),
    ("vocab projection GEMMs", lambda ops, k: "vocab_projection" in ops),
    ("other GEMMs", lambda ops, k: any(
        o.split("::")[-1] in ("mm", "addmm", "bmm", "linear", "matmul")
        or o.startswith(("MmBackward", "AddmmBackward", "BmmBackward"))
        for o in ops)),
]


def _part(ops: list[str], kernel: str) -> str:
    for part, test in PARTS:
        if test(ops, kernel):
            return part
    return "elementwise and other"


def _bart_large(device: str = "cuda"):
    """(train step, state, batch) of bart-large at ``BART_SHAPE``."""
    task = BartTask(BartConfig(), torch.bfloat16)
    model = task.init(torch.Generator().manual_seed(0), device)
    tx = adamw(1e-3, weight_decay=0.01)
    state = create_train_state(model, tx, 1)
    rng = np.random.default_rng(0)
    b, s, t = BART_SHAPE["batch"], BART_SHAPE["src"], BART_SHAPE["tgt"]
    vocab = task.cfg.vocab_size
    tgt = rng.integers(3, vocab, (b, t))
    tgt[:, 0], tgt[:, -1] = task.cfg.bos_id, task.cfg.eos_id
    batch = {"src": torch.from_numpy(rng.integers(3, vocab, (b, s))).to(device),
             "tgt": torch.from_numpy(tgt).to(device)}
    return make_train_step(task.loss_fn, tx), state, batch


def profile(model: str, steps: int = 10, traced: int = 3) -> dict:
    if model == "transformer":
        cfg = CommonConfig(batch_size=128, lr=5e-4, steps_per_epoch=steps)
        run = build_transformer(cfg)
        step, state = run.train_step, run.state
        batch = next(to_device(run.loader, cfg.device))
    else:
        step, state, batch = _bart_large()
    for _ in range(2):  # warm-up: kernel loads, the allocator
        state, m = step(state, batch)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels = [e for e in device_kernels(events)
               if e.name != "vocab_projection"]  # the span's device copy
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    total_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    us, count = attribute(events, _part)
    median = statistics.median(step_ms)
    tokens = batch["src"].numel() + batch["tgt"][:, 1:].numel()
    b, s = batch["src"].shape
    return {
        "mode": f"{model} bf16 B={b} source {s} target "
                f"{batch['tgt'].shape[1] - 1}",
        "loss_last": float(m["loss"]),
        "step_ms_median": median,
        "step_ms_least": min(step_ms),
        "step_ms": step_ms,
        "tokens_per_step": tokens,
        "tokens_per_s_at_median": tokens / median * 1e3,
        "traced_steps": traced,
        # kernel time by part; its total falls short of all kernels' where
        # the profiler linked a kernel to no op
        "kernel_ms_per_step": {k: v / traced / 1e3 for k, v in sorted(us.items())},
        "kernels_per_step_by_part": {k: v / traced for k, v in sorted(count.items())},
        "kernel_launches_per_step": len(kernels) / traced,
        "kernel_ms_total_per_step": total_us / traced / 1e3,
        "device_busy_ms_per_step": busy_us / traced / 1e3,
        "window_ms_per_step": window_us / traced / 1e3,
        "device_idle_share": 1.0 - busy_us / traced / 1e3 / median,
        "traced_window_idle_share": 1.0 - busy_us / window_us,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main() -> None:
    parser = argparse.ArgumentParser(__doc__.splitlines()[0])
    parser.add_argument("--model", choices=MODELS, default="transformer")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--traced", type=int, default=3)
    parser.add_argument("--out", default=None, help="a JSON file for the result")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.cuda.reset_peak_memory_stats()
    res = {"card": card, **profile(args.model, args.steps, args.traced)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
