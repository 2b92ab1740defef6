"""Where one speech model's training step spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_tts [--model
tacotron2|waveglow|fastpitch|wav2vec2] [--steps N] [--traced N] [--out F]``
builds the model as the CLI does, bf16:

- ``tacotron2`` (the default): ``Tacotron2Config()``, B=128, text length
  128, mel length 600 (the synthetic loader's, lengths uniform in [300,
  600) and [64, 128)), clip-by-global-norm 1.0 then Adam at lr 1e-3
  (``bench.py``'s shapes and rates);
- ``waveglow``: ``WaveGlowConfig()`` (12 flows, 8 WN layers of 256
  channels), B=10, segment 8000, the same optimizer at lr 1e-4;
- ``fastpitch``: the ``fastpitch`` command's model and batch (6 + 6 FFT
  blocks of d 384, text 32, mel 900), B=32, Adam at lr 1e-3;
- ``wav2vec2``: the ``wav2vec2`` command's BASE model and batch (one
  second of audio, 49 frames), B=32, AdamW at lr 5e-4.

It times ``--steps`` steps (10) on the host clock, each ending in
``synchronize()``, then traces ``--traced`` steps (3) with
``torch.profiler`` and sums device kernel time by the part of the step that
launched it. A backward kernel goes to the part of the forward op its
autograd node came from (the profiler's sequence numbers link the two):

- K1 and K2 (the flash kernels, by name);
- LSTM cells (the decoder's two cells and the encoder's BiLSTM);
- attention (the decoder step's ``attention`` span: the location
  convolution and dense layer, the energies, the softmax, the context);
- other GEMMs; convolutions; BN;
- the clip + Adam update (the train step's ``optimizer`` span, with the
  gradient norm);
- elementwise and other (activations, dropout, casts, concatenations,
  gradient accumulation, the losses).

It also reports kernel launches per step, the device idle share (the part
of the unprofiled step time that the traced kernels do not cover) and the
peak device memory. Tacotron2 steps are reported as frames/s (the sum of
``mel_lengths``, as ``bench.py`` counts them), FastPitch's as frames/s (the
sum of the durations), WaveGlow's and wav2vec2's as samples/s (B times the
segment). It needs a CUDA card and prints one JSON object with
the card's name and power limit, and also writes it to ``--out`` when
given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ..cli.main import CommonConfig, build_breadth, build_tts, to_device
from .profile_pretrain import _union_us, device_kernels

SHAPES = {"tacotron2": dict(batch_size=128, lr=1e-3),
          "waveglow": dict(batch_size=10, lr=1e-4),
          "fastpitch": dict(batch_size=32, lr=1e-3),
          "wav2vec2": dict(batch_size=32, lr=5e-4)}

PARTS = [
    ("K1 flash_fwd", lambda ops, k: "flash_fwd" in k),
    ("K2 flash_bwd", lambda ops, k: "flash_bwd" in k),
    ("clip + Adam update", lambda ops, k: "optimizer" in ops),
    ("attention", lambda ops, k: "attention" in ops),
    ("LSTM cells", lambda ops, k: any("lstm" in o.lower() or "rnn" in o.lower()
                                      for o in ops)),
    ("BN", lambda ops, k: any("batch_norm" in o.lower() for o in ops)),
    ("convolutions", lambda ops, k: any("conv" in o.lower() for o in ops)),
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


def _chain(event) -> list:
    out = []
    while event is not None:
        out.append(event)
        event = event.cpu_parent
    return out


def attribute(events, part=None) -> tuple[dict[str, float], dict[str, int]]:
    """(kernel us by part, kernels by part) over the traced CPU events: a
    kernel's part is ``part(ops, kernel name)`` (by default ``PARTS``'
    reading of ``ops``), where ``ops`` are the names of the op that
    launched it and the ops above it, and for a backward op also those of
    the forward op its autograd node came from."""
    part = part or _part
    forward: dict[int, list[str]] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.sequence_nr >= 0 and not e.name.startswith("autograd::") \
                and "Backward" not in e.name and e.sequence_nr not in forward:
            forward[e.sequence_nr] = [a.name for a in _chain(e)]
    us: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        chain = _chain(e)
        ops = [a.name for a in chain]
        node = next((a for a in chain if "Backward" in a.name
                     and a.sequence_nr >= 0), None)
        if node is not None:
            ops += forward.get(node.sequence_nr, [])
        for k in e.kernels:
            name = part(ops, k.name)
            us[name] = us.get(name, 0.0) + k.duration
            count[name] = count.get(name, 0) + 1
    return us, count


def profile(model: str, steps: int = 10, traced: int = 3) -> dict:
    cfg = CommonConfig(**SHAPES[model], steps_per_epoch=steps)
    build = build_breadth if model in ("fastpitch", "wav2vec2") else build_tts
    run = build(model, cfg)
    batch = next(to_device(run.loader, cfg.device))
    state = run.state
    for _ in range(2):  # warm-up: kernel loads, cuDNN plans, allocator
        state, m = run.train_step(state, batch)
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
    kernels = device_kernels(events)
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    total_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    us, count = attribute(events)
    median = statistics.median(step_ms)
    if model == "tacotron2":
        items = int(batch["mel_lengths"].sum())
        unit = "frames_per_s"
    elif model == "fastpitch":
        items = int(batch["durations"].sum())
        unit = "frames_per_s"
    else:
        items = batch["audio"].numel()
        unit = "samples_per_s"
    return {
        "mode": f"{model} bf16 B={cfg.batch_size}",
        "loss_last": float(m["loss"]),
        "step_ms_median": median,
        "step_ms_least": min(step_ms),
        "step_ms": step_ms,
        f"{unit}_at_median": items / median * 1e3,
        "items_per_step": items,
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
    parser.add_argument("--model", choices=tuple(SHAPES), default="tacotron2")
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
