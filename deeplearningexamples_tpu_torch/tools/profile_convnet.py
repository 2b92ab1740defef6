"""Where one ResNet-50 or SSD300 training step spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_convnet [--arch
resnet50|ssd300] [--out F]`` builds the model as the CLI does, bf16,
``channels_last``, cuDNN picking its algorithms by timing them:

- ``resnet50`` (the default): ResNet-50 v1.5, B=256, 224x224, with
  ``bench.py``'s recipe (SGD at lr 0.256, momentum 0.875, weight decay
  3.0517578125e-05 off the 1-D tensors, label smoothing 0.1);
- ``ssd300``: SSD300 (81 classes, 8732 anchors), B=128, 300x300, with
  ``bench.py``'s optimizer (SGD at lr 2.6e-3, momentum 0.9, no weight decay)
  and the color twist of every step.

It times 10 steps on the host clock, each ending in ``synchronize()``, then
traces 3 steps with ``torch.profiler`` and sums device kernel time by kind:
the convolutions (cuDNN's forward, data-gradient and weight-gradient
kernels), layout transposes between NCHW and NHWC (none should run: every
tensor is ``channels_last``), BN (the statistics, normalisation and backward
kernels), the other GEMMs (ResNet's ``fc``; the 1x1 convolutions that cuDNN
runs as cuBLASLt GEMMs; SSD300's color twist), the loss's sorts, softmax
and CE kernels (SSD300's hard-negative mining), the optimizer (the other
kernels inside the train step's ``optimizer`` span), and the rest (ReLU,
residual adds, casts, pooling, copies, SmoothL1); the device idle share is
the part of the unprofiled step time that the traced kernels do not
cover.

It needs a CUDA card and prints one JSON object, with the card's name and
power limit, and also writes it to ``--out`` when given.
"""

from __future__ import annotations

import re

import torch

from ..cli.main import (
    ConvNetCliConfig,
    SgdCliConfig,
    build_convnet,
    build_ssd,
    to_device,
)
from .profile_pretrain import run_main, trace_steps

KINDS = [
    ("layout transposes", re.compile(r"nchwToNhwc|nhwcToNchw", re.I)),
    ("loss (sorts, softmax, CE)",
     re.compile(r"sort|softmax|nll_loss|cross_entropy", re.I)),
    ("BN", re.compile(r"batch_norm|\bbn_", re.I)),
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|implicit|cudnn", re.I)),
    ("GEMM", re.compile(r"gemm|nvjet|cublas|cutlass", re.I)),
]


def _kind(name: str) -> str:
    for kind, pat in KINDS:
        if pat.search(name):
            return kind
    return "other"


STEPS, TRACED = 10, 3  # timed on the host clock; traced by the profiler


def _build(arch: str):
    """(run, cfg) of ``arch`` with its benchmark recipe."""
    if arch == "ssd300":
        cfg = SgdCliConfig(batch_size=128, lr=2.6e-3, momentum=0.9,
                           weight_decay=0.0, lr_schedule="constant",
                           steps_per_epoch=STEPS)
        return build_ssd(cfg), cfg
    cfg = ConvNetCliConfig(batch_size=256, lr=0.256, momentum=0.875,
                           weight_decay=3.0517578125e-05, label_smoothing=0.1,
                           steps_per_epoch=STEPS)
    return build_convnet(arch, cfg), cfg


def profile(arch: str = "resnet50") -> dict:
    run, cfg = _build(arch)
    batch = next(to_device(run.loader, cfg.device))
    last = {"state": run.state}

    def step():
        last["state"], last["metrics"] = run.train_step(last["state"], batch)

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        res = trace_steps(step, STEPS, TRACED, warmup=3, kind=_kind)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    res["kernel_ms_per_step"]["elementwise and other"] = \
        res["kernel_ms_per_step"].pop("other", 0.0)
    res["kernel_share"]["elementwise and other"] = \
        res["kernel_share"].pop("other", 0.0)
    return {
        "mode": f"{arch} bf16 B={cfg.batch_size}",
        "loss_last": float(last["metrics"]["loss"]),
        "images_per_s_at_median": cfg.batch_size / res["step_ms_median"] * 1e3,
        **res,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def _profiles(arch: str):
    torch.cuda.reset_peak_memory_stats()
    yield profile(arch)


def main() -> None:
    run_main(__doc__, _profiles, tasks=("resnet50", "ssd300"), flag="--arch")


if __name__ == "__main__":
    main()
