"""Step timing and tracing.

Port of ``deeplearningexamples_tpu/utils/profiling.py`` (the reference's
in-loop throughput instrumentation, ``training.py:222-243``, and DLRM's
``StepTimer``):

- ``StepTimer``: a host-clock timer per step with JAX's fields and
  quantiles (mean, p50, p90, p99 in ms, images/s with a batch size). It
  reads timestamps only, so queued CUDA work runs on; ``mark_sync`` fetches
  a tensor's value (``.item()``), which waits for the device, then stops;
- ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace of the CPU and CUDA activity into ``log_dir``
  (TensorBoard's profiler plugin and Perfetto read it).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["StepTimer", "trace"]


@dataclass
class StepTimer:
    warmup: int = 5
    _times: list = field(default_factory=list)
    _t0: float | None = None
    _count: int = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        self._count += 1
        if self._count > self.warmup:
            self._times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def mark_sync(self, scalar) -> float:
        """Fetch a one-element tensor (``.item()`` waits for the device) or
        a number, stop the timer and return the value."""
        v = float(scalar.item() if isinstance(scalar, torch.Tensor)
                  else scalar)
        self.stop()
        return v

    def summary(self, batch_size: int | None = None) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        out = {
            "mean_ms": 1000 * float(t.mean()),
            "p50_ms": 1000 * float(np.quantile(t, 0.5)),
            "p90_ms": 1000 * float(np.quantile(t, 0.9)),
            "p99_ms": 1000 * float(np.quantile(t, 0.99)),
        }
        if batch_size:
            out["ips"] = batch_size / float(t.mean())
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("traces/run1"):`` profiles the block and writes
    ``trace.json`` (Chrome trace format) into ``log_dir``; CUDA activity is
    recorded when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
