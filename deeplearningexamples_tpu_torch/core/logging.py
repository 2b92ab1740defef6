"""Copy of the parts of ``deeplearningexamples_tpu/core/logging.py`` that the
training loop uses: dllogger-compatible structured logging (numpy only).

NVIDIA's ``dllogger`` JSON-lines "raport" format (stdout + JSON-stream
backends, per-step ``log(step=..., data=...)`` — reference
``PyTorch/Classification/ConvNets/main.py:543-565``) and the per-interval
averaging of ``image_classification/logger.py`` (``Logger`` :213-337).

The JSON schema is kept drop-in compatible: each line is
``DLLL {"timestamp": ..., "type": "LOG", "step": ..., "data": {...}}`` so the
reference's downstream tooling can parse our raports unchanged.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, IO, Mapping, Sequence

import numpy as np

__all__ = ["AverageMeter", "JSONStreamBackend", "Logger", "StdOutBackend"]

PREFIX = "DLLL"


class AverageMeter:
    """The mean of the scalars recorded since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._n = 0

    def record(self, value: float, n: int = 1):
        self._sum += float(value) * n
        self._n += n

    def get(self):
        return self._sum / self._n if self._n else None


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class StdOutBackend:
    def __init__(self, stream: IO[str] | None = None):
        self.stream = stream or sys.stdout

    def log(self, timestamp: float, step: Any, data: Mapping[str, Any]) -> None:
        fields = " ".join(f"{k}: {_fmt(v)}" for k, v in data.items())
        step_s = "" if step == () else f"{step} "
        self.stream.write(f"{PREFIX} {step_s}{fields}\n")
        self.stream.flush()

    def flush(self) -> None:
        self.stream.flush()


class JSONStreamBackend:
    """JSON-lines raport file — the machine-readable experiment record."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self._f = open(path, "a" if append else "w")

    def log(self, timestamp: float, step: Any, data: Mapping[str, Any]) -> None:
        self._f.write(
            PREFIX
            + " "
            + json.dumps(
                {
                    "timestamp": timestamp,
                    "type": "LOG",
                    "step": step if not isinstance(step, tuple) else list(step),
                    "data": {k: _jsonable(v) for k, v in data.items()},
                }
            )
            + "\n"
        )
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:  # 0-d tensor
        return float(v)
    return v


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.5f}"
    return str(v)


# ---------------------------------------------------------------------------
# Logger
# ---------------------------------------------------------------------------


class Logger:
    """Rank-0 structured logger with per-iteration means.

    Mirrors reference ``Logger`` (logger.py:213-337): ``record`` values during
    iterations, and ``end_iteration``/``end`` emit aggregated lines to all
    backends. Construct with ``enabled=False`` on non-zero processes.
    """

    def __init__(self, backends: Sequence[Any] | None = None, enabled: bool = True):
        self.backends = list(backends or [])
        self.enabled = enabled
        self._meters: dict[str, AverageMeter] = {}
        self.start_time = time.time()

    def record(self, name: str, value: float, n: int = 1):
        self._meters.setdefault(name, AverageMeter()).record(value, n)

    def log(self, step: Any, data: Mapping[str, Any]) -> None:
        """Direct dllogger-style log of a dict at a step."""
        if not self.enabled:
            return
        ts = time.time()
        for b in self.backends:
            b.log(ts, step, data)

    def parameters(self, params: Mapping[str, Any]) -> None:
        """Config dump — reference convention ``step="PARAMETER"``."""
        self.log("PARAMETER", dict(params))

    def end_iteration(self, step: Any) -> dict:
        """Log the means recorded since the last call, and reset them."""
        data = {}
        for name, meter in self._meters.items():
            v = meter.get()
            if v is not None:
                data[name] = v
            meter.reset()
        if data:
            self.log(step, data)
        return data

    def end(self) -> None:
        if self.enabled:
            self.log((), {"summary": "run complete", "total_time": time.time() - self.start_time})
            for b in self.backends:
                b.flush()
