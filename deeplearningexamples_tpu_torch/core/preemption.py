"""Copy of ``deeplearningexamples_tpu/core/preemption.py``: graceful
preemption (SIGTERM → checkpoint-and-exit).

Reference: ConvNets ``TimeoutHandler`` (``image_classification/utils.py:
131-176``) catches SIGTERM on rank 0 and *broadcasts* the flag to all ranks
every 20 iterations so the DDP world exits in lockstep; BERT uses a
module-level ``timeout_sent`` flag (``run_pretraining.py:62-72``).

In one process the flag only gates the host-side loop between steps, so a
plain process-local signal handler suffices.
"""

from __future__ import annotations

import signal
from types import TracebackType

__all__ = ["TimeoutHandler"]


class TimeoutHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.interrupted = False
        self._orig: dict = {}

    def __enter__(self) -> "TimeoutHandler":
        self.interrupted = False
        for sig in self.signals:
            self._orig[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.interrupted = True

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc: BaseException | None,
        tb: TracebackType | None,
    ) -> None:
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)
        self._orig.clear()
