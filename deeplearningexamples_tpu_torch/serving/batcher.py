"""Continuous batcher: dynamic request batching for a batched model call.

Port of ``deeplearningexamples_tpu/serving/batcher.py`` (the stand-in for
Triton's dynamic batcher). A request is a dict of numpy arrays without the
batch dim. A dispatcher thread drains the queue, stacks and pads the requests
to the nearest batch bucket, calls ``infer_fn`` on the batched dict, and
resolves each request's future with its row of every output. ``infer_fn``
may return numpy arrays or tensors on any device; tensors are copied to the
host, which also waits for the device.

``max_delay_s`` bounds the latency added when traffic is sparse. ``warmup``
runs one batch per bucket on the dispatcher thread before serving starts, so
that the kernels' builds and first launches, and the per-thread handles the
CUDA libraries make on a thread's first call (cuBLAS, cuDNN), are not paid
by the first requests.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

__all__ = ["ContinuousBatcher"]

Arrays = Mapping[str, Any]


@dataclass
class _Request:
    inputs: Arrays  # name -> np array WITHOUT batch dim
    future: Future
    t_enqueue: float = 0.0


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ContinuousBatcher:
    def __init__(
        self,
        infer_fn: Callable[[dict[str, np.ndarray]], Arrays],
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
        max_delay_s: float = 0.002,
        pad_value: float = 0.0,
    ):
        self.infer_fn = infer_fn
        self.buckets = sorted(batch_buckets)
        self.max_delay_s = max_delay_s
        self.pad_value = pad_value
        # requests, warmups (run on this thread) and None (stop)
        self._q: queue.Queue[_Request | Callable[[], None] | None] = \
            queue.Queue()
        # latency decomposition: batcher wait = enqueue -> dispatch start;
        # device time = model call + copy of the outputs to the host.
        # Rolling per-dispatch records.
        self._stats_lock = threading.Lock()
        self._records: list[tuple[int, float, float]] = []  # (n, wait, device)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._thread.start()

    def _run(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        return {k: _to_numpy(v) for k, v in dict(self.infer_fn(batch)).items()}

    def warmup(self, example_inputs: Arrays) -> None:
        """Run one inference per batch bucket on the dispatcher thread and
        wait for it; raises what the model call raised."""
        done: Future = Future()

        def run():
            try:
                for b in self.buckets:
                    self._run({k: np.stack([np.asarray(x)] * b)
                               for k, x in example_inputs.items()})
                done.set_result(None)
            except Exception as e:  # noqa: BLE001 - raised to the caller
                done.set_exception(e)

        self._q.put(run)
        done.result()

    # -- client side -------------------------------------------------------
    def submit(self, inputs: Arrays) -> Future:
        fut: Future = Future()
        self._q.put(_Request(inputs, fut, time.perf_counter()))
        return fut

    def stats(self, reset: bool = False) -> dict:
        """Per-dispatch latency split: mean/p50/p95 of batcher wait (queueing
        + bucket fill) and device time (model call + output copy), plus the
        mean dispatched batch size. Times in milliseconds."""
        with self._stats_lock:
            recs = list(self._records)
            if reset:
                self._records.clear()
        if not recs:
            return {"dispatches": 0}
        waits = np.asarray([r[1] for r in recs]) * 1e3
        devs = np.asarray([r[2] for r in recs]) * 1e3
        return {
            "dispatches": len(recs),
            "mean_batch": float(np.mean([r[0] for r in recs])),
            "wait_ms_mean": float(waits.mean()),
            "wait_ms_p50": float(np.percentile(waits, 50)),
            "wait_ms_p95": float(np.percentile(waits, 95)),
            "device_ms_mean": float(devs.mean()),
            "device_ms_p50": float(np.percentile(devs, 50)),
            "device_ms_p95": float(np.percentile(devs, 95)),
        }

    def infer(self, inputs: Arrays, timeout: float | None = None) -> dict:
        return self.submit(inputs).result(timeout)

    def close(self) -> None:
        self._running = False
        self._q.put(None)
        self._thread.join(timeout=5)

    # -- dispatcher --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        while self._running:
            req = self._q.get()
            if req is None:
                break
            if callable(req):  # a warmup
                req()
                continue
            batch = [req]
            deadline = time.perf_counter() + self.max_delay_s
            max_b = self.buckets[-1]
            while len(batch) < max_b:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                if callable(nxt):
                    nxt()
                    continue
                batch.append(nxt)
            self._dispatch(batch)

    def _dispatch(self, batch: list[_Request]) -> None:
        n = len(batch)
        b = self._bucket(n)
        t_start = time.perf_counter()
        wait = float(np.mean([t_start - r.t_enqueue for r in batch]))
        try:
            stacked = {
                k: self._pad_stack([r.inputs[k] for r in batch], b)
                for k in batch[0].inputs
            }
            out_np = self._run(stacked)
            with self._stats_lock:
                self._records.append((n, wait, time.perf_counter() - t_start))
                if len(self._records) > 10000:
                    del self._records[:5000]
            for i, r in enumerate(batch):
                r.future.set_result({k: v[i] for k, v in out_np.items()})
        except Exception as e:  # resolve all futures with the error
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    def _pad_stack(self, xs: Sequence[np.ndarray], bucket: int) -> np.ndarray:
        arr = np.stack([np.asarray(x) for x in xs])
        if arr.shape[0] < bucket:
            pad = np.full(
                (bucket - arr.shape[0],) + arr.shape[1:],
                self.pad_value,
                arr.dtype,
            )
            arr = np.concatenate([arr, pad])
        return arr
