"""Port of ``deeplearningexamples_tpu/data/prefetch.py``'s ``background``:
a loader's batches made on a worker thread, ahead of the consumer.

JAX's ``prefetch_to_device`` is the port's ``cli.main.to_device``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

__all__ = ["background"]


def background(it: Iterable[Any], depth: int = 3) -> Iterator[Any]:
    """Run an iterable's production on a worker thread, ``depth`` items ahead.

    The role of the reference's DALI worker processes and DataLoader workers
    (``image_classification/dataloaders.py:354-409``): the host's decode and
    augmentation of batch N+1 overlap the card's compute of batch N. One
    thread is enough: file reads and the data plane's ctypes calls release
    the GIL, and the decode itself is parallel on the plane's threads. An
    error of the producer is raised in the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def produce():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:  # surface loader errors to the consumer
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
