"""Generic epoch loop — train/validate/checkpoint/early-stop/preempt.

Port of ``deeplearningexamples_tpu/core/loop.py`` for the per-batch
evaluation that BERT pretraining uses. The steps are plain PyTorch functions
that return 0-d device tensors, and evaluation is handed ``state.model``.

The framework's single replacement for every recipe's hand-rolled outer loop
(ConvNets ``train_loop`` ``image_classification/training.py:314-432``, SSD
``ssd/train.py:21-71``, BERT ``run_pretraining.py:539-750``, Tacotron2
``train.py:457-540``, DLRM ``dlrm/scripts/main.py:560-630``):

- per-iteration data/compute time split + items/sec metering
  (``training.py:222-243``, ``calc_ips``)
- ``prof`` iteration cap for benchmark modes (``main.py:268-270``)
- validation every epoch with a selectable watch metric; early stopping
  (ConvNets ``early_stopping_patience``)
- rolling checkpoints + best tracking (``Checkpointer`` ``utils.py:39-80``)
- SIGTERM-safe: checkpoint-and-exit between steps (``TimeoutHandler``)

The loop is deliberately host-side and dumb: all compute lives in
``train_step``/``eval_step``; the loop only feeds batches and fetches scalars
late (metrics of step N are read when step N+1 is dispatched, keeping the
device queue busy — the role of the reference's pinned-memory
``SyncFreeStats``, ``run_pretraining.py:98-120``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Mapping

import numpy as np

from .checkpoint import CheckpointManager
from .logging import Logger
from .preemption import TimeoutHandler

__all__ = ["LoopConfig", "train_loop"]


@dataclass
class LoopConfig:
    epochs: int = 1
    prof: int = -1  # > 0: stop after N iterations per epoch (benchmark mode)
    log_interval: int = 20
    early_stop_patience: int = -1  # epochs without watch-metric improvement
    watch_metric: str = "top1"
    watch_mode: str = "max"  # max | min


def train_loop(
    state,
    train_step: Callable,
    train_iter_fn: Callable[[], Iterable],
    *,
    cfg: LoopConfig,
    logger: Logger,
    eval_step: Callable | None = None,
    eval_iter_fn: Callable[[], Iterable] | None = None,
    checkpoints: CheckpointManager | None = None,
    batch_size: int | None = None,
    start_epoch: int = 0,
):
    """Run the full training. Returns (state, best_metric).

    After each epoch, ``eval_step(model, model_state, batch)`` runs over
    ``eval_iter_fn()`` and its per-batch scalars are averaged into
    ``val.*`` metrics; ``cfg.watch_metric`` picks the one that decides the
    best checkpoint and early stopping.
    """
    best = -np.inf if cfg.watch_mode == "max" else np.inf
    stale_epochs = 0
    stop = False

    with TimeoutHandler() as timeout:
        for epoch in range(start_epoch, cfg.epochs):
            # ---- train -------------------------------------------------
            it = iter(train_iter_fn())
            prev_metrics = None
            step_in_epoch = 0
            t_data0 = time.perf_counter()
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t_data1 = time.perf_counter()
                state, metrics = train_step(state, batch)
                # fetch previous step's scalars (device queue stays busy)
                if prev_metrics is not None:
                    _log_train(logger, prev_metrics, batch_size, t_step)
                prev_metrics = metrics
                t_step = time.perf_counter() - t_data1
                logger.record("train.data_time", t_data1 - t_data0)
                step_in_epoch += 1
                if step_in_epoch % cfg.log_interval == 0:
                    logger.end_iteration((epoch, step_in_epoch))
                if cfg.prof > 0 and step_in_epoch >= cfg.prof:
                    break
                if timeout.interrupted:
                    break
                t_data0 = time.perf_counter()
            if prev_metrics is not None:
                _log_train(logger, prev_metrics, batch_size, t_step)
                logger.end_iteration((epoch, step_in_epoch))

            if timeout.interrupted:
                logger.log((epoch,), {"event": "SIGTERM -> checkpoint and exit"})
                if checkpoints is not None:
                    checkpoints.save(int(state.step), state)
                return state, best

            # ---- validate ----------------------------------------------
            watch_value = None
            val: dict[str, float] = {}
            if eval_step is not None and eval_iter_fn is not None:
                agg: dict[str, list] = {}
                for batch in eval_iter_fn():
                    m = eval_step(state.model, state.model_state, batch)
                    for k, v in m.items():
                        agg.setdefault(k, []).append(float(v))
                val.update({f"val.{k}": float(np.mean(v)) for k, v in agg.items()})
            if val:
                logger.log((epoch,), val)
                watch_value = val.get(f"val.{cfg.watch_metric}")

            # ---- track best / early stop -------------------------------
            if watch_value is not None:
                better = (
                    watch_value > best if cfg.watch_mode == "max" else watch_value < best
                )
                if better:
                    best, stale_epochs = watch_value, 0
                else:
                    stale_epochs += 1
                if 0 < cfg.early_stop_patience <= stale_epochs:
                    logger.log((epoch,), {"event": "early stopping"})
                    stop = True

            # ---- checkpoint --------------------------------------------
            if checkpoints is not None:
                checkpoints.save(int(state.step), state, metric=watch_value)

            if stop:
                break

    logger.end()
    return state, best


def _log_train(logger: Logger, metrics: Mapping, batch_size: int | None, t_step: float):
    loss = float(metrics["loss"])
    logger.record("train.loss", loss)
    logger.record("train.compute_time", t_step)
    if batch_size:
        logger.record("train.total_ips", batch_size / max(t_step, 1e-9))
