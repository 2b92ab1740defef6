"""Generic epoch loop — train/validate/checkpoint/early-stop/preempt.

Port of ``deeplearningexamples_tpu/core/loop.py``: the per-batch mean
evaluation that BERT pretraining uses, the dataset-level reduction
(``eval_reduce``) with the target-metric stop that DLRM uses, and the
``eval_fn`` hook that SQuAD's EM/F1 uses. The steps are
plain PyTorch functions that return device tensors, and evaluation is handed
``state.model``.

The framework's single replacement for every recipe's hand-rolled outer loop
(ConvNets ``train_loop`` ``image_classification/training.py:314-432``, SSD
``ssd/train.py:21-71``, BERT ``run_pretraining.py:539-750``, Tacotron2
``train.py:457-540``, DLRM ``dlrm/scripts/main.py:560-630``):

- per-iteration data/compute time split + items/sec metering
  (``training.py:222-243``, ``calc_ips``)
- ``prof`` iteration cap for benchmark modes (``main.py:268-270``)
- periodic validation with a selectable watch metric; early stopping
  (ConvNets ``early_stopping_patience``, DLRM AUC threshold)
- rolling checkpoints + best tracking (``Checkpointer`` ``utils.py:39-80``)
- SIGTERM-safe: checkpoint-and-exit between steps (``TimeoutHandler``)
- under a data axis every rank runs the same steps and eval batches on its
  rows; eval outputs are gathered (``eval_reduce``) or averaged over the
  data axis, so each rank sees the global metrics; only rank 0 logs (the
  CLI's logger) and writes checkpoints (``CheckpointManager``)

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
import torch

from ..parallel.mesh import gather_data_rows, mean_over_data
from .checkpoint import CheckpointManager
from .logging import Logger
from .preemption import TimeoutHandler

__all__ = ["LoopConfig", "train_loop"]


@dataclass
class LoopConfig:
    epochs: int = 1
    prof: int = -1  # > 0: stop after N iterations per epoch (benchmark mode)
    log_interval: int = 20
    eval_interval_epochs: int = 1
    early_stop_patience: int = -1  # epochs without watch-metric improvement
    watch_metric: str = "top1"
    watch_mode: str = "max"  # max | min
    target_metric: float | None = None  # stop when reached (DLRM AUC style)


def train_loop(
    state,
    train_step: Callable,
    train_iter_fn: Callable[[], Iterable],
    *,
    cfg: LoopConfig,
    logger: Logger,
    eval_step: Callable | None = None,
    eval_iter_fn: Callable[[], Iterable] | None = None,
    eval_reduce: Callable[[dict], Mapping] | None = None,
    eval_fn: Callable[[object], Mapping] | None = None,
    checkpoints: CheckpointManager | None = None,
    batch_size: int | None = None,
    start_epoch: int = 0,
):
    """Run the full training. Returns (state, best_metric).

    Every ``cfg.eval_interval_epochs`` epochs, ``eval_step(model,
    model_state, batch)`` runs over ``eval_iter_fn()``. By default its
    per-batch scalars are averaged into ``val.*`` metrics. With
    ``eval_reduce``, its per-batch outputs (scalars or arrays, e.g. scores
    and labels) are gathered on the host and ``eval_reduce({key:
    concatenated ndarray}) -> {metric: scalar}`` computes dataset-level
    metrics once over the whole eval set (the reference's ``dist_evaluate``:
    DLRM's AUC over all eval scores, not a mean of per-batch values).
    On the same epochs ``eval_fn(state) -> {metric: scalar}`` adds its
    metrics as ``val.*`` (SQuAD's EM/F1 over a dev file). It runs with the
    training generator's state saved and put back, and the model's
    train/eval mode restored, so a run with it draws the same dropout bits as
    a run without it.
    ``cfg.watch_metric`` picks the metric that decides the best checkpoint,
    early stopping and the ``cfg.target_metric`` stop.
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
            is_eval_epoch = (epoch + 1) % cfg.eval_interval_epochs == 0
            val: dict[str, float] = {}
            if eval_step is not None and eval_iter_fn is not None and is_eval_epoch:
                agg: dict[str, list] = {}
                for batch in eval_iter_fn():
                    m = eval_step(state.model, state.model_state, batch)
                    # over the data axis: the global batch's rows, or the
                    # scalars' means (no-ops on one data rank)
                    m = ({k: gather_data_rows(torch.as_tensor(v).reshape(-1))
                          for k, v in m.items()} if eval_reduce
                         else mean_over_data(m))
                    for k, v in m.items():
                        agg.setdefault(k, []).append(
                            _to_numpy(v) if eval_reduce else float(v))
                if eval_reduce is not None and agg:
                    flat = {k: np.concatenate([np.atleast_1d(x) for x in v])
                            for k, v in agg.items()}
                    val.update({f"val.{k}": float(v)
                                for k, v in eval_reduce(flat).items()})
                elif eval_reduce is None:
                    val.update({f"val.{k}": float(np.mean(v))
                                for k, v in agg.items()})
            if eval_fn is not None and is_eval_epoch:
                training, rng = state.model.training, state.generator.get_state()
                try:
                    val.update({f"val.{k}": float(v)
                                for k, v in eval_fn(state).items()})
                finally:
                    state.model.train(training)
                    state.generator.set_state(rng)
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
                if cfg.target_metric is not None and (
                    (cfg.watch_mode == "max" and watch_value >= cfg.target_metric)
                    or (cfg.watch_mode == "min" and watch_value <= cfg.target_metric)
                ):
                    logger.log((epoch,), {"event": f"target {cfg.watch_metric} reached"})
                    stop = True
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


def _to_numpy(x) -> np.ndarray:
    """A device tensor (or number) as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _log_train(logger: Logger, metrics: Mapping, batch_size: int | None, t_step: float):
    loss = float(metrics["loss"])
    logger.record("train.loss", loss)
    logger.record("train.compute_time", t_step)
    if batch_size:
        logger.record("train.total_ips", batch_size / max(t_step, 1e-9))
