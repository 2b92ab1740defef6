"""The port's training CLI: ``python -m deeplearningexamples_tpu_torch.cli
<model> [flags]`` for ``bert-pretrain`` and ``dlrm``.

Port of ``deeplearningexamples_tpu/cli/main.py`` for the models the port
trains so far, BERT pretraining (``run_bert_pretrain``) and DLRM
(``run_dlrm``), with the flag spellings of ``dlx-train``. The run is on the
card unless ``--device cpu`` is given. Flags whose machinery is not ported
yet exit with a message that says so, rather than being ignored: for
``bert-pretrain`` ``--zero``, ``--remat``, ``--attention-impl xla|ring``,
``--binned``, ``--mesh-*`` and ``--data-backend corpus``; for ``dlrm``
``--data-backend binary`` and ``--mesh-model`` above 1. ``--config-file``,
``--platform`` and ``--precision`` (the YAML layers) are not flags here yet,
so argparse refuses them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from dataclasses import dataclass
from typing import Any

import torch

from ..core import config as cfgmod
from ..core.checkpoint import CheckpointManager
from ..core.logging import JSONStreamBackend, Logger, StdOutBackend
from ..core.loop import LoopConfig, train_loop
from ..core.optimizers import lr_poly_warmup
from ..core.train import create_train_state, make_eval_step, make_train_step

__all__ = ["BertCliConfig", "BertPretrainRun", "CommonConfig", "DlrmCliConfig",
           "DlrmRun", "MODELS", "build_bert_pretrain", "build_dlrm", "cli",
           "run_bert_pretrain", "run_dlrm", "to_device"]


@dataclass
class CommonConfig:
    epochs: int = 1
    batch_size: int = 32
    lr: float = 0.1
    weight_decay: float = 0.0
    seed: int = 0
    prof: int = -1
    mode: str = "train"  # train | benchmark-training | evaluate
    data_backend: str = "synthetic"
    data_dir: str = ""
    workspace: str = "./workspace"
    resume: bool = False
    accum_steps: int = 1
    steps_per_epoch: int = 100  # synthetic backend epoch length
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_sequence: int = 1
    amp: bool = True  # bf16 compute (reference AMP flag; bf16 needs no scaler)
    early_stopping_patience: int = -1
    device: str = "cuda"  # "cpu" runs the plain versions of the kernels


@dataclass
class BertCliConfig(CommonConfig):
    bert_model: str = "large"
    seq_len: int = 128
    max_predictions: int = 20
    remat: bool = False
    phase2: bool = False
    phase1_ckpt: str = ""  # phase2: init params from a phase-1 checkpoint
    zero: bool = False
    lamb_moments: str = "bf16"  # bf16 | fp32
    flat_lamb: bool = False  # flat buffer + the fused LAMB kernels (K3)
    binned: bool = False
    attention_impl: str = "flash"


@dataclass
class DlrmCliConfig(CommonConfig):
    num_tables: int = 26
    cardinality: int = 100_000  # uniform synthetic cardinality per table
    embedding_dim: int = 128
    auc_threshold: float = 0.0  # stop at target AUC (reference --auc_threshold)


def _unported(model: str, todo: list[tuple[bool, str]]) -> None:
    """Exit with a clear message on a flag whose machinery is not ported."""
    for bad, what in todo:
        if bad:
            raise SystemExit(f"{model}: {what} is not ported to the "
                             "PyTorch package yet (see ROADMAP.md)")


def _unported_bert(cfg: BertCliConfig) -> None:
    _unported("bert-pretrain", [
        (cfg.zero, "--zero (ZeRO-1 optimizer sharding)"),
        (cfg.remat, "--remat (activation checkpointing)"),
        (cfg.attention_impl != "flash",
         f"--attention-impl {cfg.attention_impl} (only flash is ported)"),
        (cfg.binned, "--binned (sequence-length binning needs the corpus "
                     "loader)"),
        (cfg.mesh_data not in (-1, 1) or cfg.mesh_model != 1
         or cfg.mesh_sequence != 1, "--mesh-* (one card only so far)"),
        (cfg.data_backend != "synthetic",
         f"--data-backend {cfg.data_backend} (only synthetic is ported)"),
    ])


def _common_setup(cfg: CommonConfig, name: str) -> Logger:
    logger = Logger(backends=[
        StdOutBackend(),
        JSONStreamBackend(f"{cfg.workspace}/{name}_raport.json"),
    ])
    logger.parameters(cfgmod.to_dict(cfg))
    return logger


def _loop_cfg(cfg: CommonConfig, watch="val_loss", mode="min") -> LoopConfig:
    bench = cfg.mode == "benchmark-training"
    return LoopConfig(
        epochs=cfg.epochs,
        prof=cfg.prof if cfg.prof > 0 else (100 if bench else -1),
        log_interval=1,  # every step, as the reference's --log_freq 1
        early_stop_patience=cfg.early_stopping_patience,
        watch_metric=watch,
        watch_mode=mode,
    )


def to_device(loader, device: str):
    """Numpy batches -> tensors on ``device``, copied from pinned memory on a
    card so the copy does not wait for the steps already queued."""
    pin = torch.device(device).type == "cuda"
    for batch in loader:
        yield {k: (torch.from_numpy(v).pin_memory() if pin else
                   torch.from_numpy(v)).to(device, non_blocking=pin)
               for k, v in batch.items()}


def _maybe_resume(cfg: CommonConfig, ckpt: CheckpointManager, state,
                  steps_per_epoch: int):
    """Restore the latest checkpoint and the epoch to resume at."""
    start_epoch = 0
    if cfg.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_epoch = int(state.step) // max(steps_per_epoch, 1)
    return state, start_epoch


@dataclass
class BertPretrainRun:
    """What ``run_bert_pretrain`` trains with, built by ``build_bert_pretrain``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any
    val_loader: Any


def build_bert_pretrain(cfg: BertCliConfig) -> BertPretrainRun:
    """The model, optimizer, state, step and loaders of ``bert-pretrain``."""
    from ..data.synthetic import SyntheticBertLoader
    from ..models.bert import BERT_CONFIGS, BertPretrainTask
    from ..ops.lamb import lamb

    _unported_bert(cfg)
    if cfg.phase2:
        cfg.seq_len, cfg.max_predictions = 512, 76
    bcfg = BERT_CONFIGS[cfg.bert_model]
    task = BertPretrainTask(bcfg, torch.bfloat16 if cfg.amp else torch.float32,
                            max_predictions=cfg.max_predictions)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    loader = SyntheticBertLoader(cfg.batch_size, cfg.seq_len, bcfg.vocab_size,
                                 cfg.max_predictions, steps=cfg.steps_per_epoch)
    val_loader = SyntheticBertLoader(cfg.batch_size, cfg.seq_len,
                                     bcfg.vocab_size, cfg.max_predictions,
                                     steps=5)
    total = cfg.epochs * len(loader)
    sched = lr_poly_warmup(cfg.lr, max(total // 100, 1), total)
    mdt = torch.bfloat16 if cfg.lamb_moments == "bf16" else torch.float32
    wd = cfg.weight_decay or 0.01
    if cfg.phase1_ckpt:
        # phase-2 chaining: parameters from phase 1, a fresh optimizer and
        # LR schedule for the s512 phase
        CheckpointManager(cfg.phase1_ckpt).restore_params(
            dict(model.named_parameters()))
    if cfg.flat_lamb:
        from ..core.flat import flatten_train
        from ..utils.jax_bridge import bert_pretrain_jax_order

        tx, params, _ = flatten_train(
            model, lr=sched, weight_decay=wd, moment_dtype=mdt,
            order=bert_pretrain_jax_order(bcfg.num_layers))
    else:
        params = dict(model.named_parameters())
        # reference no-decay group (run_pretraining.py:423-427): bias/gamma/
        # beta/LayerNorm = exactly the 1-D params; with use_nvlamb=False
        # those also take a plain-lr step (no trust ratio)
        tx = lamb(sched, weight_decay=wd, moment_dtype=mdt,
                  mask={n: p.ndim > 1 for n, p in params.items()})
    state = create_train_state(model, tx, cfg.seed + 1, params=params)
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return BertPretrainRun(task, tx, state, train_step, loader, val_loader)


def run_bert_pretrain(cfg: BertCliConfig):
    """Train BERT with MLM + NSP on synthetic data; returns ``(state,
    best mlm_acc)``."""
    logger = _common_setup(cfg, "bert_pretrain")
    run = build_bert_pretrain(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/bert_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    return train_loop(
        state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=_loop_cfg(cfg, watch="mlm_acc", mode="max"), logger=logger,
        eval_step=make_eval_step(run.task.metric_fn),
        eval_iter_fn=lambda: to_device(run.val_loader, cfg.device),
        checkpoints=ckpt, batch_size=cfg.batch_size, start_epoch=start_epoch,
    )


@dataclass
class DlrmRun:
    """What ``run_dlrm`` trains with, built by ``build_dlrm``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any
    val_loader: Any


def build_dlrm(cfg: DlrmCliConfig) -> DlrmRun:
    """The model, dual SGD, state, step and loaders of ``dlrm``: the
    synthetic Criteo-like loader over ``num_tables`` tables of
    ``cardinality`` rows, and 5 eval batches drawn with seed 1."""
    from ..data.synthetic import SyntheticDlrmLoader
    from ..models.dlrm import DlrmConfig, DlrmTask, make_dlrm_optimizer

    _unported("dlrm", [
        (cfg.data_backend != "synthetic",
         f"--data-backend {cfg.data_backend} (the Criteo binary reader needs "
         "a feature-spec reader without yaml; only synthetic is ported)"),
        (cfg.mesh_model > 1, "--mesh-model > 1 (the row-sharded table)"),
        (cfg.mesh_data not in (-1, 1) or cfg.mesh_sequence != 1,
         "--mesh-* (one card only so far)"),
    ])
    cards = tuple([int(cfg.cardinality)] * cfg.num_tables)
    task = DlrmTask(
        DlrmConfig(categorical_cardinalities=cards,
                   embedding_dim=cfg.embedding_dim,
                   bottom_mlp=(512, 256, cfg.embedding_dim)),
        torch.bfloat16 if cfg.amp else torch.float32)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    params = dict(model.named_parameters())
    tx = make_dlrm_optimizer(mlp_lr=cfg.lr, embedding_lr=cfg.lr)
    state = create_train_state(model, tx, cfg.seed + 1, params=params)
    loader = SyntheticDlrmLoader(cfg.batch_size, list(cards),
                                 steps=cfg.steps_per_epoch)
    val_loader = SyntheticDlrmLoader(cfg.batch_size, list(cards), steps=5,
                                     seed=1)
    train_step = make_train_step(task.loss_fn, tx)
    return DlrmRun(task, tx, state, train_step, loader, val_loader)


def run_dlrm(cfg: DlrmCliConfig):
    """Train DLRM with BCE and dual SGD on synthetic data, evaluating AUC
    over the whole eval set; returns ``(state, best auc)``."""
    logger = _common_setup(cfg, "dlrm")
    run = build_dlrm(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/dlrm_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    loop_cfg = _loop_cfg(cfg, watch="auc", mode="max")
    if cfg.auc_threshold > 0:
        loop_cfg = dataclasses.replace(loop_cfg, target_metric=cfg.auc_threshold)
    return train_loop(
        state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=loop_cfg, logger=logger,
        # dataset-level AUC over all eval scores (not a mean of per-batch AUCs)
        eval_step=make_eval_step(run.task.eval_collect_fn),
        eval_iter_fn=lambda: to_device(run.val_loader, cfg.device),
        eval_reduce=run.task.eval_reduce,
        checkpoints=ckpt, batch_size=cfg.batch_size, start_epoch=start_epoch,
    )


MODELS = {"bert-pretrain": run_bert_pretrain, "dlrm": run_dlrm}
_CONFIG_CLS = {"bert-pretrain": BertCliConfig, "dlrm": DlrmCliConfig}


def cli(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser("python -m deeplearningexamples_tpu_torch.cli")
    sub = parser.add_subparsers(dest="model", required=True)
    for name in MODELS:
        p = sub.add_parser(name)
        for f in dataclasses.fields(_CONFIG_CLS[name]):
            # a bool flag alone means true: --flat-lamb, --phase2
            bare = {"nargs": "?", "const": "true"} if str(f.type) == "bool" else {}
            p.add_argument(f"--{f.name.replace('_', '-')}", dest=f.name,
                           default=None, type=str, **bare)

    ns = parser.parse_args(argv)
    cls = _CONFIG_CLS[ns.model]
    cfg = cls()
    overrides = {}
    for f in dataclasses.fields(cls):
        v = getattr(ns, f.name, None)
        if v is None:
            continue
        parsed = cfgmod.parse_value(v)
        want = {"int": int, "float": float, "bool": bool, "str": str}.get(
            str(f.type), f.type)
        flag = f"--{f.name.replace('_', '-')}"
        if want in (int, float) and (isinstance(parsed, bool)
                                     or not isinstance(parsed, (int, float))):
            parser.error(f"{flag} expects a {want.__name__}, got {v!r}")
        if want is int and isinstance(parsed, float):
            parser.error(f"{flag} expects an int, got {v!r}")
        if want is float:
            parsed = float(parsed)
        if want is bool and not isinstance(parsed, bool):
            parser.error(f"{flag} expects true/false, got {v!r}")
        if want is str:
            parsed = v
        overrides[f.name] = parsed
    cfg = cfgmod.merge(cfg, overrides)
    os.makedirs(cfg.workspace, exist_ok=True)
    return MODELS[ns.model](cfg)


if __name__ == "__main__":
    cli()
