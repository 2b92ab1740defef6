"""The port's training CLI: ``python -m deeplearningexamples_tpu_torch.cli
<model> [flags]`` for ``resnet50``, ``resnext101-32x4d``,
``se-resnext101-32x4d``, ``efficientnet-b0``, ``efficientnet-b4``,
``gpunet-0``, ``gpunet-1``, ``gpunet-2``, ``ssd300``, ``efficientdet``,
``bert-pretrain``, ``bert-squad``, ``bert-glue``, ``bert-swag``,
``dlrm``, ``tacotron2``, ``waveglow``, ``transformer``, ``bart``,
``gnmt``, ``fastpitch``, ``hifigan``, ``jasper``, ``wav2vec2``, ``ncf``,
``tft``, ``nnunet``, ``transformer-xl``, ``moflow``, ``maskrcnn`` and
``se3-transformer``: all 31 of ``dlx-train``'s commands.

Port of ``deeplearningexamples_tpu/cli/main.py`` for the models the port
trains so far, the ConvNets and GPUNets (``run_convnet``, on synthetic
images or ImageNet's class folders), SSD300 (``run_ssd``, on synthetic
images or COCO with its mAP), EfficientDet-D0 (``run_efficientdet``),
Mask R-CNN (``run_maskrcnn``, on synthetic batches or COCO with its box and
mask mAP), BERT
pretraining (``run_bert_pretrain``), BERT fine-tuning on SQuAD, GLUE and SWAG
(``run_bert_squad``, ``run_bert_glue``, ``run_bert_swag``), DLRM
(``run_dlrm``), Tacotron2 and WaveGlow (``run_tts``), the Transformer NMT
(``run_transformer``), BART (``run_bart``: denoising pretraining or
summarization with beam-decoded ROUGE), GNMT, FastPitch, Jasper,
wav2vec 2.0, nnU-Net, Transformer-XL, MoFlow and the SE(3)-Transformer
(``run_breadth``),
HiFi-GAN (``run_hifigan``), NCF (``run_ncf``) and TFT (``run_tft``, on a
synthetic or ``.npy`` panel, with the test split's forecast metrics), with the
flag names and defaults of ``dlx-train``. The run is
on the card unless ``--device cpu`` is given.

Under ``torchrun`` (``python -m torch.distributed.run --nproc-per-node N -m
deeplearningexamples_tpu_torch.cli ...``) each process drives one card and
the ranks form JAX's ``(data, model, sequence)`` mesh from ``--mesh-*``
(``parallel/``): ``--batch-size`` is the global batch, each data rank trains
on its rows of it, and a step computes what JAX's program computes on the
global batch: its loss denominators, BN statistics and random draws are the
global batch's, and its eval metrics come from every rank's rows. Every
command takes the data axis. ``dlrm`` (``--mesh-model`` row-shards its
table) and ``bert-pretrain`` shard along the model or sequence axis; every
other command repeats the data rank's work on each rank of those axes, as
JAX does, and its ranks end each step with equal parameters.
``bert-pretrain`` takes ``--zero`` (ZeRO-1) and the sequence axis:
``--attention-impl ring --mesh-sequence N`` splits each layer's attention
over the N ranks of a sequence line (``ops/ring_attention.py``), which hold
the same rows of the batch, draw the same dropout masks and keep the same
parameters (``--mesh-sequence N`` with ``flash`` or ``xla`` repeats the
same work on each, as in JAX). Only rank 0 logs and writes checkpoints.

Flags whose machinery is not ported yet exit with a message that says so,
rather than being ignored:
for ``ssd300``, ``efficientdet`` and ``maskrcnn`` a ``--data-backend`` other than
synthetic and coco; for ``bert-pretrain`` ``--zero`` with
``--flat-lamb``; for the fine-tuning commands an
``--init-checkpoint`` in TF format. argparse refuses ``--zero`` for the
fine-tuning commands, which ``dlx-train`` does not give them either.

Every command takes ``--config-file`` (a ``configs.yml``-style file),
``--platform`` and ``--precision``, resolved as ``dlx-train`` does: the
config class's defaults, then the file's precision, platform and model
layers for the command (``core.config.resolve``), then the flags. A key of
the file that the command's config lacks raises ``KeyError``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import config as cfgmod
from ..core.checkpoint import CheckpointManager
from ..core.logging import JSONStreamBackend, Logger, StdOutBackend
from ..core.loop import LoopConfig, train_loop
from ..core import optimizers as opt
from ..core.optimizers import adamw, bert_adam, lr_poly_warmup
from ..core.train import create_train_state, make_eval_step, make_train_step
from ..parallel.dist import device_for_rank, initialize_distributed
from ..parallel.mesh import (DATA_AXIS, MeshSpec, batch_positions,
                             build_mesh, check_batch_split, current_mesh,
                             data_rows, gather_data_rows, gather_objects,
                             rank_rows, shard_batch)

__all__ = ["BartCliConfig", "BertCliConfig", "BertPretrainRun", "BreadthRun",
           "CommonConfig", "ConvNetCliConfig", "ConvNetRun", "DlrmCliConfig",
           "DlrmRun", "DetectorCliConfig", "FinetuneRun", "GlueCliConfig",
           "MODELS", "NcfRun", "Seq2SeqRun",
           "SgdCliConfig", "SquadCliConfig", "SsdRun", "SwagCliConfig",
           "TftRun", "TtsRun", "build_bert_pretrain", "build_bert_squad",
           "build_breadth", "build_convnet", "build_dlrm", "build_ncf",
           "build_ssd", "build_tft", "build_transformer", "build_tts", "cli",
           "featurize_swag", "read_swag", "run_bert_glue",
           "run_bert_pretrain", "run_bert_squad", "run_bert_swag",
           "run_bart", "run_breadth", "run_convnet", "run_dlrm",
           "run_efficientdet", "run_hifigan", "run_maskrcnn", "run_ncf",
           "run_ssd",
           "run_tft", "run_transformer", "run_tts", "tft_test_metrics",
           "to_device"]

INPUTS = ("input_ids", "attention_mask", "token_type_ids")
# run_convnet lets cuDNN pick its algorithms by timing them, as the
# reference's main.py does; a run that only checks correctness may set this
# False and skip the autotuning (about 50 s for an EfficientNet's depthwise
# convolutions at a new batch)
CUDNN_BENCHMARK = True


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
class SgdCliConfig(CommonConfig):
    """The fields of JAX's ``CommonConfig`` that ``run_ssd`` reads beyond
    the port's ``CommonConfig`` (SGD's momentum and the LR policy), with
    JAX's defaults."""

    momentum: float = 0.9
    warmup_epochs: int = 0
    lr_schedule: str = "cosine"  # cosine | step | linear | constant


@dataclass
class ConvNetCliConfig(SgdCliConfig):
    """The fields of JAX's ``CommonConfig`` that ``run_convnet`` reads
    beyond ``SgdCliConfig``'s, with JAX's defaults."""

    label_smoothing: float = 0.0
    mixup: float = 0.0
    ema: float = 0.0  # 0 disables; reference EMA decay e.g. 0.9999
    # "" (fp) or "qat": int8 fake-quant convs during training
    quant_policy: str = ""


@dataclass
class DetectorCliConfig(SgdCliConfig):
    """``efficientdet``'s and ``maskrcnn``'s config: JAX's ``CommonConfig``
    fields that ``run_efficientdet`` and ``run_maskrcnn`` read, with JAX's
    defaults."""

    image_size: int = 0  # 0: EfficientDet-D0's 512, Mask R-CNN's 800


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
        (cfg.data_backend not in ("synthetic", "corpus"),
         f"--data-backend {cfg.data_backend} (synthetic and corpus are "
         "ported)"),
    ])


def _unported_coco(model: str, cfg: CommonConfig) -> None:
    """Refuse a ``--data-backend`` other than synthetic and coco."""
    _unported(model, [
        (cfg.data_backend not in ("synthetic", "coco"),
         f"--data-backend {cfg.data_backend} (synthetic and coco are "
         "ported)"),
    ])


def _dtype(cfg: CommonConfig) -> torch.dtype:
    """The compute dtype: bf16 under ``--amp`` (the default), else fp32."""
    return torch.bfloat16 if cfg.amp else torch.float32


def _common_setup(cfg: CommonConfig, name: str,
                  accum_steps: int | None = None) -> Logger:
    """Join ``torchrun``'s process group if there is one (each rank on its
    card), build the ``--mesh-*`` mesh over the ranks (1 x 1 x 1 without
    one), and the logger: only rank 0 logs, as in JAX. A ``--batch-size``
    that does not split evenly over the data ranks and the step's
    microbatches (``accum_steps``, ``cfg.accum_steps`` by default) raises."""
    initialize_distributed(device=cfg.device)
    if torch.distributed.is_initialized():
        cfg.device = str(device_for_rank(cfg.device))
    mesh = build_mesh(MeshSpec(data=cfg.mesh_data, model=cfg.mesh_model,
                               sequence=cfg.mesh_sequence))
    check_batch_split(cfg.batch_size, accum_steps or cfg.accum_steps)
    logger = Logger(backends=[
        StdOutBackend(),
        JSONStreamBackend(f"{cfg.workspace}/{name}_raport.json"),
    ] if mesh.is_primary else [], enabled=mesh.is_primary)
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


def to_device(loader, device: str, accum_steps: int = 1,
              shard: bool = True):
    """Batches -> tensors on ``device``: under a data axis this rank's
    rows of each global batch first (``parallel.mesh.shard_batch``, its
    slice of each of ``accum_steps`` microbatches; ``shard=False`` for a
    loader that makes only this rank's rows); numpy arrays copied from pinned
    memory on a card, so the copy does not wait for the steps already
    queued; tensors moved (the card's data plane puts its images there
    already); anything else (SSD300's eval ``gt`` list, EfficientDet's
    ``n_valid``) left on the host as it is."""
    pin = torch.device(device).type == "cuda"

    def put(v):
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            return (t.pin_memory() if pin else t).to(device, non_blocking=pin)
        if isinstance(v, torch.Tensor):
            return v.to(device, non_blocking=pin)
        return v

    for batch in loader:
        if shard:
            batch = shard_batch(batch, accum_steps)
        yield {k: put(v) for k, v in batch.items()}


def _maybe_resume(cfg: CommonConfig, ckpt: CheckpointManager, state,
                  steps_per_epoch: int):
    """Restore the latest checkpoint and the epoch to resume at."""
    start_epoch = 0
    if cfg.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_epoch = int(state.step) // max(steps_per_epoch, 1)
    return state, start_epoch


def _make_schedule(cfg: SgdCliConfig, steps_per_epoch: int):
    """The LR policy ``--lr-schedule`` names (JAX ``_make_schedule``)."""
    if cfg.lr_schedule == "cosine":
        return opt.lr_cosine_policy(cfg.lr, cfg.warmup_epochs, cfg.epochs,
                                    steps_per_epoch)
    if cfg.lr_schedule == "linear":
        return opt.lr_linear_policy(cfg.lr, cfg.warmup_epochs, cfg.epochs,
                                    steps_per_epoch)
    if cfg.lr_schedule == "step":
        return opt.lr_step_policy(cfg.lr, [30, 60, 80], 0.1, cfg.warmup_epochs,
                                  steps_per_epoch)
    return lambda step: cfg.lr


@dataclass
class ConvNetRun:
    """What ``run_convnet`` trains with, built by ``build_convnet``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any
    val_loader: Any
    real_data: bool = False  # the loaders read files: run them on a thread


def build_convnet(arch: str, cfg: ConvNetCliConfig) -> ConvNetRun:
    """The model, SGD, state, step and loaders of a ConvNets command: the
    arch's own image size (224, an EfficientNet's or a GPUNet's
    resolution), 1000 classes; on the synthetic backend one batch repeated
    ``steps_per_epoch`` times and a 10-batch eval loader, on any other the
    ``train/`` and ``val/`` class folders under ``--data-dir``
    (``ImageNetLoader`` on the data plane of ``--device``), as JAX's
    ``run_convnet``."""
    from ..data.synthetic import SyntheticImageLoader
    from ..models.convnets import EFFNET_ARCHS, GPUNET_ARCHS, ClassificationTask

    if arch in EFFNET_ARCHS:
        image_size = EFFNET_ARCHS[arch].resolution
    elif arch in GPUNET_ARCHS:
        image_size = GPUNET_ARCHS[arch].resolution
    else:
        image_size = 224
    task = ClassificationTask(arch, _dtype(cfg),
                              quantized=cfg.quant_policy == "qat",
                              label_smoothing=cfg.label_smoothing,
                              mixup_alpha=cfg.mixup)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    real = cfg.data_backend != "synthetic"
    if real:
        from ..data.imagenet import ImageNetLoader

        # each rank reads and decodes only its rows of a batch
        loader, val_loader = (
            ImageNetLoader(cfg.data_dir, split, cfg.batch_size, image_size,
                           device=cfg.device, rows=_local_rows(cfg, accum))
            for split, accum in (("train", cfg.accum_steps), ("val", 1)))
    else:
        loader = SyntheticImageLoader(cfg.batch_size, image_size, 1000,
                                      steps=cfg.steps_per_epoch)
        val_loader = SyntheticImageLoader(cfg.batch_size, image_size, 1000,
                                          steps=10)
    params = dict(model.named_parameters())
    tx = opt.sgd(_make_schedule(cfg, len(loader)), cfg.momentum,
                 cfg.weight_decay, mask=opt.no_decay_mask(params))
    state = create_train_state(model, tx, cfg.seed + 1, params=params,
                               model_state=task.model_state(model),
                               ema=cfg.ema > 0)
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps,
                                 ema_decay=cfg.ema if cfg.ema > 0 else None)
    return ConvNetRun(task, tx, state, train_step, loader, val_loader, real)


def _local_rows(cfg: CommonConfig, accum_steps: int):
    """The positions of this rank's rows in a batch, for a file reader that
    reads only those (None on one data rank)."""
    if current_mesh().size(DATA_AXIS) == 1:
        return None
    return batch_positions(cfg.batch_size, accum_steps)


def _feed(loader, device: str, real: bool, accum_steps: int = 1,
          shard: bool = False):
    """A loader's batches on ``device``; a loader that reads files runs on a
    worker thread (``data.prefetch.background``), as JAX's does, and makes
    only this rank's rows, unless ``shard`` (one that reads the whole batch,
    whose rows ``to_device`` then takes)."""
    from ..data.prefetch import background

    if real:
        return to_device(background(iter(loader)), device, accum_steps,
                         shard=shard)
    return to_device(loader, device, accum_steps)


def run_convnet(arch: str, cfg: ConvNetCliConfig):
    """Train a ConvNets model with (smoothed) CE, mixup and SGD on synthetic
    images or ImageNet's class folders, with top1, top5 and ``val_loss``
    each epoch; returns ``(state, best top1)``. cuDNN picks its algorithms
    by timing them (``cudnn.benchmark``) for the run, as the reference's
    ``main.py`` does."""
    logger = _common_setup(cfg, arch)
    run = build_convnet(arch, cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/{arch}_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = CUDNN_BENCHMARK
    try:
        return train_loop(
            state, run.train_step,
            lambda: _feed(run.loader, cfg.device, run.real_data,
                          cfg.accum_steps),
            cfg=_loop_cfg(cfg, watch="top1", mode="max"), logger=logger,
            eval_step=make_eval_step(run.task.metric_fn),
            eval_iter_fn=lambda: _feed(run.val_loader, cfg.device,
                                       run.real_data),
            checkpoints=ckpt, batch_size=cfg.batch_size,
            start_epoch=start_epoch,
        )
    finally:
        torch.backends.cudnn.benchmark = benchmark


@dataclass
class SsdRun:
    """What ``run_ssd`` trains with, built by ``build_ssd``."""

    state: Any
    train_step: Any
    loader: Any
    task: Any = None
    val_loader: Any = None  # COCO's val2017 on the coco backend, else None


def build_ssd(cfg: SgdCliConfig) -> SsdRun:
    """SSD300 (81 classes, 300x300, ``SSDTask``'s color twist), SGD with the
    reference's "tencent trick" (no weight decay on biases and BN), the
    state and step, and on the synthetic backend one batch repeated
    ``steps_per_epoch`` times, on ``coco`` ``train2017`` and ``val2017``
    with ``annotations/instances_*2017.json`` under ``--data-dir``
    (``CocoSSDLoader`` on the data plane of ``--device``), as JAX's
    ``run_ssd``."""
    from ..data.ssd_synthetic import SyntheticSSDLoader
    from ..models.ssd import SSDTask

    _unported_coco("ssd300", cfg)
    task = SSDTask(dtype=_dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    val_loader = None
    if cfg.data_backend == "coco":
        from ..data.coco import CocoDetectionDataset, CocoSSDLoader

        def split(name):
            return CocoDetectionDataset(
                f"{cfg.data_dir}/{name}2017",
                f"{cfg.data_dir}/annotations/instances_{name}2017.json")

        loader = CocoSSDLoader(split("train"), cfg.batch_size, task.dboxes,
                               device=cfg.device,
                               rows=_local_rows(cfg, cfg.accum_steps))
        val_loader = CocoSSDLoader(split("val"), cfg.batch_size, task.dboxes,
                                   train=False, device=cfg.device,
                                   rows=_local_rows(cfg, 1))
    else:
        loader = SyntheticSSDLoader(cfg.batch_size, task.dboxes,
                                    steps=cfg.steps_per_epoch)
    params = dict(model.named_parameters())
    tx = opt.sgd(_make_schedule(cfg, len(loader)), cfg.momentum,
                 cfg.weight_decay, mask=opt.no_decay_mask(params))
    state = create_train_state(model, tx, cfg.seed + 1, params=params,
                               model_state=task.model_state(model))
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return SsdRun(state, train_step, loader, task, val_loader)


def run_ssd(cfg: SgdCliConfig):
    """Train SSD300 with the MultiBox loss and SGD, with checkpoints in
    ``{workspace}/ssd300_ckpt``. On synthetic images there is no evaluation
    (JAX's synthetic path has none); on COCO each eval epoch scores COCO
    mAP on val2017 (``evaluate_ssd``, reference ``SSD/main.py:224-228``)
    and the best checkpoint is the highest ``mAP``. cuDNN picks its
    algorithms by timing them, as the reference's ``main.py`` does. Returns
    ``(state, best)``."""
    from ..models.ssd.evaluate import evaluate_ssd

    logger = _common_setup(cfg, "ssd300")
    run = build_ssd(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/ssd300_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        real = run.val_loader is not None
        return train_loop(
            state, run.train_step,
            lambda: _feed(run.loader, cfg.device, real, cfg.accum_steps),
            cfg=_loop_cfg(cfg, *(("mAP", "max") if real else ())),
            logger=logger, checkpoints=ckpt, batch_size=cfg.batch_size,
            start_epoch=start_epoch,
            eval_fn=(lambda state: evaluate_ssd(run.task, state.model,
                                                run.val_loader))
            if real else None,
        )
    finally:
        torch.backends.cudnn.benchmark = benchmark


@dataclass
class BertPretrainRun:
    """What ``run_bert_pretrain`` trains with, built by ``build_bert_pretrain``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any
    val_loader: Any


def _corpus_loaders(cfg: BertCliConfig, vocab_size: int):
    """``--data-backend corpus``, as JAX's ``run_bert_pretrain``: documents
    from the ``shard_*.npz`` files in ``--data-dir`` (``prepare_corpus``),
    the last ``max(2, len(docs) // 100)`` held out for validation (10
    batches at ``seed + 7``), the rest masked online, batches padded to
    ``seq_len`` or, with ``--binned``, to their length bucket (a multiple of
    64). An epoch covers the corpus unless ``--mode`` is not train, when it
    is ``--steps-per-epoch`` batches."""
    from ..data.bert_prep import load_corpus_shards
    from ..data.bert_pretrain import (
        BertPretrainLoader,
        BinnedBertPretrainLoader,
        MaskingConfig,
    )

    mesh = current_mesh()
    k = mesh.size(DATA_AXIS)
    # each data rank reads its own shard files, as each of JAX's processes
    # does, and makes its rows (--batch-size / ranks) of a global batch
    check_batch_split(cfg.batch_size)
    docs = load_corpus_shards(cfg.data_dir,
                              shard=(mesh.index(DATA_AXIS), k))
    n_eval = max(2, len(docs) // 100)
    mcfg = MaskingConfig(vocab_size=vocab_size,
                         max_predictions_per_seq=cfg.max_predictions)
    loader_cls = BinnedBertPretrainLoader if cfg.binned else BertPretrainLoader
    loader = loader_cls(
        docs[:-n_eval], cfg.batch_size // k, cfg.seq_len, mcfg, seed=cfg.seed,
        steps_per_epoch=cfg.steps_per_epoch if cfg.mode != "train" else None)
    val_loader = BertPretrainLoader(docs[-n_eval:], cfg.batch_size // k,
                                    cfg.seq_len, mcfg, seed=cfg.seed + 7,
                                    steps_per_epoch=10)
    return loader, val_loader


def build_bert_pretrain(cfg: BertCliConfig) -> BertPretrainRun:
    """The model, optimizer, state, step and loaders of ``bert-pretrain``:
    synthetic batches, or with ``--data-backend corpus`` a tokenized corpus
    (``_corpus_loaders``; ``--binned`` bins only its batches, as in JAX);
    ``--remat`` checkpoints each encoder layer (recomputed whole),
    ``--attention-impl xla`` runs attention in plain ops and ``ring`` over
    the mesh's sequence axis, as JAX's config fields do."""
    from ..data.synthetic import SyntheticBertLoader
    from ..models.bert import BERT_CONFIGS, BertPretrainTask
    from ..ops.lamb import lamb

    _unported_bert(cfg)
    if cfg.phase2:
        cfg.seq_len, cfg.max_predictions = 512, 76
    bcfg = dataclasses.replace(BERT_CONFIGS[cfg.bert_model], remat=cfg.remat,
                               attention_impl=cfg.attention_impl)
    task = BertPretrainTask(bcfg, _dtype(cfg), max_predictions=cfg.max_predictions)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    if cfg.data_backend == "corpus":
        loader, val_loader = _corpus_loaders(cfg, bcfg.vocab_size)
    else:
        loader = SyntheticBertLoader(cfg.batch_size, cfg.seq_len,
                                     bcfg.vocab_size, cfg.max_predictions,
                                     steps=cfg.steps_per_epoch)
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

        if cfg.zero:
            raise SystemExit("--flat-lamb and --zero are mutually exclusive")

        tx, params, _ = flatten_train(
            model, lr=sched, weight_decay=wd, moment_dtype=mdt,
            order=bert_pretrain_jax_order(bcfg.num_layers))
    else:
        params = dict(model.named_parameters())
        # --zero: the moments sharded over the data axis (ZeRO-1)
        zero = None
        if cfg.zero:
            from ..parallel.zero import ZeroPlan

            zero = ZeroPlan(params)
        # reference no-decay group (run_pretraining.py:423-427): bias/gamma/
        # beta/LayerNorm = exactly the 1-D params; with use_nvlamb=False
        # those also take a plain-lr step (no trust ratio)
        tx = lamb(sched, weight_decay=wd, moment_dtype=mdt,
                  mask={n: p.ndim > 1 for n, p in params.items()}, zero=zero)
    state = create_train_state(model, tx, cfg.seed + 1, params=params)
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return BertPretrainRun(task, tx, state, train_step, loader, val_loader)


def run_bert_pretrain(cfg: BertCliConfig):
    """Train BERT with MLM + NSP on synthetic data or a tokenized corpus;
    returns ``(state, best mlm_acc)``. Corpus batches are made on the main
    thread between steps, as JAX makes them."""
    logger = _common_setup(cfg, "bert_pretrain")
    run = build_bert_pretrain(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/bert_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    # the corpus loaders make this rank's rows already
    shard = cfg.data_backend != "corpus"
    return train_loop(
        state, run.train_step,
        lambda: to_device(run.loader, cfg.device, cfg.accum_steps, shard),
        cfg=_loop_cfg(cfg, watch="mlm_acc", mode="max"), logger=logger,
        eval_step=make_eval_step(run.task.metric_fn),
        eval_iter_fn=lambda: to_device(run.val_loader, cfg.device,
                                       shard=shard),
        checkpoints=ckpt, batch_size=cfg.batch_size, start_epoch=start_epoch,
    )


@dataclass
class SquadCliConfig(CommonConfig):
    bert_model: str = "large"
    max_seq_length: int = 384
    doc_stride: int = 128
    vocab_file: str = ""
    train_file: str = ""
    predict_file: str = ""  # dev json; enables EM/F1 eval (run_squad --do_predict)
    init_checkpoint: str = ""  # torch BERT checkpoint to fine-tune from
    # SQuAD v2 (reference --version_2_with_negative + --null_score_diff_threshold)
    version_2_with_negative: bool = False
    null_score_diff_threshold: float = 0.0
    # bert_adam = the reference's fp32 BertAdam (optimization.py:64); adamw =
    # the FusedAdam/amp-equivalent path
    optimizer: str = "bert_adam"


@dataclass
class GlueCliConfig(CommonConfig):
    bert_model: str = "base"
    task_name: str = "mrpc"  # mrpc | sst-2 | cola
    max_seq_length: int = 128
    vocab_file: str = ""
    init_checkpoint: str = ""  # torch BERT checkpoint to fine-tune from
    optimizer: str = "bert_adam"  # reference run_glue.py fp32 path


@dataclass
class SwagCliConfig(CommonConfig):
    bert_model: str = "base"
    max_seq_length: int = 128
    vocab_file: str = ""
    init_checkpoint: str = ""
    optimizer: str = "bert_adam"  # reference run_swag.py fp32 path


# TSV column layouts per task (reference run_glue.py processors)
_GLUE_COLS = {
    "mrpc": dict(text_a_col=3, text_b_col=4, label_col=0),
    "sst-2": dict(text_a_col=0, text_b_col=None, label_col=1),
    "cola": dict(text_a_col=3, text_b_col=None, label_col=1),
}


def _bert_finetune_tx(optimizer: str, lr: float, total: int, params):
    """Fine-tune optimizer per the reference recipe: ``BertAdam`` with
    warmup_linear over the first tenth (no bias correction, per-tensor clip,
    no decay on 1-d tensors) in the fp32 path, or AdamW (decay on every
    tensor) with a linear warmup and decay, matching the fp16 FusedAdam
    path."""
    if optimizer == "bert_adam":
        return bert_adam(lr, warmup=0.1, t_total=total,
                         mask={n: p.ndim > 1 for n, p in params.items()})
    if optimizer == "adamw":
        sched = lr_poly_warmup(lr, max(int(total * 0.1), 1), total, power=1.0)
        return adamw(sched, weight_decay=0.01)
    raise SystemExit(f"--optimizer {optimizer}: bert_adam or adamw")


def _unported_finetune(name: str, cfg: CommonConfig) -> None:
    _unported(name, [
        (bool(cfg.init_checkpoint)
         and os.path.exists(cfg.init_checkpoint + ".index"),
         f"--init-checkpoint {cfg.init_checkpoint} (a TF checkpoint: its "
         "reader needs tensorflow; give a torch file)"),
    ])


@dataclass
class FinetuneRun:
    """What a fine-tuning runner trains with, built by ``_finetune``."""

    tx: Any
    state: Any
    train_step: Any
    loader: Any
    checkpoints: CheckpointManager
    start_epoch: int


def _finetune(cfg, name: str, model, loss_fn, loader,
              default_lr: float) -> FinetuneRun:
    """The optimizer, state, step and checkpoints the three fine-tuning
    runners share, after ``--init-checkpoint`` loads the encoder."""
    if cfg.init_checkpoint:
        from ..utils.torch_import import load_bert_encoder

        load_bert_encoder(model.bert, cfg.init_checkpoint)
    params = dict(model.named_parameters())
    # as dlx-train: CommonConfig.lr is 0.1, so the default never applies
    tx = _bert_finetune_tx(cfg.optimizer, cfg.lr or default_lr,
                           cfg.epochs * len(loader), params)
    state = create_train_state(model, tx, cfg.seed + 1, params=params)
    ckpt = CheckpointManager(f"{cfg.workspace}/{name}_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, state, len(loader))
    train_step = make_train_step(loss_fn, tx, accum_steps=cfg.accum_steps)
    return FinetuneRun(tx, state, train_step, loader, ckpt, start_epoch)


def _synthetic_vocab(bcfg) -> int:
    """The JAX runners draw synthetic ids in [1, 30000); a config with a
    smaller vocabulary (``tiny``) draws them below its own size instead."""
    return min(30000, bcfg.vocab_size)


def build_bert_squad(cfg: SquadCliConfig):
    """``bert-squad``'s task and ``FinetuneRun``: the model from seed
    ``cfg.seed``, and the ``--train-file`` features or one synthetic batch
    repeated ``steps_per_epoch`` times."""
    from ..models.bert import BERT_CONFIGS, BertSquadTask

    _unported_finetune("bert-squad", cfg)
    task = BertSquadTask(BERT_CONFIGS[cfg.bert_model], _dtype(cfg))
    model = task.init_train(torch.Generator().manual_seed(cfg.seed),
                            device=cfg.device)
    if cfg.train_file and cfg.vocab_file:
        from ..data.squad import (
            SquadLoader, convert_examples_to_features, read_squad_examples,
        )
        from ..data.tokenization import BertTokenizer

        feats = convert_examples_to_features(
            read_squad_examples(cfg.train_file), BertTokenizer(cfg.vocab_file),
            cfg.max_seq_length, cfg.doc_stride,
        )
        loader = SquadLoader(feats, cfg.batch_size, seed=cfg.seed)
    else:  # synthetic features (benchmark mode)
        rng = np.random.default_rng(cfg.seed)
        b, s = cfg.batch_size, cfg.max_seq_length
        fixed = {
            "input_ids": rng.integers(1, _synthetic_vocab(task.cfg),
                                      (b, s)).astype(np.int32),
            "attention_mask": np.ones((b, s), np.int32),
            "token_type_ids": np.zeros((b, s), np.int32),
            "start_positions": rng.integers(0, s, b).astype(np.int32),
            "end_positions": rng.integers(0, s, b).astype(np.int32),
        }
        loader = [fixed] * cfg.steps_per_epoch
    return task, _finetune(cfg, "bert_squad", model, task.loss_fn, loader, 3e-5)


def _squad_eval_fn(cfg: SquadCliConfig, task):
    """Dev-set prediction and the official EM/F1 (reference
    run_squad.py:427-478 + evaluate-v1.1; v2 with the null threshold and
    the best-threshold sweep of evaluate-v2.0), as ``eval_fn(state)``."""
    from ..data.squad import convert_examples_to_features, read_squad_examples
    from ..data.tokenization import BertTokenizer
    from ..models.bert import (
        predict_squad, read_squad_references, write_predictions,
    )
    from ..models.bert.squad_eval import (
        apply_null_threshold, find_best_null_threshold, squad_evaluate,
    )

    dev_feats = convert_examples_to_features(
        read_squad_examples(cfg.predict_file, is_training=False),
        BertTokenizer(cfg.vocab_file), cfg.max_seq_length, cfg.doc_stride,
        is_training=False,
    )
    refs = read_squad_references(cfg.predict_file)

    def write(preds, name):  # rank 0's, as its raport
        if current_mesh().is_primary:
            write_predictions(preds, f"{cfg.workspace}/{name}.json")

    def eval_fn(state):
        # every rank predicts the whole dev set (its features span batch
        # rows), so each holds the global EM/F1 without a collective
        if not cfg.version_2_with_negative:
            preds = predict_squad(task, state.model, dev_feats, cfg.batch_size)
            write(preds, "predictions")
            return squad_evaluate(preds, refs)
        # v2: unthresholded span text + null odds, then the configured
        # threshold for the reported metric and a best-threshold sweep
        preds, null_odds = predict_squad(
            task, state.model, dev_feats, cfg.batch_size,
            version_2_with_negative=True,
            null_score_diff_threshold=float("inf"), return_null_odds=True,
        )
        thresholded = apply_null_threshold(preds, null_odds,
                                           cfg.null_score_diff_threshold)
        write(thresholded, "predictions")
        write(null_odds, "null_odds")
        metrics = squad_evaluate(thresholded, refs)
        best_t, best_m = find_best_null_threshold(preds, null_odds, refs)
        metrics["best_f1"] = best_m["f1"]
        metrics["best_f1_thresh"] = best_t
        return metrics

    return eval_fn


def run_bert_squad(cfg: SquadCliConfig):
    """SQuAD fine-tuning (reference ``run_squad.py``) on synthetic features
    or ``--train-file``; with ``--predict-file`` (and ``--vocab-file``),
    EM/F1 on it each epoch as ``val.*``, watched for the best checkpoint.
    Returns ``(state, best watched metric)``."""
    logger = _common_setup(cfg, "bert_squad")
    task, run = build_bert_squad(cfg)
    eval_fn, watch = None, ("val_loss", "min")
    if cfg.predict_file and cfg.vocab_file:
        eval_fn, watch = _squad_eval_fn(cfg, task), ("f1", "max")
    return train_loop(
        run.state, run.train_step,
        lambda: to_device(run.loader, cfg.device, cfg.accum_steps),
        cfg=_loop_cfg(cfg, *watch), logger=logger, eval_fn=eval_fn,
        checkpoints=run.checkpoints, batch_size=cfg.batch_size,
        start_epoch=run.start_epoch,
    )


def _batches(data: dict[str, np.ndarray], bs: int, shuffle_seed=None,
             include_tail: bool = False) -> list[dict[str, np.ndarray]]:
    """Whole batches of ``data`` (optionally in a seeded shuffled order);
    with ``include_tail`` also the remainder, so an eval scores every
    example."""
    n = len(data["label"])
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    out = [{k: v[order[i:i + bs]] for k, v in data.items()}
           for i in range(0, n - bs + 1, bs)]
    if include_tail and n % bs:
        out.append({k: v[order[n - n % bs:]] for k, v in data.items()})
    return out


def _synthetic_examples(rng, bcfg, n: int, s: int, choices: int | None,
                        labels: int) -> dict[str, np.ndarray]:
    """The JAX runners' synthetic examples: ids in [1, 30000), no padding,
    one segment; (n, s) for GLUE, (n, choices, s) for SWAG."""
    shape = (n, s) if choices is None else (n, choices, s)
    return {
        "input_ids": rng.integers(1, _synthetic_vocab(bcfg), shape
                                  ).astype(np.int32),
        "attention_mask": np.ones(shape, np.int32),
        "token_type_ids": np.zeros(shape, np.int32),
        "label": rng.integers(0, labels, n).astype(np.int32),
    }


@torch.inference_mode()
def _predict_classes(model, data: dict[str, np.ndarray], batch_size: int,
                     device: str) -> tuple[np.ndarray, np.ndarray]:
    """argmax of the model's logits over every example, without dropout,
    and the labels in the same order. Under a data axis each rank predicts
    its rows of the examples and every rank gets all of them."""
    lo, hi = rank_rows(len(data["label"]))
    data = {k: v[lo:hi] for k, v in data.items()}
    preds, labels = [np.zeros(0, np.int64)], [np.zeros(0, np.int32)]
    for b in _batches(data, max(min(batch_size, len(data["label"])), 1),
                      include_tail=True):
        t = [torch.from_numpy(b[k]).to(device) for k in INPUTS]
        preds.append(model(*t).argmax(-1).cpu().numpy())
        labels.append(b["label"])
    return tuple(np.concatenate([x for part in gather_objects(parts)
                                 for x in part])
                 for parts in (preds, labels))


def run_bert_glue(cfg: GlueCliConfig):
    """GLUE fine-tuning (reference ``run_glue.py``): train.tsv/dev.tsv in
    --data-dir (or synthetic examples), then dev accuracy (and Matthews
    correlation for CoLA) as ``dev.*``. Returns ``(state, dev metrics)``."""
    from ..models.bert import BERT_CONFIGS
    from ..models.bert.glue import (
        GlueTask, convert_pair_features, matthews_corrcoef, read_tsv,
    )

    logger = _common_setup(cfg, "bert_glue")
    _unported_finetune("bert-glue", cfg)
    task = GlueTask(BERT_CONFIGS[cfg.bert_model], num_labels=2,
                    dtype=_dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    if cfg.data_dir and cfg.vocab_file:
        from ..data.tokenization import BertTokenizer

        tok, cols = BertTokenizer(cfg.vocab_file), _GLUE_COLS[cfg.task_name]
        train, dev = (convert_pair_features(
            read_tsv(f"{cfg.data_dir}/{split}.tsv", **cols), tok,
            cfg.max_seq_length) for split in ("train", "dev"))
    else:  # synthetic benchmark mode
        rng = np.random.default_rng(cfg.seed)
        train = _synthetic_examples(rng, task.cfg,
                                    cfg.batch_size * cfg.steps_per_epoch,
                                    cfg.max_seq_length, None, 2)
        dev = _synthetic_examples(rng, task.cfg, cfg.batch_size,
                                  cfg.max_seq_length, None, 2)
    loader = _batches(train, cfg.batch_size, shuffle_seed=cfg.seed)
    run = _finetune(cfg, "bert_glue", model, task.loss_fn, loader, 2e-5)
    state, _ = train_loop(
        run.state, run.train_step,
        lambda: to_device(loader, cfg.device, cfg.accum_steps),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=run.checkpoints,
        batch_size=cfg.batch_size, start_epoch=run.start_epoch,
    )
    # dev evaluation (reference do_eval: accuracy; CoLA reports MCC)
    preds, labels = _predict_classes(state.model, dev, cfg.batch_size,
                                     cfg.device)
    out = {}
    if len(preds):
        out["dev.accuracy"] = float((preds == labels).mean())
        if cfg.task_name == "cola":
            out["dev.mcc"] = matthews_corrcoef(preds, labels)
        logger.log((), out)
    return state, out


def read_swag(path: str) -> list[tuple[str, list[str], int]]:
    """(context, [4 endings], label) rows of a SWAG csv with the columns
    sent1, sent2, ending0..3 and label."""
    rows = []
    with open(path, newline="") as f:
        r = csv.reader(f)
        col = {k: i for i, k in enumerate(next(r))}
        for line in r:
            context = line[col["sent1"]] + " " + line[col["sent2"]]
            endings = [line[col[f"ending{i}"]] for i in range(4)]
            rows.append((context, endings, int(line[col["label"]])))
    return rows


def featurize_swag(rows, tok, s: int) -> dict[str, np.ndarray]:
    """[CLS] context [SEP] ending [SEP] per choice, the longer of the two
    trimmed from its end to fit ``s``: features (N, 4, s) and labels (N,)."""
    n = len(rows)
    ids = np.zeros((n, 4, s), np.int32)
    mask = np.zeros((n, 4, s), np.int32)
    seg = np.zeros((n, 4, s), np.int32)
    y = np.zeros((n,), np.int32)
    for i, (context, endings, label) in enumerate(rows):
        ta = tok.tokenize(context)
        for c, end in enumerate(endings):
            tb = tok.tokenize(end)
            while len(ta) + len(tb) > s - 3:
                (ta if len(ta) > len(tb) else tb).pop()
            tokens = ["[CLS]"] + ta + ["[SEP]"] + tb + ["[SEP]"]
            ii = tok.convert_tokens_to_ids(tokens)
            ids[i, c, :len(ii)] = ii
            mask[i, c, :len(ii)] = 1
            seg[i, c, len(ta) + 2:len(ii)] = 1
        y[i] = label
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": seg,
            "label": y}


def run_bert_swag(cfg: SwagCliConfig):
    """SWAG multiple choice (reference ``run_swag.py``): train.csv/val.csv in
    --data-dir (or synthetic examples), then validation accuracy as
    ``val.accuracy``. Returns ``(state, validation metrics)``."""
    from ..models.bert import BERT_CONFIGS, BertForMultipleChoice
    from ..models.bert.glue import classification_loss
    from ..models.bert.task import init_bert_weights_

    logger = _common_setup(cfg, "bert_swag")
    _unported_finetune("bert-swag", cfg)
    bcfg = BERT_CONFIGS[cfg.bert_model]
    model = BertForMultipleChoice(bcfg, _dtype(cfg))
    init_bert_weights_(model, torch.Generator().manual_seed(cfg.seed),
                       bcfg.initializer_range)
    model = model.to(cfg.device).train()
    if cfg.data_dir and cfg.vocab_file:
        from ..data.tokenization import BertTokenizer

        tok = BertTokenizer(cfg.vocab_file)
        train, val = (featurize_swag(read_swag(f"{cfg.data_dir}/{split}.csv"),
                                     tok, cfg.max_seq_length)
                      for split in ("train", "val"))
    else:
        rng = np.random.default_rng(cfg.seed)
        train = _synthetic_examples(rng, bcfg,
                                    cfg.batch_size * cfg.steps_per_epoch,
                                    cfg.max_seq_length, 4, 4)
        val = _synthetic_examples(rng, bcfg, cfg.batch_size,
                                  cfg.max_seq_length, 4, 4)
    loader = _batches(train, cfg.batch_size)
    run = _finetune(cfg, "bert_swag", model, classification_loss, loader, 2e-5)
    state, _ = train_loop(
        run.state, run.train_step,
        lambda: to_device(loader, cfg.device, cfg.accum_steps),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=run.checkpoints,
        batch_size=cfg.batch_size, start_epoch=run.start_epoch,
    )
    preds, labels = _predict_classes(state.model, val, cfg.batch_size,
                                     cfg.device)
    out = {}
    if len(preds):
        out["val.accuracy"] = float((preds == labels).mean())
        logger.log((), out)
    return state, out


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
    """The model, dual SGD, state, step and loaders of ``dlrm``. With
    ``--data-backend binary``, the Criteo binary split in ``--data-dir``
    (``feature_spec.yaml``'s cardinalities, read in JAX's order): train on it
    and evaluate on its ``test/`` split if there is one, else train on the
    first 98% of its rows and evaluate on the trailing 2% with the short
    tail batch. Otherwise the synthetic Criteo-like loader over
    ``num_tables`` tables of ``cardinality`` rows, and 5 eval batches drawn
    with seed 1."""
    from ..data.synthetic import SyntheticDlrmLoader
    from ..models.dlrm import DlrmConfig, DlrmTask, make_dlrm_optimizer

    _unported("dlrm", [
        (cfg.data_backend not in ("synthetic", "binary"),
         f"--data-backend {cfg.data_backend} (synthetic and binary are "
         "ported)"),
    ])
    spec = None
    if cfg.data_backend == "binary":
        from ..data.criteo import FeatureSpec

        spec = FeatureSpec.from_yaml(f"{cfg.data_dir}/feature_spec.yaml")
        cards = tuple(spec.categorical_cardinalities)
    else:
        cards = tuple([int(cfg.cardinality)] * cfg.num_tables)
    task = DlrmTask(
        DlrmConfig(categorical_cardinalities=cards,
                   embedding_dim=cfg.embedding_dim,
                   bottom_mlp=(512, 256, cfg.embedding_dim)),
        _dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    params = dict(model.named_parameters())
    tx = make_dlrm_optimizer(mlp_lr=cfg.lr, embedding_lr=cfg.lr)
    state = create_train_state(model, tx, cfg.seed + 1, params=params)
    if spec is not None:
        from ..data.criteo import CriteoBinaryDataset

        test_dir = os.path.join(cfg.data_dir, "test")
        if os.path.isdir(test_dir):
            loader = CriteoBinaryDataset(cfg.data_dir, spec, cfg.batch_size)
            val_loader = CriteoBinaryDataset(test_dir, spec, cfg.batch_size,
                                             drop_last=False)
        else:
            loader = CriteoBinaryDataset(cfg.data_dir, spec, cfg.batch_size,
                                         row_range=(0.0, 0.98))
            val_loader = CriteoBinaryDataset(
                cfg.data_dir, spec, cfg.batch_size, row_range=(0.98, 1.0),
                drop_last=False)
    else:
        loader = SyntheticDlrmLoader(cfg.batch_size, list(cards),
                                     steps=cfg.steps_per_epoch)
        val_loader = SyntheticDlrmLoader(cfg.batch_size, list(cards), steps=5,
                                         seed=1)
    train_step = make_train_step(task.loss_fn, tx)
    return DlrmRun(task, tx, state, train_step, loader, val_loader)


def run_dlrm(cfg: DlrmCliConfig):
    """Train DLRM with BCE and dual SGD on synthetic data or a Criteo binary
    split, evaluating AUC over the whole eval set; returns ``(state, best
    auc)``."""
    logger = _common_setup(cfg, "dlrm", accum_steps=1)  # takes it whole
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


@dataclass
class TtsRun:
    """What ``run_tts`` trains with, built by ``build_tts``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any


def build_tts(model_name: str, cfg: CommonConfig) -> TtsRun:
    """Tacotron2 or WaveGlow at their default configs, the loader
    (``--data-backend synthetic``: one batch repeated ``steps_per_epoch``
    times at the synthetic loaders' shapes; ``ljspeech``: ``metadata.csv``
    and ``wavs/`` under ``--data-dir``), clip-by-global-norm 1.0 then Adam,
    the state and the step, as JAX's ``run_tts``. As there, the rate is
    ``cfg.lr or 1e-3``, which never falls back: without ``--lr`` it is
    CommonConfig's 0.1."""
    from ..models.tts import Tacotron2Task, WaveGlowTask

    if cfg.data_backend not in ("synthetic", "ljspeech"):
        raise SystemExit(f"{model_name}: --data-backend {cfg.data_backend}: "
                         "synthetic or ljspeech")
    lj = None
    if cfg.data_backend == "ljspeech":
        from ..data.ljspeech import LJSpeechDataset

        lj = LJSpeechDataset(cfg.data_dir)
    if model_name == "tacotron2":
        task = Tacotron2Task(dtype=_dtype(cfg))
        if lj is not None:
            from ..data.ljspeech import TacotronLoader

            loader = TacotronLoader(lj, cfg.batch_size)
        else:
            from ..data.tts_synthetic import SyntheticTacotronLoader

            loader = SyntheticTacotronLoader(cfg.batch_size,
                                             steps=cfg.steps_per_epoch)
    else:
        task = WaveGlowTask(dtype=_dtype(cfg))
        if lj is not None:
            from ..data.ljspeech import WaveGlowLoader

            loader = WaveGlowLoader(lj, cfg.batch_size)
        else:
            from ..data.tts_synthetic import SyntheticWaveGlowLoader

            loader = SyntheticWaveGlowLoader(cfg.batch_size,
                                             steps=cfg.steps_per_epoch)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    params = dict(model.named_parameters())
    tx = opt.chain(opt.clip_by_global_norm(1.0), opt.adam(cfg.lr or 1e-3))
    state = create_train_state(model, tx, cfg.seed + 1, params=params,
                               model_state=task.model_state(model))
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return TtsRun(task, tx, state, train_step, loader)


def run_tts(model_name: str, cfg: CommonConfig):
    """Train Tacotron2 or WaveGlow, with checkpoints in
    ``{workspace}/{model_name}_ckpt``; no evaluation. As JAX's ``run_tts``,
    it never reads ``--resume`` (each run starts from the seed's weights)
    nor ``--weight-decay``. Returns ``(state, best)``."""
    logger = _common_setup(cfg, model_name)
    run = build_tts(model_name, cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/{model_name}_ckpt")
    return train_loop(
        run.state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size,
    )


@dataclass
class Seq2SeqRun:
    """What ``run_transformer`` trains with, built by ``build_transformer``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any


def build_transformer(cfg: CommonConfig) -> Seq2SeqRun:
    """The Transformer NMT at ``TransformerConfig()``'s full width, one
    synthetic batch repeated ``steps_per_epoch`` times (src (B, 64), tgt
    BOS + src[:, :62] + EOS), AdamW (b2 0.997, no decay) under
    ``lr_poly_warmup(lr, total // 20, total)``, the state and the step, as
    JAX's ``run_transformer``. As there, the rate is ``cfg.lr or 5e-4``,
    which never falls back: without ``--lr`` it is CommonConfig's 0.1."""
    from ..models.translation import TransformerConfig, TransformerTask

    tcfg = TransformerConfig()
    task = TransformerTask(tcfg, _dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    rng = np.random.default_rng(cfg.seed)
    src = rng.integers(3, tcfg.vocab_size, (cfg.batch_size, 64)).astype(np.int32)
    tgt = np.concatenate(
        [np.full((cfg.batch_size, 1), tcfg.bos_id), src[:, :62],
         np.full((cfg.batch_size, 1), tcfg.eos_id)], axis=1).astype(np.int32)
    loader = [{"src": src, "tgt": tgt}] * cfg.steps_per_epoch
    total = cfg.epochs * len(loader)
    sched = lr_poly_warmup(cfg.lr or 5e-4, max(total // 20, 1), total,
                           power=0.5)
    tx = adamw(sched, b1=0.9, b2=0.997, weight_decay=0.0)
    state = create_train_state(model, tx, cfg.seed + 1)
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return Seq2SeqRun(task, tx, state, train_step, loader)


def run_transformer(cfg: CommonConfig):
    """Train the Transformer NMT (``build_transformer``) with checkpoints in
    ``{workspace}/transformer_ckpt``; no evaluation. As JAX's
    ``run_transformer``, it reads neither ``--resume`` nor
    ``--data-backend``. Returns ``(state, best)``."""
    logger = _common_setup(cfg, "transformer")
    run = build_transformer(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/transformer_ckpt")
    return train_loop(
        run.state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size)


@dataclass
class BartCliConfig(CommonConfig):
    task: str = "summarize"  # summarize | pretrain (denoising)
    vocab_file: str = ""  # WordPiece vocab; "" = build from the corpus
    max_source_len: int = 128
    max_target_len: int = 32
    beam_size: int = 4


def _corpus_vocab(paths: list[str]) -> dict:
    """Copy of JAX's ``_corpus_vocab``: a whitespace-word vocab with the
    Transformer's special ids (bos 0, pad 1, eos 2, unk and mask 3)."""
    vocab = {"<s>": 0, "[PAD]": 1, "</s>": 2, "[UNK]": 3}
    for p in paths:
        with open(p) as f:
            for line in f:
                for w in line.lower().split():
                    if w not in vocab:
                        vocab[w] = len(vocab)
    return vocab


def bart_corpus(cfg: BartCliConfig):
    """``run_bart``'s data: (the directory of the CNN-DM line files, the
    tokenizer). Without ``--data-dir``, or with the synthetic backend, the
    synthetic files are written to ``{workspace}/bart_synth`` from
    ``--seed``; without ``--vocab-file`` the vocab is ``_corpus_vocab`` of
    the train split."""
    from ..data.summarization import write_synthetic_summarization
    from ..data.tokenization import BertTokenizer

    data_dir = cfg.data_dir
    if cfg.data_backend == "synthetic" or not data_dir:
        data_dir = f"{cfg.workspace}/bart_synth"
        write_synthetic_summarization(data_dir, seed=cfg.seed)
    vocab = cfg.vocab_file or _corpus_vocab(
        [f"{data_dir}/train.source", f"{data_dir}/train.target"])
    return data_dir, BertTokenizer(vocab)


def bart_decode_val(cfg: BartCliConfig, model, data_dir: str, tok) -> dict:
    """``run_bart``'s summarize evaluation: every val batch beam-decoded
    with ``beam_search_cached`` (``--beam-size``, ``max_target_len + 2``
    steps), each data rank its rows of the batch, gathered in row order.
    Returns ``hyps`` and ``refs`` (the best sequences and the
    targets without BOS, EOS and pads, for ``rouge_scores``), and per
    example ``src`` (numpy), the best sequence ``seqs`` and its
    length-normalised ``scores`` (on the host)."""
    from ..data.summarization import SummarizationDataset
    from ..models.translation import beam_search_cached

    mcfg, beam = model.cfg, cfg.beam_size
    val = SummarizationDataset(
        data_dir, "val", tok, cfg.batch_size,
        max_source_len=cfg.max_source_len,
        max_target_len=cfg.max_target_len, shuffle=False)
    special = (mcfg.bos_id, mcfg.eos_id, mcfg.pad_id)
    out = {"hyps": [], "refs": [], "src": [], "seqs": [], "scores": []}
    for batch in val:
        # each data rank decodes its rows; every rank gets all of them
        lo, hi = rank_rows(len(batch["src"]))
        part = ([], [], [])
        if hi > lo:
            src = torch.from_numpy(batch["src"][lo:hi]).to(cfg.device)
            with torch.no_grad():
                memory, memory_mask = model.encode(src)
            seqs, scores = beam_search_cached(
                model, memory.repeat_interleave(beam, 0),
                memory_mask.repeat_interleave(beam, 0), src.shape[0], beam,
                max_len=cfg.max_target_len + 2, bos_id=mcfg.bos_id,
                eos_id=mcfg.eos_id, pad_id=mcfg.pad_id,
                vocab_size=mcfg.vocab_size)
            part = (list(seqs[:, 0].cpu()), list(scores[:, 0].cpu()),
                    [[t for t in row.tolist() if t not in special]
                     for row in seqs[:, 0].cpu().numpy()])
        best, score, hyps = (sum(x, []) for x in zip(*gather_objects(part)))
        out["hyps"] += hyps
        out["refs"] += [[t for t in tgt.tolist() if t not in special]
                        for tgt in batch["tgt"]]
        out["src"].append(batch["src"])
        out["seqs"].append(torch.stack(best))
        out["scores"].append(torch.stack(score))
    if out["src"]:
        out["src"] = np.concatenate(out["src"])
        out["seqs"], out["scores"] = (torch.cat(out[k])
                                      for k in ("seqs", "scores"))
    return out


def run_bart(cfg: BartCliConfig):
    """BART, as JAX's ``run_bart``: denoising pretraining or summarization
    fine-tuning over the CNN-DM line files in ``--data-dir`` (or the
    synthetic ones, written to ``{workspace}/bart_synth``), a small
    ``TransformerConfig`` (d 256, 3+3 layers, 4 heads, the corpus's vocab),
    AdamW (decay 0.01) under ``lr_poly_warmup(lr, total // 20, total)``
    (``cfg.lr or 1e-3``: without ``--lr`` it is 0.1), ``--resume`` from
    ``{workspace}/bart_ckpt``. In summarize mode the val split is then
    beam-decoded (``bart_decode_val``) and its ROUGE logged as
    ``val.rouge*``. Returns ``(state, ROUGE scores)``."""
    from ..data.summarization import SummarizationDataset, rouge_scores
    from ..models.bart import BartTask
    from ..models.translation import TransformerConfig

    logger = _common_setup(cfg, "bart")
    data_dir, tok = bart_corpus(cfg)
    tcfg = TransformerConfig(
        vocab_size=len(tok.vocab), d_model=256, d_ff=1024, num_heads=4,
        encoder_layers=3, decoder_layers=3,
        # +2: denoising targets are the whole source with BOS and EOS
        max_len=max(cfg.max_source_len, cfg.max_target_len) + 2)
    task = BartTask(tcfg, _dtype(cfg))
    if cfg.task == "pretrain":
        with open(f"{data_dir}/train.source") as f:
            docs = [np.asarray(tok.convert_tokens_to_ids(tok.tokenize(line)),
                               np.int32) for line in f]
        rng = np.random.default_rng(cfg.seed)
        loader = []
        for _ in range(cfg.steps_per_epoch):
            picks = rng.choice(len(docs), cfg.batch_size)
            loader.append(task.make_denoising_batch(
                [docs[i] for i in picks], cfg.max_source_len, rng))
    else:
        loader = SummarizationDataset(
            data_dir, "train", tok, cfg.batch_size,
            max_source_len=cfg.max_source_len,
            max_target_len=cfg.max_target_len)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    total = cfg.epochs * len(loader)
    sched = lr_poly_warmup(cfg.lr or 1e-3, max(total // 20, 1), total)
    tx = adamw(sched, weight_decay=0.01)
    state = create_train_state(model, tx, cfg.seed + 1)
    ckpt = CheckpointManager(f"{cfg.workspace}/bart_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, state, len(loader))
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    state, _ = train_loop(
        state, train_step, lambda: to_device(loader, cfg.device),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size, start_epoch=start_epoch)
    out: dict[str, float] = {}
    if cfg.task != "summarize":
        return state, out
    decoded = bart_decode_val(cfg, state.model, data_dir, tok)
    if decoded["hyps"]:
        out = {f"val.{k}": v for k, v in
               rouge_scores(decoded["hyps"], decoded["refs"]).items()}
        logger.log((), out)
    return state, out


@dataclass
class NcfRun:
    """What ``run_ncf`` trains with, built by ``build_ncf``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any


def build_ncf(cfg: CommonConfig) -> NcfRun:
    """NeuMF at ``NcfConfig()`` (ML-20M's 138,493 users and 26,744 items),
    one synthetic batch (users, items and labels in {0, 1} drawn from the
    seed) repeated ``steps_per_epoch`` times, Adam, the state and the step,
    as JAX's ``run_ncf``. As there, the rate is ``cfg.lr or 2.5e-3``, which
    never falls back: without ``--lr`` it is CommonConfig's 0.1; and the
    step takes no ``--accum-steps``."""
    from ..models.ncf import NcfConfig, NcfTask

    ncfg = NcfConfig()
    task = NcfTask(ncfg, _dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    rng = np.random.default_rng(cfg.seed)
    bs = cfg.batch_size
    loader = [{
        "user": rng.integers(0, ncfg.nb_users, bs).astype(np.int32),
        "item": rng.integers(0, ncfg.nb_items, bs).astype(np.int32),
        "label": rng.integers(0, 2, bs).astype(np.float32),
    }] * cfg.steps_per_epoch
    tx = opt.adam(cfg.lr or 2.5e-3)
    state = create_train_state(model, tx, cfg.seed + 1)
    return NcfRun(task, tx, state, make_train_step(task.loss_fn, tx), loader)


def run_ncf(cfg: CommonConfig):
    """Train NeuMF (``build_ncf``) with checkpoints in
    ``{workspace}/ncf_ckpt``; no evaluation. As JAX's ``run_ncf``, it reads
    neither ``--resume`` nor ``--data-backend``. Returns ``(state, best)``."""
    logger = _common_setup(cfg, "ncf", accum_steps=1)
    run = build_ncf(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/ncf_ckpt")
    return train_loop(
        run.state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size)


@dataclass
class TftRun:
    """What ``run_tft`` trains with, built by ``build_tft``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any
    panel: Any  # (series, steps, columns)
    spec: Any


def build_tft(cfg: CommonConfig) -> TftRun:
    """TFT on the time-series platform, as JAX's ``run_tft``: the panel
    (``--data-backend npy``: ``{data_dir}/panel.npy``, (series, steps,
    columns); otherwise ``make_synthetic_series()``), columns 0-1 observed
    (0 the target) and 2-3 known, 168 steps of history and 24 of horizon,
    the train split's windows, clip by global norm 1.0 then Adam under
    ``lr_poly_warmup(lr, total // 20, total)``. As there, the rate is
    ``cfg.lr or 1e-3``, which never falls back: without ``--lr`` it is
    CommonConfig's 0.1. fp32 whatever ``--amp``."""
    from ..data.timeseries import (TimeSeriesSpec, WindowedTimeSeriesDataset,
                                   make_synthetic_series)
    from ..models.tft import TFTConfig, TFTTask

    if cfg.data_backend == "npy":
        panel = np.load(f"{cfg.data_dir}/panel.npy")
    else:
        panel = make_synthetic_series()
    spec = TimeSeriesSpec(observed=(0, 1), known=(2, 3), target=0,
                          encoder_length=168, horizon=24)
    task = TFTTask(TFTConfig(n_observed=len(spec.observed),
                             n_known=len(spec.known),
                             encoder_len=spec.encoder_length,
                             horizon=spec.horizon))
    loader = WindowedTimeSeriesDataset(panel, spec, cfg.batch_size,
                                       split="train", seed=cfg.seed)
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    total = cfg.epochs * len(loader)
    sched = lr_poly_warmup(cfg.lr or 1e-3, max(total // 20, 1), total)
    tx = opt.chain(opt.clip_by_global_norm(1.0), opt.adam(sched))
    state = create_train_state(model, tx, cfg.seed + 1)
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return TftRun(task, tx, state, train_step, loader, panel, spec)


def tft_test_metrics(cfg: CommonConfig, run: TftRun, model) -> dict:
    """The test split's forecasts without dropout, and their
    ``forecast_metrics`` (MAE, RMSE, SMAPE, ND, P50, P90); {} when the
    split has no whole batch. Under a data axis each rank forecasts its
    rows of a batch and the metrics are over every rank's."""
    from ..data.timeseries import WindowedTimeSeriesDataset, forecast_metrics

    test = WindowedTimeSeriesDataset(run.panel, run.spec, cfg.batch_size,
                                     split="test", seed=cfg.seed)
    preds, targets = [], []
    for batch in to_device(test, cfg.device):
        pred = run.task.predict_fn(model, batch["observed"], batch["known"])
        preds.append(gather_data_rows(pred).cpu().numpy())
        targets.append(gather_data_rows(batch["target"]).cpu().numpy())
    if not preds:
        return {}
    return forecast_metrics(np.concatenate(preds), np.concatenate(targets),
                            run.task.cfg.quantiles)


def run_tft(cfg: CommonConfig):
    """Train TFT (``build_tft``) with checkpoints in ``{workspace}/tft_ckpt``
    (``--resume`` reads them), then the test split's metrics, logged as
    ``test.*``. Returns ``(state, best, test metrics)``."""
    logger = _common_setup(cfg, "tft")
    run = build_tft(cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/tft_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    state, best = train_loop(
        state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size, start_epoch=start_epoch)
    metrics = {f"test.{k}": v
               for k, v in tft_test_metrics(cfg, run, state.model).items()}
    if metrics:
        logger.log((), metrics)
    return state, best, metrics


def _breadth_spec(name: str, cfg: CommonConfig):
    """(task, init, batch factory, optimizer) of JAX's ``_breadth_spec`` for
    the families the port trains through ``run_breadth``, on its synthetic
    batches, each rate ``cfg.lr or <default>`` (which never falls back from
    ``CommonConfig.lr``):

    - ``jasper``: Jasper 5x3, feats (B, 256, 64) N(0, 1), labels (B, 32) in
      [1, vocab), no paddings; clip by global norm 1.0, then Adam (1e-3);
    - ``wav2vec2``: BASE, one second of audio (B, 16000) 0.1 N(0, 1), span
      masks at 0.5 over its 49 frames; AdamW (5e-4, weight decay 0.01);
    - ``gnmt``: ``GnmtConfig()``, src (B, 48), tgt BOS + src[:, :46] + EOS;
      Adam (1e-3);
    - ``fastpitch``: text (B, 32) in [1, n_symbols), durations in [1, 6),
      pitch N(0, 1), mel (B, 900, 80) N(0, 1); Adam (1e-3);
    - ``nnunet``: the 2-D ``DynUNet`` (depth 4, 32-320 filters, 3
      classes), images (B, 128, 128, 1) N(0, 1), labels in [0, 3); Adam
      (1e-3);
    - ``transformer-xl``: WT103's base model (16 layers, d 512, segment and
      memory 192), tokens (B, 193) in [0, vocab), inputs and next-token
      targets; Adam (2.5e-4);
    - ``moflow``: ``MoFlowConfig()`` (QM9's 9 atoms of 5 types, 4 bond
      types), one-hot atoms and symmetric one-hot bonds; Adam (1e-3), fp32
      whatever ``--amp``;
    - ``se3-transformer``: ``SE3Config(num_layers=4, num_degrees=3,
      num_channels=16)`` on 12 atoms, positions 2 N(0, 1), one-hot species,
      the target 0.05 times the sum of 1 / max(distance, 0.5) over the
      pairs; Adam (3e-3), fp32 whatever ``--amp``."""
    rng = np.random.default_rng(cfg.seed)
    bs = cfg.batch_size
    if name == "jasper":
        from ..models.asr import JasperTask

        task = JasperTask(dtype=_dtype(cfg))

        def batch():
            return {
                "feats": rng.normal(size=(bs, 256, task.cfg.n_mels)
                                    ).astype(np.float32),
                "feat_paddings": np.zeros((bs, 256), np.float32),
                "labels": rng.integers(
                    1, task.cfg.vocab_size, (bs, 32)).astype(np.int32),
                "label_paddings": np.zeros((bs, 32), np.float32),
            }
        tx = opt.chain(opt.clip_by_global_norm(1.0), opt.adam(cfg.lr or 1e-3))
    elif name == "wav2vec2":
        from ..models.wav2vec2 import Wav2Vec2Task, n_frames, sample_spans_mask

        task = Wav2Vec2Task(dtype=_dtype(cfg))
        audio_len = 16000
        frames = n_frames(task.cfg, audio_len)

        def batch():
            return {
                "audio": rng.normal(size=(bs, audio_len)
                                    ).astype(np.float32) * 0.1,
                "mask": sample_spans_mask(rng, bs, frames, 0.5,
                                          task.cfg.mask_span),
            }
        tx = opt.adamw(cfg.lr or 5e-4, weight_decay=0.01)
    elif name == "gnmt":
        from ..models.translation.gnmt import GnmtTask

        task = GnmtTask(dtype=_dtype(cfg))

        def batch():
            src = rng.integers(3, task.cfg.vocab_size, (bs, 48))
            tgt = np.concatenate(
                [np.full((bs, 1), task.cfg.bos_id), src[:, :46],
                 np.full((bs, 1), task.cfg.eos_id)], axis=1)
            return {"src": src.astype(np.int32), "tgt": tgt.astype(np.int32)}
        tx = opt.adam(cfg.lr or 1e-3)
    elif name == "fastpitch":
        from ..models.tts import FastPitchTask

        task = FastPitchTask(dtype=_dtype(cfg))
        tl = 32

        def batch():
            dur = rng.integers(1, 6, (bs, tl)).astype(np.int32)
            mel_len = task.cfg.max_mel_len
            return {
                "text": rng.integers(1, task.cfg.n_symbols,
                                     (bs, tl)).astype(np.int32),
                "durations": dur,
                "pitch": rng.normal(size=(bs, tl)).astype(np.float32),
                "mel": rng.normal(size=(bs, mel_len, task.cfg.n_mels)
                                  ).astype(np.float32),
            }
        tx = opt.adam(cfg.lr or 1e-3)
    elif name == "nnunet":
        from ..models.unet import UNetConfig, UNetTask

        task = UNetTask(UNetConfig(spatial_rank=2), dtype=_dtype(cfg))

        def batch():
            return {
                "image": rng.normal(size=(bs, 128, 128, 1)
                                    ).astype(np.float32),
                "label": rng.integers(0, task.cfg.n_classes,
                                      (bs, 128, 128)).astype(np.int32),
            }
        tx = opt.adam(cfg.lr or 1e-3)
    elif name == "transformer-xl":
        from ..models.transformer_xl import TransformerXLTask

        task = TransformerXLTask(dtype=_dtype(cfg))
        seg = task.cfg.seg_len

        def batch():
            toks = rng.integers(0, task.cfg.vocab_size, (bs, seg + 1))
            return {"tokens": toks[:, :-1].astype(np.int32),
                    "targets": toks[:, 1:].astype(np.int32)}
        tx = opt.adam(cfg.lr or 2.5e-4)
    elif name == "se3-transformer":
        from ..models.se3_transformer import SE3Config, SE3RegressionTask

        task = SE3RegressionTask(
            SE3Config(num_layers=4, num_degrees=3, num_channels=16))
        n = 12

        def batch():
            pos = rng.normal(size=(bs, n, 3)).astype(np.float32) * 2
            species = np.eye(task.cfg.node_feature_dim, dtype=np.float32)[
                rng.integers(0, task.cfg.node_feature_dim, (bs, n))]
            mask = np.ones((bs, n), np.float32)
            d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1)
            d = d + np.eye(n) * 1e9
            target = (1.0 / np.maximum(d, 0.5)).sum(axis=(1, 2)) * 0.05
            return {"positions": pos, "species": species, "mask": mask,
                    "target": target.astype(np.float32)}
        tx = opt.adam(cfg.lr or 3e-3)
    elif name == "moflow":
        from ..models.moflow import MoFlowConfig, MoFlowTask

        task = MoFlowTask(MoFlowConfig())
        c = task.cfg

        def batch():
            atoms = np.eye(c.n_atom_types, dtype=np.float32)[
                rng.integers(0, c.n_atom_types, (bs, c.n_node))]
            bonds = rng.integers(0, c.n_bond_types, (bs, c.n_node, c.n_node))
            bonds = np.triu(bonds, 1)
            bonds = bonds + bonds.transpose(0, 2, 1)
            adj = np.eye(c.n_bond_types, dtype=np.float32)[bonds]
            return {"atoms": atoms, "adj": adj.transpose(0, 3, 1, 2)}
        tx = opt.adam(cfg.lr or 1e-3)
    else:
        raise KeyError(name)

    def init():
        return task.init(torch.Generator().manual_seed(cfg.seed),
                         device=cfg.device)
    return task, init, batch, tx


@dataclass
class BreadthRun:
    """What ``run_breadth`` trains with, built by ``build_breadth``."""

    task: Any
    tx: Any
    state: Any
    train_step: Any
    loader: Any


def build_breadth(name: str, cfg: CommonConfig) -> BreadthRun:
    """The model, optimizer, state, step and loader of a ``run_breadth``
    command: ``min(steps_per_epoch, 16)`` distinct synthetic batches
    repeated to ``steps_per_epoch``; in the state the task's BN statistics
    (Jasper's, MoFlow's), or Transformer-XL's memories of a fresh sequence
    (zeros, none valid: the step JAX takes from ``{}``)."""
    task, init, batch_fn, tx = _breadth_spec(name, cfg)
    model = init()
    loader = [batch_fn() for _ in range(min(cfg.steps_per_epoch, 16))]
    loader = (loader * (-(-cfg.steps_per_epoch // len(loader))))[
        :cfg.steps_per_epoch]
    if hasattr(task, "initial_state"):  # this rank's rows' memories
        model_state = task.initial_state(
            model, cfg.batch_size // cfg.accum_steps
            // current_mesh().size(DATA_AXIS))
    else:
        model_state = task.model_state(model) \
            if hasattr(task, "model_state") else None
    state = create_train_state(model, tx, cfg.seed + 1,
                               model_state=model_state)
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    return BreadthRun(task, tx, state, train_step, loader)


def run_breadth(name: str, cfg: CommonConfig):
    """JAX's ``run_breadth`` (``build_breadth``), ``--resume`` from
    ``{workspace}/{name}_ckpt``. Returns ``(state, best)``."""
    logger = _common_setup(cfg, name.replace("-", "_"))
    run = build_breadth(name, cfg)
    ckpt = CheckpointManager(f"{cfg.workspace}/{name.replace('-', '_')}_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, run.state, len(run.loader))
    return train_loop(
        state, run.train_step, lambda: to_device(run.loader, cfg.device),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size, start_epoch=start_epoch)

def run_hifigan(cfg: CommonConfig):
    """HiFi-GAN, as JAX's ``run_hifigan``: one synthetic batch (mel (B, 32,
    80) N(0, 1), audio (B, 8192) 0.3 N(0, 1)), two Adams (b1 0.8, b2 0.99,
    ``cfg.lr or 2e-4``: without ``--lr`` it is 0.1), a ``d_step`` then a
    ``g_step`` per step, and per epoch ``train.d_loss``, ``train.g_loss``
    and ``train.mel_l1``. Returns ``(gen, disc, last metrics)``."""
    from ..models.tts import HiFiGanTask

    logger = _common_setup(cfg, "hifigan")
    task = HiFiGanTask(dtype=_dtype(cfg))
    gen, disc = task.init(torch.Generator().manual_seed(cfg.seed),
                          device=cfg.device)
    g_tx = opt.adam(cfg.lr or 2e-4, b1=0.8, b2=0.99)
    d_tx = opt.adam(cfg.lr or 2e-4, b1=0.8, b2=0.99)
    g_opt = g_tx.init(dict(gen.named_parameters()))
    d_opt = d_tx.init(dict(disc.named_parameters()))
    g_step, d_step = task.make_steps(g_tx, d_tx)
    rng = np.random.default_rng(cfg.seed)
    hcfg = task.cfg
    t_mel = hcfg.segment_length // hcfg.hop_length
    batch = next(to_device([{
        "mel": rng.normal(size=(cfg.batch_size, t_mel, hcfg.n_mels)
                          ).astype(np.float32),
        "audio": (rng.normal(size=(cfg.batch_size, hcfg.segment_length))
                  * 0.3).astype(np.float32)}], cfg.device))
    out = {}
    for epoch in range(cfg.epochs):
        for _ in range(cfg.steps_per_epoch):
            d_opt, dl = d_step(disc, d_opt, gen, batch)
            g_opt, gl, aux = g_step(gen, g_opt, disc, batch)
        out = {"train.d_loss": float(dl), "train.g_loss": float(gl),
               "train.mel_l1": float(aux["mel_l1"])}
        logger.log((epoch,), out)
    return gen, disc, out


def _gathered_images(batch: dict, images: list) -> list:
    """Every data rank's per-image eval records of a val batch, in the
    batch's row order, without the pad rows past its ``n_valid``: each rank
    holds ``images`` for its rows of the batch (``to_device``'s)."""
    lo = data_rows(len(images))[0]
    mine = images[:max(0, int(batch["n_valid"]) - lo)]
    return [x for part in gather_objects(mine) for x in part]


def run_efficientdet(cfg: DetectorCliConfig):
    """EfficientDet-D0 training (reference ``Efficientdet/train.py``), as
    JAX's ``run_efficientdet``: synthetic COCO-shaped batches, or with
    ``--data-backend coco`` ``train2017`` under ``--data-dir`` through
    ``CocoRawLoader`` (on the data plane of ``--device``); clip by global
    norm 10, then SGD with momentum. When
    ``annotations/instances_val2017.json`` exists, COCO box AP on val2017
    after training (``CocoMAP``), logged as ``val.bbox_mAP`` and
    ``val.bbox_mAP50``. Returns ``(state, best, val metrics or None)``."""
    from ..data.det_synthetic import SyntheticDetectionLoader
    from ..models.efficientdet import EfficientDetConfig, EfficientDetTask

    logger = _common_setup(cfg, "efficientdet")
    _unported_coco("efficientdet", cfg)
    task = EfficientDetTask(EfficientDetConfig(image_size=cfg.image_size or 512),
                            dtype=_dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    ds_val = None
    real = cfg.data_backend == "coco"
    if real:
        from ..data.coco import CocoDetectionDataset, CocoRawLoader

        ds = CocoDetectionDataset(
            f"{cfg.data_dir}/train2017",
            f"{cfg.data_dir}/annotations/instances_train2017.json")
        loader = CocoRawLoader(ds, cfg.batch_size, task.cfg.image_size,
                               max_gt=task.max_gt, seed=cfg.seed,
                               device=cfg.device)
        val_ann = f"{cfg.data_dir}/annotations/instances_val2017.json"
        if os.path.exists(val_ann):
            ds_val = CocoDetectionDataset(f"{cfg.data_dir}/val2017", val_ann)
    else:
        loader = SyntheticDetectionLoader(
            cfg.batch_size, task.cfg.image_size, task.cfg.num_classes,
            max_gt=task.max_gt, steps=cfg.steps_per_epoch, seed=cfg.seed)
    tx = opt.chain(opt.clip_by_global_norm(10.0),
                   opt.sgd(_make_schedule(cfg, len(loader)), cfg.momentum))
    state = create_train_state(model, tx, cfg.seed + 1,
                               model_state=task.model_state(model))
    ckpt = CheckpointManager(f"{cfg.workspace}/efficientdet_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, state, len(loader))
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    state, best = train_loop(
        state, train_step,
        lambda: _feed(loader, cfg.device, real, cfg.accum_steps, shard=True),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size, start_epoch=start_epoch)
    if ds_val is None:
        return state, best, None
    # COCO box AP on the val split (reference validate.py / COCOeval)
    from ..models.ssd.coco_eval import CocoMAP

    val = CocoRawLoader(ds_val, cfg.batch_size, task.cfg.image_size,
                        max_gt=task.max_gt, train=False, device=cfg.device)
    ev = CocoMAP()
    for batch in to_device(val, cfg.device):
        boxes, scores, labels, valid = (t.cpu().numpy() for t in task.predict(
            state.model, batch["image"], max_out=100, score_threshold=0.05))
        gt_boxes, gt_labels, gt_valid = (batch[k].cpu().numpy() for k in
                                         ("boxes", "labels", "valid"))
        for image in _gathered_images(batch, [
                (boxes[i][k], labels[i][k], scores[i][k], gt_boxes[i][g],
                 gt_labels[i][g])
                for i, (k, g) in enumerate(zip(valid, gt_valid))]):
            ev.add_image(*image)
    m = ev.compute()
    metrics = {"val.bbox_mAP": m["mAP"], "val.bbox_mAP50": m["mAP50"]}
    logger.log((), metrics)
    return state, best, metrics


def run_maskrcnn(cfg: DetectorCliConfig):
    """Mask R-CNN R50-FPN training (reference ``MaskRCNN/.../train_net.py``),
    as JAX's ``run_maskrcnn``: synthetic COCO-shaped batches with dense
    instance masks, or with ``--data-backend coco`` ``train2017`` under
    ``--data-dir`` through ``CocoRawLoader(with_masks=True)`` (flip only,
    polygons rasterized on 64 x 64 grids); clip by global norm 10, then SGD
    with momentum on ``--lr-schedule`` (the step policy decays at epochs
    30, 60 and 80, and no ``--weight-decay`` reaches the optimizer, as in
    JAX). When ``annotations/instances_val2017.json`` exists, COCO box and
    mask AP on val2017 after training (``CocoMAP``, ``MaskMAP``; top 50
    detections an image), logged as ``val.bbox_mAP``, ``val.bbox_mAP50``,
    ``val.segm_mAP`` and ``val.segm_mAP50``. Returns ``(state, best, val
    metrics or None)``."""
    from ..data.det_synthetic import SyntheticDetectionLoader
    from ..models.maskrcnn import MaskRCNNConfig, MaskRCNNTask

    logger = _common_setup(cfg, "maskrcnn")
    _unported_coco("maskrcnn", cfg)
    task = MaskRCNNTask(MaskRCNNConfig(image_size=cfg.image_size or 800),
                        dtype=_dtype(cfg))
    model = task.init(torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    ds_val = None
    real = cfg.data_backend == "coco"
    if real:
        from ..data.coco import CocoDetectionDataset, CocoRawLoader

        ds = CocoDetectionDataset(
            f"{cfg.data_dir}/train2017",
            f"{cfg.data_dir}/annotations/instances_train2017.json")
        loader = CocoRawLoader(ds, cfg.batch_size, task.cfg.image_size,
                               max_gt=16, with_masks=True, seed=cfg.seed,
                               device=cfg.device)
        val_ann = f"{cfg.data_dir}/annotations/instances_val2017.json"
        if os.path.exists(val_ann):
            ds_val = CocoDetectionDataset(f"{cfg.data_dir}/val2017", val_ann)
    else:
        loader = SyntheticDetectionLoader(
            cfg.batch_size, task.cfg.image_size, task.cfg.num_classes - 1,
            max_gt=16, steps=cfg.steps_per_epoch, with_masks=True,
            seed=cfg.seed)
    tx = opt.chain(opt.clip_by_global_norm(10.0),
                   opt.sgd(_make_schedule(cfg, len(loader)), cfg.momentum))
    state = create_train_state(model, tx, cfg.seed + 1,
                               model_state=task.model_state(model))
    ckpt = CheckpointManager(f"{cfg.workspace}/maskrcnn_ckpt")
    state, start_epoch = _maybe_resume(cfg, ckpt, state, len(loader))
    train_step = make_train_step(task.loss_fn, tx, accum_steps=cfg.accum_steps)
    state, best = train_loop(
        state, train_step,
        lambda: _feed(loader, cfg.device, real, cfg.accum_steps, shard=True),
        cfg=_loop_cfg(cfg), logger=logger, checkpoints=ckpt,
        batch_size=cfg.batch_size, start_epoch=start_epoch)
    if ds_val is None:
        return state, best, None
    # COCO box + mask AP on the val split (reference tools/test_net.py runs
    # COCOeval bbox + segm after training)
    from ..models.ssd.coco_eval import CocoMAP, MaskMAP

    val = CocoRawLoader(ds_val, cfg.batch_size, task.cfg.image_size,
                        max_gt=16, with_masks=True, train=False,
                        device=cfg.device)
    box_ev, mask_ev = CocoMAP(), MaskMAP(image_size=float(task.cfg.image_size))
    for batch in to_device(val, cfg.device):
        out = task.predict(state.model, batch["image"], max_out=50,
                           score_threshold=0.05)
        boxes, scores, labels, valid, masks = (t.cpu().numpy() for t in out)
        gt_boxes, gt_labels, gt_valid, gt_masks = (
            batch[k].cpu().numpy() for k in ("boxes", "labels", "valid",
                                             "masks"))
        for b, m, lab, s, gb, gm, gl in _gathered_images(batch, [
                (boxes[i][k], masks[i][k], labels[i][k], scores[i][k],
                 gt_boxes[i][g], gt_masks[i][g], gt_labels[i][g])
                for i, (k, g) in enumerate(zip(valid, gt_valid))]):
            box_ev.add_image(b, lab, s, gb, gl)
            mask_ev.add_image_masks(b, m, lab, s, gm, gl)
    box_m, mask_m = box_ev.compute(), mask_ev.compute()
    metrics = {"val.bbox_mAP": box_m["mAP"], "val.bbox_mAP50": box_m["mAP50"],
               "val.segm_mAP": mask_m["mAP"],
               "val.segm_mAP50": mask_m["mAP50"]}
    logger.log((), metrics)
    return state, best, metrics


CONVNETS = ("resnet50", "resnext101-32x4d", "se-resnext101-32x4d",
            "efficientnet-b0", "efficientnet-b4", "gpunet-0", "gpunet-1",
            "gpunet-2")
BREADTH = ("gnmt", "jasper", "wav2vec2", "fastpitch", "nnunet",
           "transformer-xl", "moflow", "se3-transformer")
MODELS = {**{a: (lambda cfg, a=a: run_convnet(a, cfg)) for a in CONVNETS},
          "ssd300": run_ssd, "bert-pretrain": run_bert_pretrain,
          "bert-squad": run_bert_squad,
          "bert-glue": run_bert_glue, "bert-swag": run_bert_swag,
          "dlrm": run_dlrm,
          **{m: (lambda cfg, m=m: run_tts(m, cfg))
             for m in ("tacotron2", "waveglow")},
          "transformer": run_transformer, "bart": run_bart,
          **{m: (lambda cfg, m=m: run_breadth(m, cfg)) for m in BREADTH},
          "hifigan": run_hifigan, "efficientdet": run_efficientdet,
          "maskrcnn": run_maskrcnn, "ncf": run_ncf, "tft": run_tft}
_CONFIG_CLS = {**dict.fromkeys(CONVNETS, ConvNetCliConfig),
               "ssd300": SgdCliConfig, "bert-pretrain": BertCliConfig,
               "bert-squad": SquadCliConfig,
               "bert-glue": GlueCliConfig, "bert-swag": SwagCliConfig,
               "dlrm": DlrmCliConfig,
               "tacotron2": CommonConfig, "waveglow": CommonConfig,
               "transformer": CommonConfig, "bart": BartCliConfig,
               **dict.fromkeys((*BREADTH, "hifigan", "ncf", "tft"),
                               CommonConfig),
               **dict.fromkeys(("efficientdet", "maskrcnn"),
                               DetectorCliConfig)}


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
        # the YAML layers: a configs.yml-style file and the names of its
        # precision and platform sections (e.g. bf16, v5e-1)
        p.add_argument("--config-file", default=None)
        p.add_argument("--platform", default=None)
        p.add_argument("--precision", default=None)

    ns = parser.parse_args(argv)
    cls = _CONFIG_CLS[ns.model]
    cfg = cls()
    if ns.config_file:
        # defaults -> the file's layers for this command -> the flags
        cfg = cfgmod.resolve(cfg, yaml_path=ns.config_file,
                             precision=ns.precision, platform=ns.platform,
                             model=ns.model, mode=None)
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
