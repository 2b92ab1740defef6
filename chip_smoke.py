#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (from ``CUDA_HOME`` or ``/usr/local/cuda``) and no network,
and it imports nothing of JAX. Phases, one line each:

1. device: torch and CUDA versions, the card's name and power limit
2. build: the CUDA kernels from ``deeplearningexamples_tpu_torch/csrc``, one
   nvcc per source, all started together
3. kernel: flash_fwd (K1) against its plain version on the card, with times
4. slice: full-width BERT-Large QA (24 layers, random weights from one seed)
   on the card against the same model on the CPU
5. serving: bf16 BERT-Large QA behind the batcher and HTTP server, 16
   concurrent JSON and binary requests against a direct forward
6. predict_squad: three hand-written questions answered from their context
7. kernel: the flash backward's two kernels (K2) against the plain backward
8. kernel: the flat LAMB's two passes (K3) against their plain versions on
   BERT-Large's flat layout, three steps, bf16 and fp32 moments
9. train parity: one fp32 training step of full-width BERT-Large on the
   card against the CPU, then the same step in bf16
10. training: ``bert-pretrain`` through the CLI's runner, 10 steps at B=64
    S=128 with the tree LAMB and with ``--flat-lamb``, then 2 steps of
    ``--phase2`` (S=512, B=8)
11. kernel: gather_rows (K4) against its plain version at DLRM's shape (a
    2.6M x 128 joint table, 1,703,936 uniform and zipf indices, fp32 and
    bf16), a ragged N with negative and out-of-range indices, and D=32
12. DLRM parity: the embedding backward twice on one full-width batch
    (B=65,536, uniform and zipf ids, both modes), equal bit for bit; one
    fp32 training step of full-width DLRM (26 x 100,000 rows) at B=4096 on
    the card against the CPU, then the same step in bf16
13. DLRM training: ``dlrm`` through the CLI's runner, B=65,536, 20 steps
    and the 5-batch eval, at configs.yml's lr 24 (its curve recorded: it
    diverges without the reference's warmup) and at the CLI's default 0.1
14. int8: quantize_activations (K5) against its plain version bit for bit
    at BERT-Large's FFN inputs (B=8 S=384: 3072 x 1024 and 3072 x 4096 fp32,
    3072 x 1024 bf16) with the statistics of 16 seeds, then ``int8_matmul``
    at the FFN GEMMs against the fp32 product, with times
15. fused LAMB: ``fused_lamb`` on full-width BERT-Large through
    ``make_train_step``, K3 at 8 x 1024-element blocks: one fp32 step against
    JAX's plain pair on the same gradients, then 10 bf16 steps at B=64 S=128
    against ``flat_lamb`` with fp32 moments; the update's time beside the
    tree and flat LAMB's
16. hot-row gather: hot_gather (K6) against its plain version at the probe's
    shape (26 x 100,000 x 128 fp32, 256 hot rows a table, 1,703,936 uniform
    and zipf ids, a hot buffer that is not the table's head), with times
    beside K4 and ``embedding()`` on the same ids
17. fine-tune parity: K1 and K2 against their plain versions at the
    fine-tuning shapes (SQuAD B=32 S=384 H=16, GLUE B=32 and SWAG's folded
    B=128 at S=128 H=12; bf16, masked, dropout), then one fp32 SQuAD step of
    full-width BERT-Large at B=2 S=384 on the card against the CPU under
    ``bert_adam`` and under ``adamw``, and the same step in bf16 (the
    control)
18. fine-tuning: ``bert-squad`` through the CLI's runner at B=32 S=384 bf16,
    10 synthetic steps under ``adamw`` and under ``bert_adam`` at lr 3e-5,
    then 2 steps on a SQuAD file the script writes with ``--predict-file``
    (EM/F1), then ``bert-glue`` and ``bert-swag`` at their defaults for 5
    synthetic steps each, with their dev and validation accuracy
19. ConvNets parity: one fp32 training step of full-width ResNet-50 at B=8
    (224x224) on the card, TF32 off, against the same step on the CPU in
    float64, under bench.py's SGD
    recipe (gradients, BN running statistics, updates), and the same step
    with BN on its running statistics, each gradient against its own
    largest entry and the largest of all; the same step in bf16 (the
    control, which must miss the limits); a QAT forward card against CPU,
    each QATConv on the CPU's input to it (a plain convolution the
    control), and whole; and one EfficientNet-B0 step at B=4 (no
    stochastic depth or dropout) the same way
20. ConvNets: ``resnet50`` through the CLI's runner at B=256 bf16 with
    bench.py's recipe, 20 steps and the 10-batch eval, then 5 steps with
    ``--mixup 0.2``; ``resnext101-32x4d`` and ``se-resnext101-32x4d`` at
    B=64, ``efficientnet-b0`` at B=64 and ``efficientnet-b4`` at B=8 with
    ``--ema 0.9999``, 5 steps each; each of the five also 5 steps with
    ``--quant-policy qat``; then
    ResNet-50's bf16 eval forward at B=256 and B=1 on CUDA events and on
    the host clock
21. SSD300: one fp32 training step at B=4 (81 classes, images twisted at
    fixed parameters) on the card, TF32 off, against the same step on the
    CPU in float64 (the CPU's fp32 step beside it) with phase 19's limits,
    the bf16 step the control; the color twist card against CPU;
    ``predict_fn`` card against the CPU in float64, then ``evaluate_ssd`` on
    the card over two batches with ground truth (mAP, detections); ``ssd300`` through the
    CLI's runner at B=128 bf16 with bench.py's optimizer, 20 steps, then 2
    with ``--resume``; the bf16 eval forward at B=128 and B=1 on CUDA events
    and on the host clock
22. Tacotron2 + WaveGlow: one fp32 Tacotron2 step (full width, B=4, text
    64, mel 48) and one fp32 WaveGlow step (full width, 8 of its 12 flows,
    B=2, segment 8000, every WN ``end`` randomised) on the card, TF32 off, every dropout at 0,
    under clip + Adam, against the same steps on the CPU in float64, the
    bf16 steps the controls; WaveGlow's
    ``infer`` at sigma 0 card against CPU float64; ``tacotron2`` (B=128,
    text 128, mel 600) and ``waveglow`` (B=10, segment 8000) through the
    CLI's runner, bf16 at bench.py's rates, with frames/s and samples/s;
    ``TTSPipeline`` from three sentences to wavs (800 decoder steps, the
    denoiser at 0.01), timed by part
23. encoder-decoder: one fp32 step of Transformer-base (B=4, source 64
    left-padded, target 64), bart-large (2 + 2 of its layers, B=2, source
    64, target 32) and GNMT (3 of its 4 layers, B=2, 24) on the card, TF32 off, dropout 0, under the CLI's
    optimizers, against the same steps on the CPU in float64, the bf16
    steps the controls; K1 and K2 against
    their plain versions at the slice's shapes (the encoder's masked
    self-attention, the decoder's causal one, cross-attention with Sq != Sk,
    cross-attention at Sq = 1 with Sk 64 and 1024, BART's causal and masked
    decoder), bf16 and fp32, with times beside SDPA's and the bound; plain
    and KV-cached beam search of fp32 Transformer-base at B=8, beam 4,
    max_len 64 on the card, equal to each other, their scores against
    teacher forcing on the CPU in float64; ``transformer`` (B=128, 20
    steps), ``bart --task summarize`` (beam-decoded ROUGE) and ``--task
    pretrain``, ``gnmt`` (B=128, 5 steps) through the CLI's runners in bf16;
    one bart-large bf16 AdamW step at B=8, source 1024, target 128, and a
    cached beam decode at B=4, beam 4, source 1024, with peak memory
24. BERT's data and flags, DLRM's binary backend: K1 and K2 against their
    plain versions at head dim 26 (the 4l-312 student, B=32 S=128 H=12,
    bf16 and fp32) and at every bucket length of the binned phase-2 loader
    (B=16, S=64 to 512), with times; one fp32 BERT-Large step with
    ``remat`` against the same step without (dropout on), and the phase-2
    step's peak memory and time with and without; ``bert-pretrain``
    through the CLI's runner on a corpus the script writes: ``--config-file
    configs.yml --precision bf16`` for 20 steps, ``--phase2 --binned
    --remat`` at B=16, ``--attention-impl xla`` (K1/K2 launch 0 times), the
    host time to make a batch; a distillation step of the
    4l-312 and 6l-768 students under a BERT-Large teacher (12 of its 24
    layers) at B=32 S=128,
    timed, and at B=2 in fp32 against the CPU in float64; ``dlrm
    --data-backend binary`` at B=65,536 on 4M records the script writes (26
    unequal tables, 2.6M rows), 20 steps and AUC over the trailing 2%,
    beside the synthetic backend
25. speech: K1 and K2 against their plain versions at FastPitch's shapes
    (B=32, one head, S=32 and 900, masked, attention dropout 0.1) and
    wav2vec2's (B=32, 12 heads, S=49, unmasked), bf16 and fp32, with times;
    one fp32 step of FastPitch, HiFi-GAN's generator and discriminators,
    wav2vec2 BASE, JASPER_10x5DR and QUARTZNET_15x5 at full width, B=2, on
    the card against the CPU in float64 (the bf16 step the control);
    ``fastpitch``, ``hifigan``, ``wav2vec2`` and
    ``jasper`` through the CLI's runners, bf16, B=32, 10 steps each;
    ``fastpitch_hifigan_endpoint`` and ``jasper_offline_endpoint`` behind
    the HTTP server, 8 concurrent requests each against direct calls; one
    bf16 ``Wav2Vec2CtcTask`` step with its greedy decode
26. real data: what the host offers the data plane (libjpeg, nvJPEG,
    cores, g++); the card's data plane (nvJPEG, then the resample kernel)
    on ``tests/data/jpeg`` against JAX's plane (``expected.npz``) in pixel
    levels, once as the 14 fixtures and once as a batch of 256 of them,
    the resample kernel against its plain version at B=256 224, the decode
    rate on the few-kB fixtures and on the ImageNet-sized ones;
    ``resnet50 --data-backend imagenet`` (B=256 on the ImageNet-sized
    fixtures, 8 steps and the val pass, beside the synthetic loader in
    the same run) and ``ssd300 --data-backend coco`` (B=128, 3 steps and
    the eval epoch's mAP) on trees of hard links to the fixtures; one fp32
    full-width GPUNet-0 step against the CPU in float64, and ``gpunet-0``,
    ``gpunet-1``, ``gpunet-2`` and ``gpunet-1 --quant-policy qat`` through
    the CLI; one fp32 EfficientDet-D0 step at 512, B=2, against the CPU in
    float64, ``efficientdet`` on synthetic batches and on a COCO tree with
    its val box AP, and ``predict`` at B=8 with its peak memory

27. mesh axes on the one card: K1 and K2 at a data rank's batch offset (rows
    32-63 of bert-pretrain's B=64) against their plain versions and against
    the whole batch's launches bit for bit; 27a ``torchrun --nproc-per-node
    1`` (NCCL at world 1) runs ``bert-pretrain --mesh-data 1 --zero``
    (BERT-Large, B=64 S=128, 2 steps: phase 10's losses) and ``dlrm
    --mesh-model 1`` (26 x 100,000 x 128, B=65,536), then, alone on the
    card once 27b has ended, their steps on CUDA events in turns with the
    same steps without a mesh; 27b, beside 27a's first steps, two ranks on
    the card over gloo (this script under ``torchrun --nproc-per-node 2``,
    ``DLX_DIST_BACKEND=gloo``) run ``bert-pretrain --mesh-data 2 --zero``
    (6 of BERT-Large's 24 layers), ``resnet50 --mesh-data 2`` (fp32, B=64
    global) and ``dlrm --mesh-model
    2``, 2 steps each, through the CLI's start-up and builders, each held
    against the one-rank run of the same global batch on rank 0 (losses,
    parameters in norm, BN running statistics), with each rank's optimizer
    state and table rows
28. breadth families, where no TPU kernel lies: one fp32 step of NCF, TFT,
    nnU-Net's 2-D DynUNet, Transformer-XL (on a second segment, its memory
    live) and MoFlow at small widths on the card, TF32 off, dropout 0,
    against the same step on the CPU in float64 (the bf16 step the control
    for the three that train in bf16); ``ncf`` (B=131,072), ``tft``
    (configs.yml's section, 2 epochs), ``nnunet`` (B=64, 128 x 128),
    ``transformer-xl`` (B=32, segments and memories of 192) and ``moflow``
    (B=512) through the CLI's runners, 10 or more steps each, every step on
    CUDA events and two under torch.profiler: losses that fall, the median
    step, the rate, the device idle share and kernel time by part
    (``chiprun_out/phase28.json``)
29. Mask R-CNN and the SE(3)-Transformer, where no TPU kernel lies either:
    one fp32 step of each at a small width on the card (Mask R-CNN on the
    float64 step's proposals, both samplers on the same uniforms) against
    the CPU in float64, the bf16 step the control; ``maskrcnn
    --config-file configs.yml`` (R50-FPN, 800 x 800, B=16, bf16, 8 steps on
    CUDA events, two under torch.profiler with kernel time by the loss's
    spans and the NMS loop's launches), ``maskrcnn --data-backend coco`` on
    a COCO tree of the fixtures with polygons (box and mask mAP on its val
    split), ``se3-transformer`` B=256 and one ``SE3RegressionTask(
    SE3Config())`` step at the reference's width on 29 atoms, B=48
    (``chiprun_out/phase29.json``)
30. serving: one ``InferenceServer`` with the nine recipes JAX's
    ``serving/recipes.py`` has beyond the speech pair, fp32, full width,
    random weights: ``bart_endpoint`` (bart-large, source 1024, beam 4, 64
    target positions: K1 in the encoder and the cross-attention at Sq = 1),
    ``gnmt_endpoint`` (the CLI's GNMT), ``tft_endpoint`` (the CLI's TFT),
    ``ncf_endpoint`` (ML-20M's NeuMF), ``unet_endpoint`` (the 2-D DynUNet at
    128 x 128), ``transformer_xl_generate_endpoint`` (WT103, seg_len 192),
    ``efficientdet_endpoint`` (D0 at 512) and ``maskrcnn_endpoint`` (R50-FPN
    at 800); a few seeded requests sent at once to each (the images binary,
    the rest JSON), each answer against the endpoint's function on that
    request alone at the bucket its dispatch ran at, K1's launches against
    the formula and 0 K1-K6 elsewhere, p50/p99 request latency and
    ``device_ms``; NCF through ``strip_checkpoint`` and ``hub.load`` of the
    repository, its answers the live model's; ``quartznet_streaming_server``
    (QuartzNet-15x5) on 3 interleaved 4 s, 16 kHz streams: partials
    prefixes of the final transcript, streams isolated, and the windowed
    log-probabilities the full utterance's where the context covers it
31. the sequence axis, GPipe and MoE, two ranks on the card over gloo (this
    script under ``torchrun --nproc-per-node 2``): 31a ``bert-pretrain
    --phase2 --attention-impl ring --mesh-data 1 --mesh-sequence 2``
    (BERT-Large, B=8 S=512, bf16, dropout on, lr 0.006, 3 steps) through
    the CLI's start-up and builder, against the one-rank ``--attention-impl
    flash`` run of the same seed and batches (K1/K2, the same dropout
    masks): losses and parameters within limits, the two ranks' parameters
    equal bit for bit, 0 K1-K6 launches, step times and peak memory per
    rank; 31b ``ring_attention`` in fp32 at B=8 H=16 S=512 D=64 with a key
    mask, contiguous and causal zigzag, with and without dropout, against
    ``mha_reference``; 31c ``pipeline_apply`` with 2 stages of 12
    BERT-Large layers, 4 microbatches of B=4 S=512, fp32, without and with
    remat, against the stages run in turn, with peak memory; 31d
    ``MoEFeedForward`` at Switch-Base-8's width (768, 3072, 8 experts,
    capacity factor 1.25), top-1 and top-2 at B=8 T=512 fp32, against
    ``moe_reference`` at T=128 and itself in float64 on the CPU at T=512,
    and 4 experts a rank against the whole layer, forward and gradients
32. the data axis of the seventeen commands PR 14 left on one rank:
    FastPitch's K1 with attention dropout at a rank's batch offset against
    the whole batch's rows bit for bit and its plain version; then two gloo
    ranks on the card (this script under ``torchrun --nproc-per-node 2``)
    run each of ``tacotron2``, ``waveglow``, ``transformer``, ``bart``,
    ``gnmt``, ``fastpitch``, ``hifigan``, ``jasper``, ``wav2vec2``,
    ``ncf``, ``tft``, ``nnunet``, ``transformer-xl``, ``moflow``,
    ``se3-transformer``, ``efficientdet`` and ``maskrcnn`` (and
    ``transformer`` with padded targets) through the CLI at ``--mesh-data
    2``, the CLI's widths (``FAMILY_CUTS`` the depth of four), B=4 global,
    fp32, 2 steps, while this process runs the one-rank run of the same
    global batches: the first step's loss, every step's, the first step's
    gradients in norm and BN running statistics, the eval metrics, the two
    ranks' parameters bit for bit, K1/K2's launches on the attention paths

The phases run in this order: 1, then 19-22 while ``nvcc`` builds the
kernels on the host's cores (phase 2, joined before phase 3), then 3-18 and
23-32. The float64 CPU references of phases 19, 22, 23, 25, 28 and 29 run on a
host thread while the card runs the rest of their phase (19's beside 20), so
the times that phases 20-22 print are taken with the host under load (they
say so); each phase's seconds are printed before the kernels line.

Each main path (serving: phases 5-6; BERT training: phase 10; DLRM
training: phase 13; ``int8_matmul``: phase 14; ``fused_lamb``: phase 15;
``hot_gather``: phase 16; BERT fine-tuning: phase 18; each ConvNets run of
phase 20; SSD300's training, resume and inference in phase 21; Tacotron2's
and WaveGlow's training and the TTS pipeline in phase 22; the beam searches
and each encoder-decoder run of phase 23; each CLI run of phase 24; each
speech command, both speech endpoints and the CTC step of phase 25; each
CLI run of phase 26; the mesh runs of phases 27, 31 and 32 in their
processes;
each CLI run of phase 28 and each run of phase 29; each endpoint's traffic
and the streams of phase 30) runs with the launch counts set to 0 just
before it and read just after; on the ConvNets, SSD300, TTS, GNMT,
``--attention-impl xla``, HiFi-GAN, Jasper, phase 28's and phase 29's
synthetic paths, phase 30's endpoints but BART's and phase 31's ring,
pipeline and MoE every count must stay 0, on the
Transformer and BART paths K1 and K2 must launch and K3-K6 must not (BART's
endpoint K1 alone, ``encoder_layers + decoder_layers x (targets - 1)`` a
dispatch),
FastPitch and wav2vec2 launch K1 12 and K2 12 + 12 times a step, and on
phase 26's and 29's real-data paths the resample kernel launches once a
batch and
K1-K6 never (the ``kernels`` line lists it beside K1-K6: it is not a TPU
kernel, but the host plane's fused resample, which the card runs for want
of libjpeg). Then one JSON
line with each kernel's launches on those paths, its error against the plain
version, its time, the plain version's, its bound on this card and the time
of the PyTorch call that computes the same function (where there is one),
and last ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; without a CUDA card it fails before printing a result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import hashlib
import importlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path
from typing import Any
from unittest import mock

import numpy as np
import torch

from deeplearningexamples_tpu_torch.data.squad import (
    convert_examples_to_features,
    read_squad_examples,
)
from deeplearningexamples_tpu_torch.data.tokenization import BertTokenizer
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.parallel import mesh as pmesh
from deeplearningexamples_tpu_torch.cli.main import _bert_finetune_tx, cli
from deeplearningexamples_tpu_torch.core import flat
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.core.optimizers import (
    adam,
    adamw,
    chain,
    clip_by_global_norm,
    lr_poly_warmup,
    no_decay_mask,
    sgd,
)
from deeplearningexamples_tpu_torch.data.synthetic import (
    SyntheticBertLoader,
    SyntheticDlrmLoader,
    SyntheticImageLoader,
)
from deeplearningexamples_tpu_torch.models.bert import (
    BERT_CONFIGS,
    BertForPreTraining,
    BertForQuestionAnswering,
    BertModel,
    BertPretrainTask,
    BertSquadTask,
    predict_squad,
)
from deeplearningexamples_tpu_torch.models.bert.modeling import BertLayer
from deeplearningexamples_tpu_torch.models.bert.task import init_bert_weights_
from deeplearningexamples_tpu_torch.models.bert.distillation import (
    STUDENT_CONFIGS,
    DistillationTask,
)
from deeplearningexamples_tpu_torch.data import bert_prep, criteo
from deeplearningexamples_tpu_torch.models.convnets import (
    EFFNET_ARCHS,
    ClassificationTask,
    EfficientNet,
    build_model,
)
from deeplearningexamples_tpu_torch.models.convnets.layers import BatchNorm2d
from deeplearningexamples_tpu_torch.models.convnets.quant import QATConv
from deeplearningexamples_tpu_torch.data.ssd_synthetic import SyntheticSSDLoader
from deeplearningexamples_tpu_torch.data.summarization import rouge_scores
from deeplearningexamples_tpu_torch.models.ssd import (
    SSD300,
    SSDTask,
    dboxes300_coco,
    encode,
    nms_single,
)
from deeplearningexamples_tpu_torch.models.ssd import evaluate as ssd_evaluate
from deeplearningexamples_tpu_torch.models.ssd.task import color_twist
from deeplearningexamples_tpu_torch.data.tts_synthetic import (
    SyntheticTacotronLoader,
    SyntheticWaveGlowLoader,
)
from deeplearningexamples_tpu_torch.models.tts import (
    Tacotron2,
    Tacotron2Task,
    TTSPipeline,
    WaveGlowConfig,
    WaveGlowTask,
)
from deeplearningexamples_tpu_torch.models.tts.layers import (
    Dropout as TtsDropout,
)
from deeplearningexamples_tpu_torch.models.tts import (
    FastPitchConfig,
    FastPitchTask,
    HiFiGanTask,
)
from deeplearningexamples_tpu_torch.models.asr import (
    JASPER_10x5DR,
    QUARTZNET_15x5,
    JasperBlock,
    JasperConfig,
    JasperTask,
    greedy_ctc_decode,
)
from deeplearningexamples_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2CtcTask,
    Wav2Vec2Task,
    sample_spans_mask,
)
from deeplearningexamples_tpu_torch.serving import recipes as speech_recipes
from deeplearningexamples_tpu_torch.models.bart import BartConfig, BartTask
from deeplearningexamples_tpu_torch.models.translation import (
    GnmtConfig,
    GnmtTask,
    TransformerConfig,
    TransformerTask,
    beam_search,
    beam_search_cached,
)
from deeplearningexamples_tpu_torch.models.moflow import MoFlowConfig, MoFlowTask
from deeplearningexamples_tpu_torch.models.ncf import NcfConfig, NcfTask
from deeplearningexamples_tpu_torch.models.tft import TFTConfig, TFTTask
from deeplearningexamples_tpu_torch.models.transformer_xl import (
    TransformerXLConfig,
    TransformerXLTask,
)
from deeplearningexamples_tpu_torch.models.unet import UNetConfig, UNetTask
from deeplearningexamples_tpu_torch.models.dlrm import (
    Dlrm,
    DlrmConfig,
    DlrmTask,
    make_dlrm_optimizer,
)
from deeplearningexamples_tpu_torch.data.det_synthetic import (
    SyntheticDetectionLoader,
)
from deeplearningexamples_tpu_torch.data.imagenet import (
    ImageNetLoader,
    sample_rrc_pixels,
)
from deeplearningexamples_tpu_torch.data.jpeg_trees import coco_tree, imagenet_tree
from deeplearningexamples_tpu_torch.models.efficientdet import (
    EfficientDetConfig,
    EfficientDetTask,
)
from deeplearningexamples_tpu_torch.models.maskrcnn import (
    SPANS,
    MaskRCNN,
    MaskRCNNConfig,
    MaskRCNNTask,
    fpn_anchors,
)
from deeplearningexamples_tpu_torch.models.se3_transformer import (
    SE3Config,
    SE3RegressionTask,
)
from deeplearningexamples_tpu_torch.native import MEAN, STD, DataPlane
from deeplearningexamples_tpu_torch.ops import _build
from deeplearningexamples_tpu_torch.ops import resample
from deeplearningexamples_tpu_torch.ops import embedding as emb
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.ops import fused_lamb as fused
from deeplearningexamples_tpu_torch.ops import quantization as quant
from deeplearningexamples_tpu_torch.ops.lamb import lamb
from deeplearningexamples_tpu_torch.ops.moe import (
    MoEConfig,
    MoEFeedForward,
    capacity as moe_capacity,
    moe_reference,
)
from deeplearningexamples_tpu_torch.ops.ring_attention import ring_attention
from deeplearningexamples_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from deeplearningexamples_tpu_torch.tools import (
    profile_pretrain,
    profile_seq2seq,
    profile_serving,
)
from deeplearningexamples_tpu_torch.tools.dlrm_hotrow import flat_ids
from deeplearningexamples_tpu_torch.utils.jax_bridge import bert_pretrain_jax_order
from deeplearningexamples_tpu_torch.serving import (
    ContinuousBatcher,
    InferenceServer,
    ModelEndpoint,
    http_infer,
)
from deeplearningexamples_tpu_torch import hub
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager
from deeplearningexamples_tpu_torch.models.tts.audio import (
    MelConfig,
    mel_spectrogram,
)
from deeplearningexamples_tpu_torch.utils.checkpoint_tools import strip_checkpoint

SEED = 0
DEV = "cuda:0"
ROOT = Path(__file__).resolve().parent
B, S, H, D = 8, 384, 16, 64  # the BERT-Large attention shape served here
TB, TS = 64, 128  # the pretraining shape (phase 1 of BERT pretraining)
LAYERS = BERT_CONFIGS["large"].num_layers
INPUTS = ("input_ids", "attention_mask", "token_type_ids")
# Published peaks of one H100 SXM (dense): bf16 on the tensor cores, fp32 on
# the FMA pipe, and device memory; a bound is the larger of the two times
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Kernel against plain on the card. fp32: the online softmax sums in another
# order than the plain version's full-row softmax. bf16: P is rounded to bf16
# against a different running maximum, so out differs by about one bf16 ulp
# of values near 1; lse stays in fp32 on both sides.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
# The fp32 slice on the card against the CPU: 24 layers of fp32 GEMMs whose
# sums run in another order (TF32 is off).
TOL_SLICE_F32 = 1e-3
# bf16 on the card against fp32 on the CPU: a sanity floor for the direction
# of the logits, not a parity claim.
MIN_COS_BF16 = 0.99
# A request served in a batch of 1-8 against the same request in a batch of
# 16: bf16 GEMMs of other shapes round differently.
TOL_SERVED = 5e-2
# K2 against the plain backward, relative to the largest gradient entry:
# fp32 sums run in another order; bf16 rounds dS and P from fp32 values that
# differ in the last bits, so an entry can move by a bf16 ulp before the sums.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K3 against the plain passes after three steps, relative to the largest
# parameter: the kernel may fuse a multiply-add the plain version rounds
# twice, and a bf16 moment that lands an ulp apart moves u by 2**-8 of itself
TOL_LAMB = {torch.float32: 1e-6, torch.bfloat16: 1e-4}
# One fp32 training step, card against CPU (TF32 off). The loss and the
# gradient norm to the sums' order (the CPU's norms sum in fp64 across chunks,
# ops/lamb.py). The parameters to 1e-3 of the largest update, because LAMB's
# first step u = g / (|g| + eps) turns the rounding noise of a near-zero
# gradient (the key biases', whose true gradient is 0) into a visible share of
# a (small) update.
#
# Each gradient tensor to 1e-4 of the largest gradient entry (max abs error):
# on an H100 the sound reading is about 1.4e-6 and the same step in bf16, the
# control, reads about 1.2e-2 against the fp32 CPU; a wrong dq, dk or dv in
# one layer moves its attention weights' gradients by far more than 1e-4 of
# the largest entry, where the loss, the norm and LAMB's first update (about
# lr * sign(g)) hardly move.
TOL_STEP = {"loss": 1e-5, "grad_norm": 1e-4, "update": 1e-3, "grad": 1e-4}
# bert-pretrain's learning rate in these runs: configs.yml's phase-1 LAMB rate
# (the CLI's own default, 0.1, is CommonConfig's and throws BERT-Large's loss
# up to 20 before it falls)
PRETRAIN_LR = "0.006"
# The tree and the flat LAMB take the same first update (lr(0) = lr(1) with
# one warmup step) but for the trust ratio, which the flat path takes from the
# moments before they are rounded to bf16: the second step's losses agree to
# that rounding.
TOL_TREE_FLAT = 1e-3
# bf16 step on the card against the fp32 step on the CPU: a floor on the
# cosine of the gradients, not a parity claim.
MIN_COS_GRAD_BF16 = 0.99


# DLRM at the full width the repo supports (bench.py, the CLI's defaults,
# configs.yml): 26 tables of 100,000 rows, D=128, B=65,536, configs.yml's lr
DLRM_TABLES, DLRM_CARD, DLRM_B = 26, 100_000, 65_536
DLRM_LR = "24.0"
# the CLI's default rate (CommonConfig's, as in JAX): lr 24 without warmup
# diverges (phase 13)
DLRM_LR_STABLE = "0.1"
DLRM_CFG = DlrmConfig(categorical_cardinalities=(DLRM_CARD,) * DLRM_TABLES)
# One fp32 DLRM step, card against CPU (TF32 off), at B=4096: the loss to the
# sums' order; each gradient tensor to 1e-4 of its own largest entry (the
# MLPs' GEMMs sum 4096 rows in another order; the table's gradient sums each
# row's lookups in their batch order on both sides); the parameters after the
# SGD step to 1e-4 of each tensor's largest update (SGD's update is -lr * g).
# The table's gradient alone must repeat bit for bit on the card.
TOL_DLRM = {"loss": 1e-5, "grad": 1e-4, "update": 1e-4}


def _reset_counts() -> None:
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    flat.launches_moments = flat.launches_apply = 0
    emb.launches = emb.launches_hot = 0
    quant.launches = 0
    resample.launches = 0


def _counts() -> dict[str, int]:
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_bwd_dq,
            "flash_bwd_dkv": fa.launches_bwd_dkv,
            "flat_lamb_moments": flat.launches_moments,
            "flat_lamb_apply": flat.launches_apply,
            "gather_rows": emb.launches,
            "quantize_activations": quant.launches,
            "hot_gather": emb.launches_hot,
            "resample_normalize": resample.launches}


T_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of a phase, after the seconds since the script started."""
    print(f"[{phase}] ({time.perf_counter() - T_START:.1f} s) {msg}",
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


# -- phase 1 -----------------------------------------------------------------


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is false")
    print(card(), flush=True)
    # the fp32 checks compare full fp32 arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("1 device", f"{name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    return name


# -- phase 2 -----------------------------------------------------------------


def phase_build() -> None:
    nvcc = _build.nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    t0 = time.perf_counter()
    libs = _build.build()  # the kernels' and the data plane's, together
    for name in _build.LIBRARIES:
        _build.load(name)
    say("2 build", f"{', '.join(lib.name for lib in libs)} ready in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({nvcc}: {version.strip().splitlines()[-1]})")


# -- phase 3 -----------------------------------------------------------------


def _attn_inputs(b, s, h, d, dtype, layout, masked=True, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v = (torch.randn(shape, generator=g).to(DEV, dtype) for _ in range(3))
    mask = None
    if masked:
        lengths = torch.randint(s // 4, s + 1, (b,), generator=g)
        mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
        mask[-1] = 0  # one batch row with every key masked
        mask = mask.to(DEV)
    return q, k, v, mask


def _bound(bytes_: float, flops: float, dtype) -> tuple[float, str]:
    """The least time this card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _event_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 50) -> float:
    """``_event_ms`` with the launches queued behind a sleep of about 10 ms
    on the card, so that a kernel shorter than its launch's host time is
    timed back to back: the card's time alone."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _clocks(fns: dict, turns: int = 3) -> dict:
    """Each of ``fns`` ({name: (fn, iters)}) timed in turns, ``turns`` times
    on each clock, so that drift between readings spreads over all of them:
    {name: (least ``_event_ms``, least ``_device_ms``)}. The first, the
    launches as a caller makes them, is the one the kernels JSON line
    carries; the second is the card's time alone."""
    got = {name: ([], []) for name in fns}
    for _ in range(turns):
        for name, (fn, iters) in fns.items():
            got[name][0].append(_event_ms(fn, iters))
            got[name][1].append(_device_ms(fn, iters))
    return {name: (min(ev), min(dev)) for name, (ev, dev) in got.items()}


def phase_kernel() -> dict:
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bshd"),
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bhsd"),
            dict(b=4, s=S, h=H, d=32, dtype=dtype, layout="bshd"),
            dict(b=4, s=S, h=8, d=128, dtype=dtype, layout="bshd"),
            dict(b=1, s=2048, h=H, d=D, dtype=dtype, layout="bshd",
                 masked=False, causal=True),
            # causal with a fully masked row: the skipped tiles still count
            dict(b=2, s=520, h=4, d=D, dtype=dtype, layout="bshd", causal=True),
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-1234567),
            # the training shape of --phase2, with its dropout
            dict(b=8, s=512, h=H, d=D, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-7654321),
        ]
    worst = 0.0
    for c in cases:
        q, k, v, mask = _attn_inputs(c["b"], c["s"], c["h"], c["d"],
                                     c["dtype"], c["layout"],
                                     c.get("masked", True))
        kw = dict(causal=c.get("causal", False), layout=c["layout"],
                  dropout_rate=c.get("rate", 0.0),
                  dropout_seed=c.get("seed", 0))
        before = fa.launches
        out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        check(fa.launches == before + 1, f"kernel not launched for {c}")
        ref, ref_lse = fa.mha_reference(q, k, v, mask, kw["causal"],
                                        layout=kw["layout"],
                                        dropout_rate=kw["dropout_rate"],
                                        dropout_seed=kw["dropout_seed"])
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        tol_out, tol_lse = TOL[c["dtype"]]
        finite = {name: bool(torch.isfinite(t.float()).all()) for name, t in
                  (("out", out), ("lse", lse), ("plain out", ref),
                   ("plain lse", ref_lse))}
        check(e_out <= tol_out and e_lse <= tol_lse,
              f"kernel vs plain {c}: out {e_out:.3e} lse {e_lse:.3e}; "
              f"finite: {finite}")
        worst = max(worst, e_out)
        c["err"] = (e_out, e_lse)

    main = _time_fwd(B, S, H, D, "bshd")
    # the shapes of the TPU's other forwards: _fwd (bhsd) and _fwd_kblk
    # (long causal context); and the fp32 instance (the FMA kernel)
    others = {"bhsd": _time_fwd(B, S, H, D, "bhsd"),
              "causal s2048": _time_fwd(1, 2048, H, D, "bshd", masked=False,
                                        causal=True),
              "fp32": _time_fwd(B, S, H, D, "bshd", dtype=torch.float32)}
    errs = ", ".join(
        f"{'f32' if c['dtype'] == torch.float32 else 'bf16'} {c['layout']} "
        f"b{c['b']} s{c['s']} h{c['h']} d{c['d']}"
        f"{' causal' if c.get('causal') else ''}"
        f"{' drop' if c.get('rate') else ''}: {c['err'][0]:.2e}/{c['err'][1]:.2e}"
        for c in cases)
    say("3 kernel", f"flash_fwd vs plain, max abs err out/lse: {errs}; "
        f"bf16 b{B} s{S} h{H} d{D} masked: {_fmt_times(main)}; bf16 b{B} "
        f"s{S} h{H} d{D} bhsd masked: {_fmt_times(others['bhsd'])}; bf16 b1 "
        f"s2048 h{H} d{D} causal: {_fmt_times(others['causal s2048'])}; fp32 "
        f"b{B} s{S} h{H} d{D} masked: {_fmt_times(others['fp32'])} "
        "(CUDA events over 50 calls, least of 3 in turns; [the card's clock "
        "alone, launches queued behind a sleep])")
    return {"max_abs_err": worst, **main}


def _fmt_times(t: dict) -> str:
    dev = t["device_ms"]
    return (f"kernel {t['ms']:.4f} [{dev['ms']:.4f}] ms, plain "
            f"{t['plain_ms']:.4f} [{dev['plain_ms']:.4f}] ms, "
            f"scaled_dot_product_attention {t['library_ms']:.4f} "
            f"[{dev['library_ms']:.4f}] ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")


def _pairs(b: int, h: int, s: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: half the square, with the
    diagonal, when causal."""
    return b * h * (s * (s + 1) // 2 if causal else s * s)


def _time_fwd(b, s, h, d, layout, masked=True, causal=False,
              dtype=torch.bfloat16) -> dict:
    """K1, its plain version and SDPA on one input, in turns."""
    q, k, v, mask = _attn_inputs(b, s, h, d, dtype, layout, masked)

    def kernel():
        return fa.flash_attention(q, k, v, mask, causal=causal, layout=layout)

    def plain():
        return fa.mha_reference(q, k, v, mask, causal, layout=layout)

    sdpa_mask = None if mask is None else mask.bool()[:, None, None, :]
    qt, kt, vt = ((t.transpose(1, 2) for t in (q, k, v)) if layout == "bshd"
                  else (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal)

    with torch.inference_mode():
        ms = _clocks({"ms": (kernel, 50), "plain_ms": (plain, 20),
                      "library_ms": (library, 50)})
    n = b * s * h * d
    bound_ms, bound_by = _bound(  # q, k, v, out; lse; mask
        bytes_=4 * n * q.element_size() + b * h * s * 4
        + (b * s * 4 if masked else 0),
        flops=4 * _pairs(b, h, s, causal) * d, dtype=dtype)
    return {**{k: ev for k, (ev, _) in ms.items()}, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "device_ms": {k: dev for k, (_, dev) in ms.items()}}


# -- phase 4 -----------------------------------------------------------------


def _qa_batch(rng, n: int, seq: int = S) -> dict[str, np.ndarray]:
    lengths = rng.integers(seq // 3, seq + 1, size=n)
    ids = rng.integers(1000, 30522, size=(n, seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    ids *= mask
    seg = ((np.arange(seq)[None, :] >= lengths[:, None] // 3) & (mask > 0))
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": seg.astype(np.int32)}


def _forward(task, model, batch, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return [x.float().cpu() for x in task.predict_fn(model, t)]


def phase_slice():
    cfg = BERT_CONFIGS["large"]
    t0 = time.perf_counter()
    task32 = BertSquadTask(cfg, dtype=torch.float32)
    cpu_model = task32.init(torch.Generator().manual_seed(SEED), device="cpu")
    batch = _qa_batch(np.random.default_rng(SEED), 2)

    gpu32 = task32.place(copy.deepcopy(cpu_model), DEV)
    before = fa.launches
    got32 = _forward(task32, gpu32, batch, DEV)
    check(fa.launches - before == LAYERS,
          f"fp32 forward launched {fa.launches - before}, want {LAYERS}")
    del gpu32
    want = _forward(task32, cpu_model, batch, "cpu")
    err32 = max(max_err(g, w) for g, w in zip(got32, want))
    check(err32 <= TOL_SLICE_F32, f"fp32 card vs CPU logits: {err32:.3e}")

    task16 = BertSquadTask(cfg, dtype=torch.bfloat16)
    gpu16 = task16.place(copy.deepcopy(cpu_model), DEV)
    before = fa.launches
    got16 = _forward(task16, gpu16, batch, DEV)
    check(fa.launches - before == LAYERS,
          f"bf16 forward launched {fa.launches - before}, want {LAYERS}")
    err16 = max(max_err(g, w) for g, w in zip(got16, want))
    cos = min(float(torch.nn.functional.cosine_similarity(
        g.flatten(), w.flatten(), dim=0)) for g, w in zip(got16, want))
    check(all(bool(torch.isfinite(g).all()) for g in got16), "bf16 non-finite")
    check(cos >= MIN_COS_BF16, f"bf16 vs fp32 cosine {cos:.5f}")
    say("4 slice", f"BERT-Large QA b2 s{S} padded: fp32 card vs CPU max abs "
        f"err {err32:.3e}; bf16 card vs fp32 CPU max abs err {err16:.3e}, "
        f"cosine {cos:.6f}; {LAYERS} launches per forward; "
        f"{time.perf_counter() - t0:.1f} s")
    return task16, gpu16


# -- phase 5 -----------------------------------------------------------------


def phase_serving(task, model) -> int:
    """Serves 16 concurrent requests; returns the launches they caused."""
    def infer(batch):
        start, end = task.predict_fn(
            model, {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()})
        return {"start_logits": start, "end_logits": end}

    rng = np.random.default_rng(SEED + 1)
    flat = _qa_batch(rng, 16)
    reqs = [{k: flat[k][i] for k in INPUTS} for i in range(16)]
    direct = {k: v.cpu().numpy() for k, v in infer(flat).items()}

    batcher = ContinuousBatcher(infer, batch_buckets=(1, 2, 4, 8),
                                max_delay_s=0.005)
    batcher.warmup(reqs[0])  # builds and first launches before serving
    server = InferenceServer("127.0.0.1", 0)
    server.register(ModelEndpoint(
        name="bert_large_qa", batcher=batcher,
        input_spec={k: ((S,), "int32") for k in INPUTS},
        output_names=("start_logits", "end_logits")))
    server.start()
    try:
        base = f"http://{server.addr[0]}:{server.addr[1]}/v2"
        with urllib.request.urlopen(f"{base}/health/ready", timeout=30) as r:
            check(json.loads(r.read()).get("ready") is True, "not ready")
        results: list = [None] * len(reqs)
        errors: list = []

        def client(i):
            try:
                results[i] = http_infer(server.addr, "bert_large_qa", reqs[i],
                                        binary=i % 2 == 1)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        _reset_counts()  # the serving path starts here
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launched = fa.launches
        check(not any(t.is_alive() for t in threads), "requests hung")
        if errors:
            raise errors[0]
        worst = 0.0
        for i, res in enumerate(results):
            for name in ("start_logits", "end_logits"):
                got = np.asarray(res["outputs"][name], np.float32)
                check(got.shape == (S,), f"request {i} {name} {got.shape}")
                worst = max(worst, float(np.abs(got - direct[name][i]).max()))
        check(worst <= TOL_SERVED, f"served vs direct: {worst:.3e}")
        with urllib.request.urlopen(f"{base}/models/bert_large_qa/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        check(stats == batcher.stats(), "stats route disagrees with batcher")
        check(launched == LAYERS * stats["dispatches"],
              f"{launched} launches for {stats['dispatches']} dispatches")
    finally:
        server.stop()
    say("5 serving", f"16 requests (8 JSON, 8 binary) answered, max abs err "
        f"vs direct forward {worst:.3e}; dispatches {stats['dispatches']}, "
        f"mean_batch {stats['mean_batch']:.2f}, device_ms p50 "
        f"{stats['device_ms_p50']:.2f} p95 {stats['device_ms_p95']:.2f}, "
        f"wait_ms p50 {stats['wait_ms_p50']:.2f}")
    return launched


# -- phase 6 -----------------------------------------------------------------

SQUAD = {"data": [{"title": "smoke", "paragraphs": [{
    "context": "The Normans were the people who in the 10th and 11th "
               "centuries gave their name to Normandy, a region in France. "
               "They were descended from Norse raiders led by their chief "
               "Rollo, who swore fealty to King Charles III of West Francia.",
    "qas": [
        {"id": "q1", "question": "In what country is Normandy?",
         "answers": [{"text": "France", "answer_start": 104}]},
        {"id": "q2", "question": "Who led the Norse raiders?",
         "answers": [{"text": "Rollo", "answer_start": 170}]},
        {"id": "q3", "question": "To which king did Rollo swear fealty?",
         "answers": [{"text": "King Charles III", "answer_start": 197}]},
    ],
}]}]}


def phase_predict(task, model) -> int:
    para = SQUAD["data"][0]["paragraphs"][0]
    words = sorted({w for text in [para["context"]]
                    + [qa["question"] for qa in para["qas"]]
                    for w in BertTokenizer({}).basic.tokenize(text)})
    vocab = {w: i for i, w in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dev.json"
        path.write_text(json.dumps(SQUAD))
        examples = read_squad_examples(str(path), is_training=False)
    feats = convert_examples_to_features(
        examples, BertTokenizer(vocab), max_seq_length=S, doc_stride=128,
        is_training=False)
    before = fa.launches
    preds = predict_squad(task, model, feats, batch_size=8)
    launched = fa.launches - before
    check(launched == LAYERS * -(-len(feats) // 8),
          f"predict_squad launched {launched} for {len(feats)} features")
    check(set(preds) == {qa["id"] for qa in para["qas"]}, f"answers {preds}")
    for qid, text in preds.items():
        check(bool(text) and text in para["context"],
              f"{qid}: {text!r} is not a span of the context")
    say("6 predict_squad", f"{len(feats)} features -> "
        + "; ".join(f"{q}: {t!r}" for q, t in sorted(preds.items())))
    return launched


# -- phase 7 -----------------------------------------------------------------


def _fwd_bwd_case(c: dict) -> None:
    """K1 and K2 on one case against their plain versions (raises past
    ``TOL``/``TOL_BWD``); sets ``c["err"]`` to (K2's max abs err, K1's out
    and lse errors) and ``c["rel"]`` to K2's worst error over the largest
    entry of its gradient."""
    q, k, v, mask = _attn_inputs(c["b"], c["s"], c["h"], c["d"], c["dtype"],
                                 c["layout"], c.get("masked", True))
    kw = dict(causal=c.get("causal", False), layout=c["layout"],
              dropout_rate=c.get("rate", 0.0), dropout_seed=c.get("seed", 0))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                       ).to(DEV, c["dtype"])
    for t in (q, k, v):
        t.requires_grad_()
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    # K1 at this shape too: the training path's forward
    ref, ref_lse = fa.mha_reference(q.detach(), k.detach(), v.detach(),
                                    mask, **kw)
    e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
    tol_out, tol_lse = TOL[c["dtype"]]
    check(e_out <= tol_out and e_lse <= tol_lse,
          f"K1 vs plain {c}: out {e_out:.3e} lse {e_lse:.3e}")
    del ref, ref_lse
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out.backward(dout)
    torch.cuda.synchronize()
    check((fa.launches_bwd_dq, fa.launches_bwd_dkv)
          == (before[0] + 1, before[1] + 1), f"K2 not launched for {c}")
    want = fa.mha_backward_reference(
        q.detach(), k.detach(), v.detach(), mask, out.detach(), lse, dout,
        kw["causal"], layout=kw["layout"], dropout_rate=kw["dropout_rate"],
        dropout_seed=kw["dropout_seed"])
    errs, rel = [], 0.0
    for name, got, ref in zip("qkv", (q.grad, k.grad, v.grad), want):
        err, scale = max_err(got, ref), float(ref.float().abs().max())
        check(math.isfinite(err) and err <= TOL_BWD[c["dtype"]] * scale,
              f"K2 vs plain {c}: d{name} err {err:.3e}, largest {scale:.3e}")
        errs.append(err)
        rel = max(rel, err / max(scale, 1e-30))
    c["err"], c["rel"] = (max(errs), e_out, e_lse), rel


def phase_flash_bwd() -> tuple[float, dict]:
    """K2 against the plain backward in every layout, dtype and head dim the
    kernels take, and K1's forward at the same shapes (the training shapes
    among them) against its plain version; times at the pretraining shape.
    Returns K1's worst error here and K2's results."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            dict(b=TB, s=TS, h=16, d=64, dtype=dtype, layout="bshd"),
            dict(b=B, s=S, h=H, d=D, dtype=dtype, layout="bhsd"),
            dict(b=4, s=S, h=H, d=32, dtype=dtype, layout="bshd"),
            dict(b=4, s=S, h=8, d=128, dtype=dtype, layout="bshd"),
            dict(b=1, s=2048, h=H, d=D, dtype=dtype, layout="bshd",
                 masked=False, causal=True),
            # causal with a fully masked row: the skipped tiles still count
            dict(b=2, s=520, h=4, d=D, dtype=dtype, layout="bhsd", causal=True),
            dict(b=TB, s=TS, h=16, d=64, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-1234567),
            dict(b=8, s=512, h=16, d=64, dtype=dtype, layout="bshd", rate=0.1,
                 seed=-7654321),
        ]
    for c in cases:
        _fwd_bwd_case(c)
    worst = max(c["err"][0] for c in cases)
    worst_fwd = max(c["err"][1] for c in cases)
    worst_rel = max(c["rel"] for c in cases)

    # times at the pretraining shape, bf16, masked (dropout off), and at the
    # shapes of the TPU's other backwards: _bwd (bhsd) and _bwd_kblk (long
    # causal context)
    main = _time_bwd(TB, TS, 16, 64, "bshd")
    others = {"bhsd": _time_bwd(B, S, H, D, "bhsd"),
              "causal s2048": _time_bwd(1, 2048, H, D, "bshd", masked=False,
                                        causal=True),
              "fp32": _time_bwd(B, S, H, D, "bshd", dtype=torch.float32)}
    errs = ", ".join(
        f"{'f32' if c['dtype'] == torch.float32 else 'bf16'} {c['layout']} "
        f"b{c['b']} s{c['s']} h{c['h']} d{c['d']}"
        f"{' causal' if c.get('causal') else ''}"
        f"{' drop' if c.get('rate') else ''}: {c['err'][0]:.2e} "
        f"(forward {c['err'][1]:.2e}/{c['err'][2]:.2e})" for c in cases)
    say("7 kernel", f"flash_bwd (dq, dk/dv kernels) vs plain, max abs err of "
        f"dq/dk/dv (and of flash_fwd's out/lse): {errs}; worst relative to "
        f"the largest entry {worst_rel:.2e}; bf16 b{TB} s{TS} h16 d64 masked: "
        f"{_fmt_bwd_times(main)}; bf16 b{B} s{S} h{H} d{D} bhsd masked: "
        f"{_fmt_bwd_times(others['bhsd'])}; bf16 b1 s2048 h{H} d{D} causal: "
        f"{_fmt_bwd_times(others['causal s2048'])}; fp32 b{B} s{S} h{H} d{D} "
        f"masked: {_fmt_bwd_times(others['fp32'])} (CUDA events, least of 3 "
        "in turns; [the card's clock alone, launches queued behind a sleep])")
    common = {"max_abs_err": worst, "plain_ms": main["plain_ms"],
              "library_ms": main["library_ms"]}
    return worst_fwd, {
        f"flash_bwd_{part}": {**common, "ms": main[part][0],
                              "bound_ms": main[part][1],
                              "bound_by": main[part][2]}
        for part in ("dq", "dkv")}


def _fmt_bwd_times(t: dict) -> str:
    dev = t["device_ms"]
    return (f"dq kernel {t['dq'][0]:.4f} [{dev['dq']:.4f}] ms (bound "
            f"{t['dq'][1]:.4f}, {t['dq'][2]}), dk/dv kernel {t['dkv'][0]:.4f} "
            f"[{dev['dkv']:.4f}] ms (bound {t['dkv'][1]:.4f}, {t['dkv'][2]}), "
            f"plain backward {t['plain_ms']:.4f} [{dev['plain_ms']:.4f}] ms, "
            f"scaled_dot_product_attention backward {t['library_ms']:.4f} "
            f"[{dev['library_ms']:.4f}] ms")


def _time_bwd(b, s, h, d, layout, masked=True, causal=False,
              dtype=torch.bfloat16) -> dict:
    """K2's two kernels, the plain backward and SDPA's backward on one input,
    in turns: {"dq": (ms, bound ms, bound by), "dkv": ..., "plain_ms",
    "library_ms", "device_ms": the same times on the card's clock alone}."""
    q, k, v, mask = _attn_inputs(b, s, h, d, dtype, layout, masked)
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, mask, causal=causal,
                                               layout=layout)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                       ).to(DEV, dtype)
    scale = 1.0 / math.sqrt(d)
    _, args, _keep = fa._bwd_buffers(q, k, v, mask, out, lse, dout, causal,
                                     scale, layout, 0.0, 0)
    stream = torch.cuda.current_stream().cuda_stream
    dq_fn, dkv_fn = fa._kernel("dlx_flash_bwd_dq"), fa._kernel("dlx_flash_bwd_dkv")

    def dq_kernel():
        check(dq_fn(*args, stream) == 0, "flash_bwd_dq launch failed")

    def dkv_kernel():  # reads the delta the dq kernel wrote
        check(dkv_fn(*args, stream) == 0, "flash_bwd_dkv launch failed")

    def plain():
        return fa.mha_backward_reference(q, k, v, mask, out, lse, dout, causal,
                                         layout=layout)

    to_bhsd = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
    qs, ks, vs = (to_bhsd(t.detach()).requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=None if mask is None else mask.bool()[:, None, None, :],
        is_causal=causal)
    lib_dout = to_bhsd(dout)

    def library():  # the backward only, through autograd
        return torch.autograd.grad(lib_out, (qs, ks, vs), lib_dout,
                                   retain_graph=True)

    dq_kernel()
    ms = _clocks({"dq": (dq_kernel, 50), "dkv": (dkv_kernel, 50),
                  "plain_ms": (plain, 10), "library_ms": (library, 20)})
    n = b * s * h * d
    rows = b * h * s  # lse and delta entries
    mask_bytes = b * s * 4 if masked else 0
    pairs = _pairs(b, h, s, causal)
    size = q.element_size()
    # dq: reads q, k, v, out, dout, lse, mask; writes dq, delta; s, dp, dq
    dq_bound = _bound(6 * n * size + 2 * rows * 4 + mask_bytes, 6 * pairs * d,
                      dtype)
    # dk/dv: reads q, k, v, dout, lse, delta, mask; writes dk, dv; s, dp, dv, dk
    dkv_bound = _bound(6 * n * size + 2 * rows * 4 + mask_bytes, 8 * pairs * d,
                       dtype)
    return {"dq": (ms["dq"][0], *dq_bound), "dkv": (ms["dkv"][0], *dkv_bound),
            "plain_ms": ms["plain_ms"][0], "library_ms": ms["library_ms"][0],
            "device_ms": {k: dev for k, (_, dev) in ms.items()}}


# -- phase 8 -----------------------------------------------------------------


def _large_layout():
    with torch.device("meta"):
        model = BertForPreTraining(BERT_CONFIGS["large"])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return flat.make_layout_blocked(
        [(n, shapes[n]) for n in bert_pretrain_jax_order(LAYERS)])


def phase_flat_lamb() -> dict:
    """K3 on BERT-Large's flat layout: three steps of flat_lamb with the
    kernels against the same three with the plain passes, from one set of
    random g, p, m, v; then each pass timed."""
    layout = _large_layout()
    rows = layout.total // flat.LANES
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    p0 = torch.randn(rows, flat.LANES, generator=gen, device=DEV) * 0.02
    grads = [torch.randn(rows, flat.LANES, generator=gen, device=DEV) * 1e-3
             for _ in range(3)]
    m0 = torch.randn(rows, flat.LANES, generator=gen, device=DEV) * 1e-4
    v0 = torch.rand(rows, flat.LANES, generator=gen, device=DEV) * 1e-7
    wd = np.asarray([0.01 if flat.default_wd_mask([n])[n] else 0.0
                     for n in layout.names], np.float32)
    sched = lambda count: 1e-3 * count  # noqa: E731
    errs = {}
    for mdt in (torch.float32, torch.bfloat16):
        tx = flat.flat_lamb(sched, layout, wd, moment_dtype=mdt)
        out = {}
        for kind in ("kernel", "plain"):
            p = p0.clone()
            state = flat.FlatLambState(0, m0.to(mdt, copy=True),
                                       v0.to(mdt, copy=True))
            before = (flat.launches_moments, flat.launches_apply)
            if kind == "plain":  # the plain passes, on the card
                with mock.patch.object(flat, "flat_lamb_moments",
                                       flat._moments_plain), \
                        mock.patch.object(flat, "flat_lamb_apply",
                                          flat._apply_plain):
                    for g in grads:
                        p, state = tx.update(g, state, p)
            else:
                for g in grads:
                    p, state = tx.update(g, state, p)
                check((flat.launches_moments, flat.launches_apply)
                      == (before[0] + 3, before[1] + 3), "K3 not launched")
            torch.cuda.synchronize()
            out[kind] = (p, state)
        (pk, sk), (pp, sp) = out["kernel"], out["plain"]
        err = max_err(pk, pp)
        scale = float(pp.abs().max())
        check(math.isfinite(err) and err <= TOL_LAMB[mdt] * scale,
              f"K3 vs plain ({mdt}): p err {err:.3e}, largest {scale:.3e}")
        m_err = max_err(sk.flat_m, sp.flat_m)
        check(m_err <= 1e-2 * float(sp.flat_m.float().abs().max()),
              f"K3 vs plain ({mdt}): m err {m_err:.3e}")
        errs[mdt] = (err, m_err)
        del out, pk, pp, sk, sp

    # times: bf16 moments, the CLI default, on fixed inputs
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32, device=DEV)
    wd_t = torch.as_tensor(wd, device=DEV)
    hyp = torch.tensor([0.9, 0.999, 1e-6, 0.1, 0.001, 0.5], device=DEV)
    scale_leaf = torch.full((layout.n_leaves,), 1e-3, device=DEV)
    p, g = p0.clone(), grads[0]
    m, v = m0.to(torch.bfloat16), v0.to(torch.bfloat16)

    def moments():
        flat.flat_lamb_moments(g, p, m, v, seg, wd_t, hyp)

    def apply():
        flat.flat_lamb_apply(p, m, v, seg, wd_t, hyp, scale_leaf)

    def plain():
        flat._moments_plain(g, p, m, v, seg, wd_t, hyp)
        flat._apply_plain(p, m, v, seg, wd_t, hyp, scale_leaf)

    plain_ms = [_event_ms(plain, 5)]
    mom_ms = [_event_ms(moments, 10), _event_ms(moments, 10)]
    app_ms = [_event_ms(apply, 10), _event_ms(apply, 10)]
    plain_ms.append(_event_ms(plain, 5))
    n = layout.total
    nb = len(layout.seg_ids)
    # pass 1 reads g, p (fp32), m, v (bf16), writes m, v and the partials;
    # about 20 fp32 operations an element
    mom_bound = _bound(n * (4 + 4 + 2 + 2 + 2 + 2) + nb * 8 + nb * 4,
                       20 * n, torch.float32)
    # pass 2 reads p, m, v, writes p; about 10 operations an element
    app_bound = _bound(n * (4 + 2 + 2 + 4) + nb * 4, 10 * n, torch.float32)
    say("8 kernel", f"flat_lamb passes vs plain on BERT-Large's layout "
        f"({n} elements, {layout.n_leaves} tensors, {nb} blocks), 3 steps: "
        f"max abs err p/m fp32 moments {errs[torch.float32][0]:.2e}/"
        f"{errs[torch.float32][1]:.2e}, bf16 moments "
        f"{errs[torch.bfloat16][0]:.2e}/{errs[torch.bfloat16][1]:.2e}; bf16 "
        f"moments: moments pass {min(mom_ms):.4f} ms (bound "
        f"{mom_bound[0]:.4f}, {mom_bound[1]}), apply pass {min(app_ms):.4f} ms "
        f"(bound {app_bound[0]:.4f}, {app_bound[1]}), plain both passes "
        f"{min(plain_ms):.4f} ms; no single PyTorch call computes LAMB")
    worst = max(e[0] for e in errs.values())
    common = {"max_abs_err": worst, "plain_ms": min(plain_ms), "library_ms": None}
    return {
        "flat_lamb_moments": {**common, "ms": min(mom_ms),
                              "bound_ms": mom_bound[0], "bound_by": mom_bound[1]},
        "flat_lamb_apply": {**common, "ms": min(app_ms),
                            "bound_ms": app_bound[0], "bound_by": app_bound[1]},
    }


# -- phase 9 -----------------------------------------------------------------


def _pretrain_batch(b: int, s: int, p: int) -> dict:
    batch = next(iter(SyntheticBertLoader(
        b, s, BERT_CONFIGS["large"].vocab_size, p, steps=1)))
    batch = {k: v.copy() for k, v in batch.items()}
    batch["attention_mask"][-1, s // 2:] = 0  # one padded row
    return batch


def _train_one_step(model, dtype, batch, device):
    cfg = dataclasses.replace(BERT_CONFIGS["large"], hidden_dropout=0.0,
                              attention_dropout=0.0)
    task = BertPretrainTask(cfg, dtype, max_predictions=20)
    params = dict(model.named_parameters())
    tx = lamb(1e-3, weight_decay=0.01, moment_dtype=torch.float32,
              mask={n: p.ndim > 1 for n, p in params.items()})
    state = create_train_state(model, tx, SEED, params=params)
    step = make_train_step(task.loss_fn, tx)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    before = {n: p.detach().clone() for n, p in params.items()}
    state, metrics = step(state, t)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach() for n, p in params.items()},
            {n: (p.detach() - before[n]) for n, p in params.items()})


def phase_train_parity() -> None:
    # BERT-Large's width, 12 of its 24 layers (24 before PR 12)
    cfg = dataclasses.replace(BERT_CONFIGS["large"], hidden_dropout=0.0,
                              attention_dropout=0.0,
                              num_layers=FT_PARITY_LAYERS)
    t0 = time.perf_counter()
    init = BertPretrainTask(cfg, torch.float32).init(
        torch.Generator().manual_seed(SEED), device="cpu")
    batch = _pretrain_batch(2, TS, 20)
    gpu = copy.deepcopy(init).to(DEV)
    before = dict(_counts())
    m_gpu, g_gpu, d_gpu = _train_one_step(gpu, torch.float32, batch, DEV)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items()}
    n_layers = cfg.num_layers
    check(launched["flash_fwd"] == n_layers
          and launched["flash_bwd_dq"] == n_layers
          and launched["flash_bwd_dkv"] == n_layers,
          f"one step launched {launched}, want {n_layers} of each flash kernel")
    del gpu
    cpu = copy.deepcopy(init)
    m_cpu, g_cpu, d_cpu = _train_one_step(cpu, torch.float32, batch, "cpu")
    del cpu
    rel = {key: abs(m_gpu[key] - m_cpu[key]) / abs(m_cpu[key])
           for key in ("loss", "grad_norm")}
    upd = max(float(d.abs().max()) for d in d_cpu.values())
    p_err, p_worst = max((max_err(d_gpu[n], d_cpu[n]), n) for n in d_cpu)
    g_top = max(float(g.abs().max()) for g in g_cpu.values())
    g_rel = sorted(((max_err(g_gpu[n], g_cpu[n]) / g_top, n) for n in g_cpu),
                   reverse=True)
    del d_gpu, g_gpu

    gpu16 = BertForPreTraining(cfg, torch.bfloat16)  # bf16 compute, fp32 params
    gpu16.load_state_dict(init.state_dict())
    m16, g16, _ = _train_one_step(gpu16.to(DEV), torch.bfloat16, batch, DEV)
    del gpu16
    # in fp64: an fp32 dot product over 336M entries is not exact enough
    a = torch.cat([g16[n].cpu().double().flatten() for n in g_cpu])
    b = torch.cat([g_cpu[n].double().flatten() for n in g_cpu])
    cos = float(a @ b / (a.norm() * b.norm()))
    # the control of the gradient check: the bf16 step read the same way
    g16_rel = max((max_err(g16[n], g_cpu[n]) / g_top, n) for n in g_cpu)
    say("9 train parity", f"BERT-Large pretraining ({cfg.num_layers} layers) "
        f"b2 s{TS} fp32, one LAMB "
        f"step, card vs CPU: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f} "
        f"({rel['loss']:.2e}), grad_norm {m_gpu['grad_norm']:.6f} vs "
        f"{m_cpu['grad_norm']:.6f} ({rel['grad_norm']:.2e}), worst gradients "
        f"(max abs err over the largest gradient entry {g_top:.3e}): "
        + ", ".join(f"{n} {r:.2e}" for r, n in g_rel[:3])
        + f" (limit {TOL_STEP['grad']:.0e}); params max abs diff {p_err:.3e} in "
        f"{p_worst} (largest update {upd:.3e}); "
        f"bf16 card step: loss {m16['loss']:.6f}, gradient cosine vs fp32 CPU "
        f"{cos:.6f}, worst gradient {g16_rel[1]} {g16_rel[0]:.2e} of the "
        f"largest entry (the control); {time.perf_counter() - t0:.1f} s")
    for key in ("loss", "grad_norm"):
        check(rel[key] <= TOL_STEP[key], f"fp32 step {key}: card {m_gpu[key]} "
              f"vs CPU {m_cpu[key]} ({rel[key]:.2e})")
    check(g_rel[0][0] <= TOL_STEP["grad"],
          f"fp32 step gradients: {g_rel[0][1]} {g_rel[0][0]:.3e} of the "
          f"largest entry, card vs CPU")
    check(p_err <= TOL_STEP["update"] * upd,
          f"fp32 step params: card vs CPU {p_err:.3e}, largest update {upd:.3e}")
    check(math.isfinite(m16["loss"]) and cos >= MIN_COS_GRAD_BF16,
          f"bf16 step: loss {m16['loss']}, gradient cosine {cos:.5f}")


# -- phase 10 ----------------------------------------------------------------


def _raport_data(path: Path) -> list[dict]:
    """The ``data`` of every LOG record in a run's raport."""
    recs = [json.loads(line.split(" ", 1)[1])
            for line in path.read_text().splitlines()]
    return [r.get("data", {}) for r in recs if r.get("type") == "LOG"]


def _raport_losses_and_times(path: Path) -> tuple[list[float], list[float]]:
    data = [d for d in _raport_data(path) if "train.loss" in d]
    return [d["train.loss"] for d in data], [d["train.compute_time"] for d in data]


TREE_LOSSES: dict[str, list[float]] = {}  # phase 10's curves, for 27a


def phase_training() -> dict[str, int]:
    """``bert-pretrain`` through the CLI's runner on the card; returns the
    launches of the three runs (the training path)."""
    work = ROOT / "workspace" / "chip_smoke"
    eval_steps = 5  # the runner's val loader
    runs = [
        ("tree", 10, ["--batch-size", str(TB), "--seq-len", str(TS),
                      "--max-predictions", "20"]),
        ("flat", 10, ["--batch-size", str(TB), "--seq-len", str(TS),
                      "--max-predictions", "20", "--flat-lamb"]),
        ("phase2", 2, ["--batch-size", "8", "--phase2"]),
    ]
    total = dict.fromkeys(_counts(), 0)
    lines, curves = [], {}
    for name, steps, flags in runs:
        ws = work / name
        shutil.rmtree(ws, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # this training path starts here
        t0 = time.perf_counter()
        state, _ = cli(["bert-pretrain", "--bert-model", "large",
                        "--steps-per-epoch", str(steps), "--workspace", str(ws),
                        "--lr", PRETRAIN_LR, *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(state.step == steps, f"{name}: {state.step} steps, want {steps}")
        del state
        losses, times = _raport_losses_and_times(ws / "bert_pretrain_raport.json")
        shutil.rmtree(ws, ignore_errors=True)
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{name}: losses {losses}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
        curves[name] = losses
        TREE_LOSSES[name] = losses
        flat_steps = steps if name == "flat" else 0
        want = {**dict.fromkeys(launched, 0),
                "flash_fwd": LAYERS * (steps + eval_steps),
                "flash_bwd_dq": LAYERS * steps, "flash_bwd_dkv": LAYERS * steps,
                "flat_lamb_moments": flat_steps, "flat_lamb_apply": flat_steps}
        check(launched == want, f"{name}: launches {launched}, want {want}")
        for k, v in launched.items():
            total[k] += v
        step_ms = statistics.median(times[1:]) * 1e3
        lines.append(f"{name} {steps} steps: loss "
                     + " ".join(f"{x:.4f}" for x in losses)
                     + f", median step {step_ms:.1f} ms, peak "
                     f"device memory {peak_gb:.2f} GB, run {wall:.1f} s; per "
                     f"step K1 {launched['flash_fwd'] // (steps + eval_steps)}"
                     f" (and {LAYERS} per eval batch), K2 "
                     f"{launched['flash_bwd_dq'] // steps}+"
                     f"{launched['flash_bwd_dkv'] // steps}, K3 "
                     f"{(launched['flat_lamb_moments'] + launched['flat_lamb_apply']) // steps}")
    shutil.rmtree(work, ignore_errors=True)
    second = (curves["tree"][1], curves["flat"][1])
    check(abs(second[0] - second[1]) <= TOL_TREE_FLAT * abs(second[0]),
          f"second-step loss: tree {second[0]} vs flat {second[1]}")
    say("10 training", f"bert-pretrain BERT-Large bf16, dropout 0.1, lr "
        f"{PRETRAIN_LR}, through the CLI: " + "; ".join(lines)
        + f"; second-step loss tree vs flat {abs(second[0] - second[1]):.2e} "
        "apart (step time: the loop's host clock per step, median after the "
        "first)")
    return total


# -- phase 11 ----------------------------------------------------------------


def _dlrm_flat_idx(skew: str, b: int = DLRM_B) -> torch.Tensor:
    """The joint-table indices of one ``SyntheticDlrmLoader`` batch at the
    slice's shape (b x 26, flattened), int32 on the card."""
    batch = next(iter(SyntheticDlrmLoader(
        b, list(DLRM_CFG.categorical_cardinalities), steps=1, skew=skew)))
    flat_idx = batch["categorical"] + DLRM_CFG.offsets.astype(np.int32)[None, :]
    return torch.from_numpy(flat_idx.reshape(-1)).to(DEV)


def _gather_check(table, idx, what) -> int:
    """K4 against its plain version on the same inputs: rows from the table
    bitwise equal, NaN rows in the same places. Returns the NaN rows."""
    before = emb.launches
    got = emb.gather_rows(table, idx)
    torch.cuda.synchronize()
    check(emb.launches == before + 1, f"K4 not launched for {what}")
    want = emb.gather_rows_reference(table, idx)
    nan_rows = torch.isnan(want).any(1)
    check(got.dtype == table.dtype and got.shape == want.shape,
          f"K4 {what}: {got.dtype} {tuple(got.shape)}")
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"K4 {what}: NaN rows differ")
    check(torch.equal(got[~nan_rows], want[~nan_rows]),
          f"K4 {what}: rows differ, max abs err "
          f"{max_err(got[~nan_rows], want[~nan_rows]):.3e}")
    return int(nan_rows.sum())


def phase_gather() -> dict:
    """K4 at DLRM's shape (uniform and zipf indices, fp32 and bf16 tables)
    with times, and at the edges: a ragged N with negative and out-of-range
    indices, and D=32. A gather is a copy, so every case must be exact."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rows = DLRM_CFG.total_rows
    table32 = torch.randn(rows, 128, generator=gen, device=DEV)
    tables = {torch.float32: table32, torch.bfloat16: table32.bfloat16()}
    timed, lines = {}, []
    for skew in ("uniform", "zipf"):
        idx = _dlrm_flat_idx(skew)
        n, uniq = idx.numel(), int(torch.unique(idx).numel())
        for dtype, table in tables.items():
            _gather_check(table, idx, f"{skew} {dtype}")

            def kernel():
                return emb.gather_rows(table, idx)

            def plain():
                return emb.gather_rows_reference(table, idx)

            def library():
                return torch.nn.functional.embedding(idx, table)

            plain_ms = [_event_ms(plain, 10)]
            kernel_ms = [_event_ms(kernel, 20), _event_ms(kernel, 20)]
            plain_ms.append(_event_ms(plain, 10))
            library_ms = _event_ms(library, 20)
            row_bytes = 128 * table.element_size()
            # distinct rows read, every row written, every index read
            bound_ms, bound_by = _bound(uniq * row_bytes + n * row_bytes + n * 4,
                                        0, dtype)
            timed[(skew, dtype)] = {
                "ms": min(kernel_ms), "plain_ms": min(plain_ms),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
            lines.append(
                f"{skew} {'f32' if dtype == torch.float32 else 'bf16'} "
                f"({uniq} distinct rows of {n}): kernel {min(kernel_ms):.4f} ms, "
                f"plain {min(plain_ms):.4f} ms, embedding() {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), "
                f"{(uniq + n) * row_bytes / min(kernel_ms) / 1e6:.0f} GB/s")
    del tables, table32
    # the edges: a ragged N over the joint table with indices in [-V-999,
    # V+999) (wraps and NaN rows) and the int32 extremes; then D=32
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    edge_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for v, d, n in ((rows, 128, 1_000_003), (DLRM_CARD, 32, DLRM_B * 26 + 5)):
            table = torch.randn(v, d, generator=g, device=DEV).to(dtype)
            idx = torch.randint(-v - 999, v + 999, (n,), generator=g,
                                device=DEV, dtype=torch.int32)
            idx[:4] = torch.tensor([-2**31, 2**31 - 1, -v, v - 1],
                                   dtype=torch.int32)
            what = f"{'f32' if dtype == torch.float32 else 'bf16'} v{v} d{d} n{n}"
            edge_rows[what] = _gather_check(table, idx, what)
            check(edge_rows[what] > 2, f"K4 {what}: too few NaN rows")
    say("11 kernel", "gather_rows vs plain, bitwise equal at every case "
        "(max abs err 0, NaN rows in the same places); at DLRM's shape, 2.6M "
        "x 128 table, " + "; ".join(lines) + "; edges (NaN rows): "
        + ", ".join(f"{k} {v}" for k, v in edge_rows.items())
        + " (CUDA events)")
    return {"max_abs_err": 0.0, **timed[("uniform", torch.float32)]}


# -- phase 12 ----------------------------------------------------------------


def _dlrm_batch(b: int) -> dict:
    return next(iter(SyntheticDlrmLoader(
        b, list(DLRM_CFG.categorical_cardinalities), steps=1)))


def _dlrm_step(model, batch, device):
    """One dual-SGD step at configs.yml's lr in the model's compute dtype:
    (loss, grads, param deltas)."""
    task = DlrmTask(DLRM_CFG, model.dtype)
    tx = make_dlrm_optimizer(mlp_lr=float(DLRM_LR), embedding_lr=float(DLRM_LR))
    params = dict(model.named_parameters())
    state = create_train_state(model, tx, SEED, params=params)
    step = make_train_step(task.loss_fn, tx)
    before = {n: p.detach().clone() for n, p in params.items()}
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    _, metrics = step(state, t)
    return (float(metrics["loss"]),
            {n: p.grad.detach() for n, p in params.items()},
            {n: p.detach() - before[n] for n, p in params.items()})


def _embedding_repeats() -> str:
    """The embedding backward twice on one full-width batch (B=65,536 x 26
    lookups into the 2.6M x 128 fp32 table, uniform and zipf ids), in both
    modes: the two gradients must be equal bit for bit."""
    g = torch.Generator(device=DEV).manual_seed(SEED)
    table = torch.randn(DLRM_CFG.total_rows, 128, generator=g,
                        device=DEV).requires_grad_()
    cot = torch.randn(DLRM_B * DLRM_TABLES, 128, generator=g, device=DEV)
    out = []
    for skew in ("uniform", "zipf"):
        idx = _dlrm_flat_idx(skew)
        for mode in ("scatter", "sorted"):
            grads, ms = [], []
            for _ in range(2):
                table.grad = None
                t0 = time.perf_counter()
                emb.embedding_lookup(table, idx, grad=mode).backward(cot)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                grads.append(table.grad)
            check(torch.equal(grads[0], grads[1]),
                  f"embedding backward {mode} {skew}: two runs differ by "
                  f"{max_err(grads[0], grads[1]):.3e}")
            out.append(f"{mode} {skew} equal ({min(ms):.2f} ms)")
    return ", ".join(out)


def phase_dlrm_parity() -> None:
    t0 = time.perf_counter()
    repeats = _embedding_repeats()
    init = DlrmTask(DLRM_CFG, torch.float32).init(
        torch.Generator().manual_seed(SEED), device="cpu")
    batch = _dlrm_batch(4096)
    before = emb.launches
    l_gpu, g_gpu, d_gpu = _dlrm_step(copy.deepcopy(init).to(DEV), batch, DEV)
    torch.cuda.synchronize()
    check(emb.launches == before + 1,
          f"one step launched K4 {emb.launches - before} times, want 1")
    g_gpu = {n: g.cpu() for n, g in g_gpu.items()}
    d_gpu = {n: d.cpu() for n, d in d_gpu.items()}
    l_cpu, g_cpu, d_cpu = _dlrm_step(copy.deepcopy(init), batch, "cpu")
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    g_rel = sorted(((max_err(g_gpu[n], g_cpu[n])
                     / float(g_cpu[n].abs().max()), n) for n in g_cpu),
                   reverse=True)
    d_rel = sorted(((max_err(d_gpu[n], d_cpu[n])
                     / max(float(d_cpu[n].abs().max()), 1e-30), n)
                    for n in d_cpu), reverse=True)
    del g_gpu, d_gpu, d_cpu
    gpu16 = Dlrm(DLRM_CFG, torch.bfloat16)  # bf16 compute, fp32 params
    gpu16.load_state_dict(init.state_dict())
    l16, g16, _ = _dlrm_step(gpu16.to(DEV), batch, DEV)
    del gpu16
    g16 = {n: g.cpu() for n, g in g16.items()}
    del init
    a = torch.cat([g16[n].double().flatten() for n in g_cpu])
    b = torch.cat([g_cpu[n].double().flatten() for n in g_cpu])
    cos = float(a @ b / (a.norm() * b.norm()))
    g16_rel = max((max_err(g16[n], g_cpu[n]) / float(g_cpu[n].abs().max()), n)
                  for n in g_cpu)
    say("12 DLRM parity", f"full-width DLRM (26 x {DLRM_CARD} x 128) b4096 "
        f"fp32, one dual-SGD step at lr {DLRM_LR}, card vs CPU: loss "
        f"{l_gpu:.7f} vs {l_cpu:.7f} ({rel_loss:.2e}); worst gradients (max "
        "abs err over the tensor's largest entry): "
        + ", ".join(f"{n} {r:.2e}" for r, n in g_rel[:3])
        + f" (limit {TOL_DLRM['grad']:.0e}); worst updates: "
        + ", ".join(f"{n} {r:.2e}" for r, n in d_rel[:2])
        + f"; bf16 card step: loss {l16:.6f}, gradient cosine vs fp32 CPU "
        f"{cos:.6f}, worst gradient {g16_rel[1]} {g16_rel[0]:.2e} (the "
        f"control); embedding backward twice, bit for bit: {repeats}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(rel_loss <= TOL_DLRM["loss"], f"fp32 DLRM loss: card {l_gpu} vs "
          f"CPU {l_cpu}")
    check(g_rel[0][0] <= TOL_DLRM["grad"],
          f"fp32 DLRM gradients: {g_rel[0][1]} {g_rel[0][0]:.3e}")
    check(d_rel[0][0] <= TOL_DLRM["update"],
          f"fp32 DLRM updates: {d_rel[0][1]} {d_rel[0][0]:.3e}")
    check(math.isfinite(l16) and cos >= MIN_COS_GRAD_BF16,
          f"bf16 DLRM step: loss {l16}, gradient cosine {cos:.5f}")


# -- phase 13 ----------------------------------------------------------------


def phase_dlrm_training() -> int:
    """``dlrm`` through the CLI's runner on the card, at configs.yml's lr 24
    and at the CLI's default lr 0.1; returns K4's launches on these runs.

    At lr 24 without the reference's warmup the loss diverges within a few
    steps, in the JAX package as in the port (PERF.md, open questions): that
    run's curve is recorded, and only its first loss must be finite. The run
    at lr 0.1 must keep every loss finite and end below where it began."""
    work = ROOT / "workspace" / "chip_smoke"
    steps, eval_steps = 20, 5  # the runner's val loader
    total, lines = 0, []
    for lr in (DLRM_LR, DLRM_LR_STABLE):
        ws = work / f"dlrm_lr{lr}"
        shutil.rmtree(ws, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # the DLRM training path starts here
        t0 = time.perf_counter()
        state, best = cli(["dlrm", "--batch-size", str(DLRM_B), "--lr", lr,
                           "--steps-per-epoch", str(steps), "--workspace",
                           str(ws)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(state.step == steps, f"dlrm lr {lr}: {state.step} steps")
        del state
        raport = ws / "dlrm_raport.json"
        losses, times = _raport_losses_and_times(raport)
        val = [d for d in _raport_data(raport) if "val.auc" in d]
        shutil.rmtree(ws, ignore_errors=True)
        check(len(losses) == steps and math.isfinite(losses[0]),
              f"dlrm lr {lr}: losses {losses}")
        if lr == DLRM_LR_STABLE:
            check(all(math.isfinite(x) for x in losses)
                  and losses[-1] < losses[0], f"dlrm lr {lr}: losses {losses}")
        check(len(val) == 1 and 0.0 <= val[0]["val.auc"] <= 1.0
              and val[0]["val.auc"] == best, f"dlrm lr {lr}: eval {val}")
        want = {**dict.fromkeys(launched, 0), "gather_rows": steps + eval_steps}
        check(launched == want, f"dlrm lr {lr}: launches {launched}, want {want}")
        total += launched["gather_rows"]
        lines.append(
            f"lr {lr}: loss " + " ".join(f"{x:.4f}" for x in losses)
            + f"; val.auc {val[0]['val.auc']:.6f}, val.val_loss "
            f"{val[0]['val.val_loss']:.6f}; median step "
            f"{statistics.median(times[1:]) * 1e3:.2f} ms; peak device memory "
            f"{peak_gb:.2f} GB; run {wall:.1f} s; K4 launches "
            f"{launched['gather_rows']} = {steps} steps + {eval_steps} eval "
            "batches")
    shutil.rmtree(work, ignore_errors=True)
    say("13 DLRM training", f"dlrm 26 x {DLRM_CARD} x 128 bf16, B={DLRM_B}, "
        "dual SGD through the CLI, 20 steps then 5 eval batches (seed 1): "
        + "; ".join(lines) + " (step time: the loop's host clock per step, "
        "median after the first)")
    return total


# -- phase 14 ----------------------------------------------------------------

# BERT-Large's FFN GEMMs at the serving shape B=8 S=384: (M, K, N)
FFN = ((B * S, 1024, 4096), (B * S, 4096, 1024))
# int8_matmul against the fp32 product, relative Frobenius error: the JAX
# test's limit (tests/test_quantization.py). The inputs are uniform in
# [-1, 1): per-tensor int8 spends its 255 steps on the absmax, and normal
# inputs of 3M entries put it at 5 standard deviations, where stochastic
# rounding alone costs about 1.8% (printed, not checked)
TOL_INT8 = 0.02


def _int8_case(m, k, n, gen):
    x = torch.rand(m, k, generator=gen, device=DEV) * 2 - 1
    w = torch.randn(k, n, generator=gen, device=DEV) * 0.02  # BERT's init std
    w_q, w_s = quant.quantize_per_channel(w, axis=1)
    return x, w, w_q, w_s[0][None, :]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_quantize() -> tuple[dict, int]:
    """K5 against its plain version bit for bit over 16 seeds, with the
    statistics of stochastic rounding; then ``int8_matmul`` at the FFN
    shapes (the int8 path, counts set to 0 just before it); then times.
    Returns K5's results and its launches on that path."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    cases = {f"{m}x{k}": _int8_case(m, k, n, gen) for m, k, n in FFN}
    first = next(iter(cases.values()))
    xs = {f"f32 {key}": c[0] for key, c in cases.items()}
    bf16_name = f"bf16 {next(iter(cases))}"
    xs[bf16_name] = first[0].bfloat16()
    stats, at_step = [], 0
    for name, x in xs.items():
        x64 = x.double()
        acc = torch.zeros_like(x64)
        for seed in range(16):
            before = quant.launches
            q, scale = quant.quantize_activations(x, seed)
            torch.cuda.synchronize()
            check(quant.launches == before + 1, f"K5 not launched for {name}")
            want_q, want_s = quant.quantize_activations_reference(x, seed)
            check(torch.equal(scale, want_s), f"K5 {name} seed {seed}: scale")
            check(torch.equal(q, want_q), f"K5 {name} seed {seed}: "
                  f"{int((q != want_q).sum())} of {q.numel()} differ from plain")
            deq = q.double() * float(scale)
            dist = (deq - x64).abs()
            worst = float(dist.max())
            # within one step, but for fp32's rounding: where y = x / scale
            # rounds away from x and y + u rounds up to the next integer, q
            # lands one step and up to an ulp of y (<= 2^-17 of a step) away
            check(worst <= float(scale) * (1 + 2**-16), f"K5 {name} seed "
                  f"{seed}: |q s - x| {worst:.6e} > scale {float(scale):.6e}")
            at_step += int((dist >= float(scale)).sum())
            if seed == 0:
                single = float((deq - x64).abs().mean())
            acc += deq
        mean_err = float((acc / 16 - x64).abs().mean())
        check(mean_err < single, f"K5 {name}: 16-seed mean {mean_err:.3e} not "
              f"closer than one draw {single:.3e}")
        stats.append(f"{name} {mean_err / single:.3f}")
        del acc, x64

    # the int8 path: int8_matmul at both FFN GEMMs, fp32 and bf16 inputs
    calls = [(f"f32 {key}", c[0], c[2], c[3], c[1]) for key, c in cases.items()]
    calls.append((bf16_name, xs[bf16_name], first[2], first[3], first[1]))
    _reset_counts()
    outs = [quant.int8_matmul(x, w_q, w_s, seed=7) for _, x, w_q, w_s, _ in calls]
    torch.cuda.synchronize()
    launched = _counts()
    check(launched == {**dict.fromkeys(launched, 0),
                       "quantize_activations": len(calls)},
          f"int8_matmul launches {launched}")
    errs = []
    for (name, x, w_q, w_s, w), out in zip(calls, outs):
        check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
              f"int8_matmul {name}: {out.dtype}, finite "
              f"{bool(torch.isfinite(out).all())}")
        rel = _rel(out, x.float() @ w)
        check(rel < TOL_INT8, f"int8_matmul {name}: relative error {rel:.4f}")
        errs.append(f"{name} {rel:.4f}")
    del outs
    xn = torch.randn(first[0].shape, generator=gen, device=DEV)
    normal_rel = _rel(quant.int8_matmul(xn, first[2], first[3], seed=7),
                      xn @ first[1])

    # times: K5 alone (the scale given), its plain version, then the GEMMs
    times = {}
    for name, x in xs.items():
        scale = quant._scale(x)
        u_plain = lambda x=x, scale=scale: quant.stochastic_round(  # noqa: E731
            x, scale, quant.philox_uniform(0, x.numel(), DEV).view(x.shape))
        kernel = lambda x=x, scale=scale: quant._quantize_cuda(x, scale, 0)  # noqa: E731
        plain_ms = [_event_ms(u_plain, 10)]
        # a launch takes longer on the host than K5 on the card
        kernel_ms = [_device_ms(kernel), _device_ms(kernel)]
        plain_ms.append(_event_ms(u_plain, 10))
        n = x.numel()
        # x read once, q written once, the scale; divide, add, floor and the
        # clip on the fp32 pipe (Philox's integer work has no peak in the
        # table and is not counted)
        bound = _bound(n * x.element_size() + n + 4, 5 * n, torch.float32)
        times[name] = {"ms": min(kernel_ms), "plain_ms": min(plain_ms),
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": None}
    gemm = []
    for (name, x, w_q, w_s, w) in calls[:2]:
        q, _ = quant.quantize_activations(x, 0)
        x16, w16 = x.bfloat16(), w.bfloat16()
        w_cm = w_q.t().contiguous().t()  # the same (K, N), column-major
        whole = _event_ms(lambda: quant.int8_matmul(x, w_q, w_s, seed=0))
        int_mm = _event_ms(lambda: torch._int_mm(q, w_q))
        int_mm_cm = _event_ms(lambda: torch._int_mm(q, w_cm))
        bf16 = _event_ms(lambda: x16 @ w16)
        m, k = x.shape
        gemm.append(f"{name} @ {k}x{w.shape[1]}: int8_matmul {whole:.4f} ms, "
                    f"_int_mm alone {int_mm:.4f} ms (column-major w "
                    f"{int_mm_cm:.4f} ms), bf16 matmul {bf16:.4f} ms "
                    f"(int8 bound {2 * m * k * w.shape[1] / 1979e12 * 1e3:.4f} "
                    "ms at 1,979 TOP/s)")
    say("14 int8", "quantize_activations (K5) vs plain, bitwise equal in 16 "
        "seeds at " + ", ".join(xs) + "; 16-seed mean error over one draw's: "
        + ", ".join(stats) + f"; every |q scale - x| within a step (and fp32's "
        f"rounding), {at_step} of {16 * sum(x.numel() for x in xs.values())} "
        "draws at one step or more; "
        "int8_matmul vs "
        "fp32 relative error (uniform inputs): " + ", ".join(errs)
        + f" (limit {TOL_INT8}); normal inputs {normal_rel:.4f} (not checked); "
        + "; ".join(f"K5 {k}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                    f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
                    for k, t in times.items())
        + "; " + "; ".join(gemm) + " (CUDA events; K5's queued behind a "
        "sleep on the card)")
    return {"max_abs_err": 0.0, **times[calls[1][0]]}, \
        launched["quantize_activations"]


# -- phase 15 ----------------------------------------------------------------

# fused_lamb's 10 bf16 steps against flat_lamb's (fp32 moments both) on the
# same batches and dropout, relative to each loss. The first loss comes
# before any update and must agree to the sums' order. After it the two
# differ by the order of their norm sums (8K against 64K blocks), the clip
# norm (over tensors against over the buffer) and new = p + (new - p)
# against new written: ulps of fp32, which bf16 compute turns into other
# roundings and LAMB's early u = m / sqrt(v) into sign flips of near-zero
# gradients. A missing trust ratio or a wrong scale moves the loss by whole
# units at this rate.
TOL_FUSED_FIRST = 1e-5
TOL_FUSED_EARLY = 1e-3  # steps 1-3, before the gaps compound
TOL_FUSED_FLAT = 1e-2


def _bert_large(dtype, dropout: bool):
    cfg = BERT_CONFIGS["large"]
    if not dropout:
        cfg = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    model = BertForPreTraining(cfg, dtype).to(DEV)
    init_bert_weights_(model, torch.Generator(device=DEV).manual_seed(SEED),
                       cfg.initializer_range)
    return cfg, model


def _fused_tx(params, lr):
    return fused.fused_lamb(lr, weight_decay=0.01,
                            mask={n: p.ndim > 1 for n, p in params.items()},
                            order=bert_pretrain_jax_order(LAYERS))


def phase_fused_lamb() -> tuple[dict, dict]:
    """``fused_lamb`` on full-width BERT-Large through make_train_step.
    Returns K3-at-8K's results and the launches of the 10-step bf16 run
    (the fused LAMB's path, counts set to 0 just before it)."""
    t0 = time.perf_counter()
    lr = float(PRETRAIN_LR)
    # one fp32 step, K3 at 8K against the plain pair on the same gradients
    cfg, model = _bert_large(torch.float32, dropout=False)
    task = BertPretrainTask(cfg, torch.float32, max_predictions=20)
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    tx = _fused_tx(params, lr)
    state = create_train_state(model, tx, SEED, params=params)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in _pretrain_batch(8, TS, 20).items()}
    before = _counts()
    state, metrics = make_train_step(task.loss_fn, tx)(state, batch)
    torch.cuda.synchronize()
    one = {k: v - before[k] for k, v in _counts().items()}
    check(one["flat_lamb_moments"] == one["flat_lamb_apply"] == 1,
          f"one fused_lamb step launched K3 {one}")
    grads = {n: p.grad for n, p in params.items()}
    tx_plain = _fused_tx(p0, lr)
    with mock.patch.object(fused, "_passes", fused.passes_plain):  # on the card
        upd, _ = tx_plain.update(grads, tx_plain.init(p0), p0)
    torch.cuda.synchronize()
    err = max(max_err(params[n].detach(), p0[n] + upd[n]) for n in params)
    top = max(float(p.abs().max()) for p in p0.values())
    moved = max(max_err(params[n].detach(), p0[n]) for n in params)
    check(math.isfinite(float(metrics["loss"])) and moved > 0,
          f"fp32 fused_lamb step: loss {float(metrics['loss'])}, moved {moved}")
    check(err <= TOL_LAMB[torch.float32] * top,
          f"K3 at 8K vs the plain pair: p err {err:.3e}, largest {top:.3e}")
    del model, params, p0, tx, state, grads, upd, tx_plain, batch

    # 10 bf16 steps (dropout 0.1) through make_train_step: fused_lamb, then
    # flat_lamb with fp32 moments, on the same batch and dropout draws
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in _pretrain_batch(TB, TS, 20).items()}
    curves, upd_ms, launched = {}, {}, {}
    for name in ("fused", "flat"):
        cfg, model = _bert_large(torch.bfloat16, dropout=True)
        task = BertPretrainTask(cfg, torch.bfloat16, max_predictions=20)
        params = dict(model.named_parameters())
        if name == "fused":
            tx, opt_params = _fused_tx(params, lr), params
        else:
            check(flat.default_wd_mask(list(params))
                  == {n: p.ndim > 1 for n, p in params.items()},
                  "flat_lamb's decay mask is not fused_lamb's p.ndim > 1")
            tx, opt_params, _ = flat.flatten_train(
                model, lr=lr, weight_decay=0.01, moment_dtype=torch.float32,
                order=bert_pretrain_jax_order(LAYERS))
        state = create_train_state(model, tx, SEED, params=opt_params)
        step = make_train_step(task.loss_fn, tx)
        losses = []
        if name == "fused":
            _reset_counts()  # the fused LAMB's path starts here
        for _ in range(10):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        if name == "fused":
            launched = _counts()
            want = {**dict.fromkeys(launched, 0), "flash_fwd": 10 * LAYERS,
                    "flash_bwd_dq": 10 * LAYERS, "flash_bwd_dkv": 10 * LAYERS,
                    "flat_lamb_moments": 10, "flat_lamb_apply": 10}
            check(launched == want, f"fused_lamb 10 steps: launches {launched}, "
                  f"want {want}")
        curves[name] = losses
        grads = state.params.grad if name == "flat" else \
            {n: p.grad for n, p in params.items()}
        upd_ms[name] = _event_ms(lambda: tx.update(grads, state.opt_state,
                                                   state.params), 5)
        if name == "fused":  # its parts, and the tree LAMB on the same grads
            lay = fused.make_layout(params, bert_pretrain_jax_order(LAYERS))
            buf = fused.pack(lay, params)
            upd_ms["pack"] = _event_ms(lambda: fused.pack(lay, grads), 5)
            upd_ms["clip"] = _event_ms(lambda: flat.step_hyp(
                0.9, 0.999, 1e-6, 1, list(grads.values()), 1.0), 5)
            upd_ms["deltas"] = _event_ms(lambda: {
                n: t - params[n] for n, t in fused.unpack(lay, buf, params).items()}, 5)
            del buf
            tree = lamb(lr, weight_decay=0.01, moment_dtype=torch.float32,
                        mask={n: p.ndim > 1 for n, p in params.items()})
            tree_state = tree.init(params)
            upd_ms["tree"] = _event_ms(lambda: tree.update(grads, tree_state,
                                                           params), 5)
            del tree, tree_state
        del model, params, opt_params, tx, state, step, grads
    fu, fl = curves["fused"], curves["flat"]
    rel = [abs(a - b) / abs(b) for a, b in zip(fu, fl)]
    check(all(math.isfinite(x) for x in fu + fl), f"losses {fu} {fl}")
    check(rel[0] <= TOL_FUSED_FIRST, f"first loss fused {fu[0]} vs flat {fl[0]}")
    check(max(rel[:3]) <= TOL_FUSED_EARLY, f"fused vs flat, steps 1-3: {fu} vs {fl}")
    check(max(rel) <= TOL_FUSED_FLAT, f"fused vs flat losses: {fu} vs {fl}")

    # K3 at 8K on the fused layout of BERT-Large: each pass, and the plain pair
    with torch.device("meta"):
        shapes = dict(BertForPreTraining(BERT_CONFIGS["large"]).named_parameters())
    layout = fused.make_layout(shapes, bert_pretrain_jax_order(LAYERS))
    rows = layout.total // flat.LANES
    g = torch.Generator(device=DEV).manual_seed(SEED)
    p = torch.randn(rows, flat.LANES, generator=g, device=DEV) * 0.02
    gr = torch.randn(rows, flat.LANES, generator=g, device=DEV) * 1e-3
    m = torch.randn(rows, flat.LANES, generator=g, device=DEV) * 1e-4
    v = torch.rand(rows, flat.LANES, generator=g, device=DEV) * 1e-7
    seg = torch.as_tensor(layout.seg_ids, dtype=torch.int32, device=DEV)
    wd = torch.full((layout.n_leaves,), 0.01, device=DEV)
    hyp = torch.tensor([0.9, 0.999, 1e-6, 0.1, 0.001, 0.5], device=DEV)
    scale_leaf = torch.full((layout.n_leaves,), 1e-3, device=DEV)
    index = torch.as_tensor(flat.leaf_index(layout), device=DEV)

    def moments():
        flat.flat_lamb_moments(gr, p, m, v, seg, wd, hyp, fused.BLOCK)

    def apply():
        flat.flat_lamb_apply(p, m, v, seg, wd, hyp, scale_leaf, fused.BLOCK)

    def plain():
        fused.passes_plain(gr, p, m, v, seg, wd, hyp, 1e-3, index)

    plain_ms = [_event_ms(plain, 5)]
    mom_ms = [_event_ms(moments, 10), _event_ms(moments, 10)]
    app_ms = [_event_ms(apply, 10), _event_ms(apply, 10)]
    plain_ms.append(_event_ms(plain, 5))
    n, nb = layout.total, len(layout.seg_ids)
    # pass 1 reads g, p, m, v and writes m, v (fp32) and the partials; pass 2
    # reads p, m, v and writes p; about 20 and 10 fp32 operations an element
    mom_bound = _bound(n * 24 + nb * 8 + nb * 4, 20 * n, torch.float32)
    app_bound = _bound(n * 16 + nb * 4, 10 * n, torch.float32)
    del p, gr, m, v
    say("15 fused LAMB", f"fused_lamb on BERT-Large ({n} elements in "
        f"{nb} blocks of 8 x 1024, {layout.n_leaves} tensors, fp32 moments, "
        "weight decay where p.ndim > 1): one fp32 step at B=8, K3 at 8K vs "
        f"JAX's plain pair on the same gradients, max abs err {err:.2e} "
        f"(largest parameter {top:.3e}, limit {TOL_LAMB[torch.float32]:.0e} "
        "of it); 10 bf16 steps at B=64 S=128 lr " + PRETRAIN_LR + ", loss "
        "fused " + " ".join(f"{x:.4f}" for x in fu) + ", flat "
        + " ".join(f"{x:.4f}" for x in fl) + f" (worst {max(rel):.2e} "
        f"relative, limit {TOL_FUSED_FLAT:.0e}; steps 1-3 {max(rel[:3]):.1e}, "
        f"limit {TOL_FUSED_EARLY:.0e}; first {rel[0]:.1e}); K3 "
        f"launches per step {launched['flat_lamb_moments'] // 10}+"
        f"{launched['flat_lamb_apply'] // 10}; update alone (CUDA events): "
        f"fused {upd_ms['fused']:.2f} ms (of which packing one buffer "
        f"{upd_ms['pack']:.2f}, the clip norm and constants "
        f"{upd_ms['clip']:.2f}, unpacking the deltas {upd_ms['deltas']:.2f}), "
        f"flat {upd_ms['flat']:.2f} ms, tree {upd_ms['tree']:.2f} ms (fp32 "
        "moments all); K3 at 8K: moments "
        f"pass {min(mom_ms):.4f} ms (bound {mom_bound[0]:.4f}, {mom_bound[1]})"
        f", apply pass {min(app_ms):.4f} ms (bound {app_bound[0]:.4f}, "
        f"{app_bound[1]}), plain pair {min(plain_ms):.4f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    common = {"max_abs_err": err, "plain_ms": min(plain_ms), "library_ms": None}
    return {
        "flat_lamb_moments_8k": {**common, "ms": min(mom_ms),
                                 "bound_ms": mom_bound[0],
                                 "bound_by": mom_bound[1]},
        "flat_lamb_apply_8k": {**common, "ms": min(app_ms),
                               "bound_ms": app_bound[0],
                               "bound_by": app_bound[1]},
    }, launched


# -- phase 16 ----------------------------------------------------------------

K_HOT = 256  # hot rows per table, the probe's


def phase_hot_gather() -> tuple[dict, int]:
    """K6 at the probe's shape against its plain version, bitwise, with a
    hot buffer unlike the table's head (so a row read from the wrong source
    shows); the hot-gather path (counts set to 0 just before it) on uniform
    and zipf ids; times beside K4 and embedding() on the same ids."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    table = torch.randn(DLRM_CFG.total_rows, 128, generator=gen, device=DEV)
    hot = torch.randn(DLRM_TABLES * K_HOT, 128, generator=gen, device=DEV) + 100
    rng = np.random.default_rng(SEED)
    ids = {skew: torch.from_numpy(flat_ids(rng, skew, DLRM_B, DLRM_TABLES,
                                           DLRM_CARD)).to(DEV)
           for skew in ("uniform", "zipf")}
    _reset_counts()  # the hot-gather path starts here
    outs = {skew: emb.hot_gather(table, hot, i, DLRM_CARD, K_HOT)
            for skew, i in ids.items()}
    torch.cuda.synchronize()
    launched = _counts()
    check(launched == {**dict.fromkeys(launched, 0), "hot_gather": 2},
          f"hot_gather launches {launched}")
    timed, lines = {}, []
    for skew, i in ids.items():
        want = emb.hot_gather_reference(table, hot, i, DLRM_CARD, K_HOT)
        check(torch.equal(outs[skew], want),
              f"K6 {skew}: max abs err {max_err(outs[skew], want):.3e}")
        is_hot = (i % DLRM_CARD) < K_HOT
        check(bool((want[is_hot] > 50).all()) and bool((want[~is_hot] < 50).all()),
              f"K6 {skew}: a row came from the wrong source")
        cover = float(is_hot.float().mean())
        n, uniq = i.numel(), int(torch.unique(i).numel())

        def kernel():
            return emb.hot_gather(table, hot, i, DLRM_CARD, K_HOT)

        def plain():
            return emb.hot_gather_reference(table, hot, i, DLRM_CARD, K_HOT)

        plain_ms = [_event_ms(plain, 10)]
        kernel_ms = [_event_ms(kernel, 20), _event_ms(kernel, 20)]
        plain_ms.append(_event_ms(plain, 10))
        k4_ms = _event_ms(lambda: emb.gather_rows(table, i), 20)
        library_ms = _event_ms(lambda: torch.nn.functional.embedding(i, table), 20)
        # distinct rows read (cold from the table, hot from the hot buffer),
        # every row written, every id read
        bound = _bound(uniq * 512 + n * 512 + n * 4, 0, torch.float32)
        timed[skew] = {"ms": min(kernel_ms), "plain_ms": min(plain_ms),
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": library_ms}
        lines.append(f"{skew} (hot coverage {cover:.4f}, {uniq} distinct "
                     f"rows of {n}): kernel {min(kernel_ms):.4f} ms, plain "
                     f"{min(plain_ms):.4f} ms, K4 gather_rows {k4_ms:.4f} ms, "
                     f"embedding() {library_ms:.4f} ms, bound {bound[0]:.4f} ms"
                     f" ({bound[1]})")
    say("16 hot gather", f"hot_gather (K6) vs plain at the probe's shape "
        f"({DLRM_TABLES} x {DLRM_CARD} x 128 fp32, {K_HOT} hot rows a table "
        "in a separate buffer), bitwise equal, every hot row from the hot "
        "buffer; " + "; ".join(lines) + " (CUDA events)")
    return {"max_abs_err": 0.0, **timed["zipf"]}, launched["hot_gather"]


# -- phase 17 ----------------------------------------------------------------

# SQuAD fine-tuning at bench.py's bert_squad_finetune shape (B=32, S=384) and
# configs.yml's rate (the CLI's own default is CommonConfig's 0.1)
FT_B, FT_LR = 32, "3e-5"
FT_PARITY_LAYERS = 12  # phase 9's and phase 17's fp32 steps
# GLUE's and SWAG's CLI defaults: BERT-Base, B=32, S=128, SWAG's 4 choices
# folded into the batch (B=128), and the JAX runners' fallback rate
GLUE_B, GLUE_S, GLUE_LR = 32, 128, "2e-5"
# AdamW's step on the card against the CPU's on the same gradients: the
# foreach ops round each entry of the update once or twice in another order
# (TOL_ADAMW of the largest update), and an update an ulp apart can round
# p + u to the next fp32 value (an ulp of p + u)
TOL_ADAMW = 1e-5
EPS32 = torch.finfo(torch.float32).eps


def _adamw_first_update(init, grads) -> dict[str, torch.Tensor]:
    """The CPU's first ``adamw`` step (as ``_squad_step`` builds it) on
    ``grads``, as the change ``(p + u) - p`` that the step makes to each
    fp32 weight of ``init``."""
    params = {n: p.detach().clone() for n, p in init.named_parameters()}
    tx = _bert_finetune_tx("adamw", float(FT_LR), 10, params)
    upd, _ = tx.update({n: g.cpu() for n, g in grads.items()},
                       tx.init(params), params)
    return {n: (p + upd[n]) - p for n, p in params.items()}


def _squad_train_batch(b: int, s: int) -> dict[str, np.ndarray]:
    """Padded questions (``_qa_batch``) with start and end positions inside
    each row's length."""
    rng = np.random.default_rng(SEED)
    batch = _qa_batch(rng, b, s)
    lengths = batch["attention_mask"].sum(1)
    start = rng.integers(0, lengths)
    batch["start_positions"] = start.astype(np.int32)
    batch["end_positions"] = np.minimum(start + rng.integers(0, 8, b),
                                        lengths - 1).astype(np.int32)
    return batch


def _squad_step(model, dtype, batch, device, optimizer):
    """One fine-tuning step through ``make_train_step`` under the CLI's
    ``optimizer`` (lr 3e-5, 10 steps in the schedule): the metrics, each
    gradient (the pooler's is 0: the span loss does not reach it), each
    update and the first moments."""
    task = BertSquadTask(model.cfg, dtype)
    params = dict(model.named_parameters())
    tx = _bert_finetune_tx(optimizer, float(FT_LR), 10, params)
    state = create_train_state(model, tx, SEED, params=params)
    step = make_train_step(task.loss_fn, tx)
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    before = {n: p.detach().clone() for n, p in params.items()}
    state, metrics = step(state, t)
    return ({k: float(v) for k, v in metrics.items()},
            {n: torch.zeros_like(p) if p.grad is None else p.grad.detach()
             for n, p in params.items()},
            {n: p.detach() - before[n] for n, p in params.items()},
            state.opt_state.mu)


def phase_finetune_parity() -> float:
    """K1 and K2 at the fine-tuning shapes against their plain versions, then
    one fp32 SQuAD step of full-width BERT-Large, card against CPU, under
    each optimizer, and the same step in bf16 as the control. Returns the
    worst K1/K2 errors here (out, dq/dk/dv)."""
    t0 = time.perf_counter()
    cases = [  # bf16 with dropout, as the fine-tuning runs call them
        dict(b=FT_B, s=S, h=H, d=D, dtype=torch.bfloat16, layout="bshd",
             rate=0.1, seed=-2468013),
        dict(b=GLUE_B, s=GLUE_S, h=12, d=64, dtype=torch.bfloat16,
             layout="bshd", rate=0.1, seed=97531),
        dict(b=4 * GLUE_B, s=GLUE_S, h=12, d=64, dtype=torch.bfloat16,
             layout="bshd", rate=0.1, seed=-13579),
    ]
    for c in cases:
        _fwd_bwd_case(c)
    kernels = "; ".join(
        f"b{c['b']} s{c['s']} h{c['h']}: out {c['err'][1]:.2e}, lse "
        f"{c['err'][2]:.2e}, dq/dk/dv {c['err'][0]:.2e} ({c['rel']:.2e} of "
        "the largest entry)" for c in cases)

    # BERT-Large's width, 12 of its 24 layers (24 before PR 12)
    cfg = dataclasses.replace(BERT_CONFIGS["large"], hidden_dropout=0.0,
                              attention_dropout=0.0,
                              num_layers=FT_PARITY_LAYERS)
    init = BertForQuestionAnswering(cfg, torch.float32)
    init_bert_weights_(init, torch.Generator().manual_seed(SEED),
                       cfg.initializer_range)
    batch = _squad_train_batch(2, S)
    lines = []
    for optimizer in ("bert_adam", "adamw"):
        gpu = copy.deepcopy(init).to(DEV)
        before = dict(_counts())
        m_gpu, g_gpu, d_gpu, mu_gpu = _squad_step(gpu, torch.float32, batch,
                                                  DEV, optimizer)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts().items()}
        check(launched["flash_fwd"] == cfg.num_layers
              and launched["flash_bwd_dq"] == cfg.num_layers
              and launched["flash_bwd_dkv"] == cfg.num_layers,
              f"one SQuAD step launched {launched}, want {cfg.num_layers} of "
              "each flash kernel")
        del gpu
        m_cpu, g_cpu, d_cpu, mu_cpu = _squad_step(
            copy.deepcopy(init), torch.float32, batch, "cpu", optimizer)
        rel = {key: abs(m_gpu[key] - m_cpu[key]) / abs(m_cpu[key])
               for key in ("loss", "grad_norm")}
        g_top = max(float(g.abs().max()) for g in g_cpu.values())
        g_rel = max((max_err(g_gpu[n], g_cpu[n]) / g_top, n) for n in g_cpu)
        for key in ("loss", "grad_norm"):
            check(rel[key] <= TOL_STEP[key], f"{optimizer} fp32 step {key}: "
                  f"card {m_gpu[key]} vs CPU {m_cpu[key]} ({rel[key]:.2e})")
        check(g_rel[0] <= TOL_STEP["grad"], f"{optimizer} fp32 step "
              f"gradients: {g_rel[1]} {g_rel[0]:.3e} of the largest entry")
        if optimizer == "bert_adam":
            # warmup_linear's first update is exactly 0; the moments carry
            # the per-tensor clipped gradients
            moved = max(float(d.abs().max()) for d in (*d_gpu.values(),
                                                        *d_cpu.values()))
            check(moved == 0.0, f"bert_adam's first update moved {moved}")
            mu_top = max(float(m.abs().max()) for m in mu_cpu.values())
            mu_rel = max((max_err(mu_gpu[n], mu_cpu[n]) / mu_top, n)
                         for n in mu_cpu)
            check(mu_rel[0] <= TOL_STEP["grad"], f"bert_adam first moments: "
                  f"{mu_rel[1]} {mu_rel[0]:.3e} of the largest entry")
            state_line = (f"update 0 on both (warmup_linear at count 0), "
                          f"first moments worst {mu_rel[1]} {mu_rel[0]:.2e} "
                          "of the largest entry")
        else:
            # AdamW's first update is about lr * g / |g| per entry, so an
            # entry whose gradient is near its rounding noise may step the
            # other way on the CPU: the update is held against the CPU's
            # update from the card's own gradients
            d_ref = _adamw_first_update(init, g_gpu)
            upd = max(float(d.abs().max()) for d in d_ref.values())
            weights = dict(init.named_parameters())
            # past the allowance: TOL_ADAMW of the largest update, plus one
            # ulp of p + u (at most EPS32 * (|p| + |u|))
            over = max((float(((d_gpu[n].cpu() - d_ref[n]).abs()
                               - TOL_ADAMW * upd
                               - EPS32 * (weights[n].detach().abs() + upd)
                               ).max()), n)
                       for n in d_ref)
            p_err, p_worst = max((max_err(d_gpu[n], d_ref[n]), n) for n in d_ref)
            check(over[0] <= 0.0, f"adamw fp32 step updates: {over[1]} "
                  f"{over[0]:.3e} past the allowance (largest update "
                  f"{upd:.3e})")
            flips = max((max_err(d_gpu[n], d_cpu[n]), n) for n in d_cpu)
            state_line = (f"updates vs the CPU's from the card's gradients "
                          f"worst {p_worst} {p_err:.2e} (largest update "
                          f"{upd:.3e}, each entry within {TOL_ADAMW:.0e} of "
                          f"it plus an ulp of p + u); vs the CPU's own "
                          f"step {flips[1]} {flips[0]:.2e} (entries whose "
                          "gradient is near its noise)")
        del d_gpu, mu_gpu, d_cpu, mu_cpu
        lines.append(
            f"{optimizer}: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f} "
            f"({rel['loss']:.2e}), grad_norm {m_gpu['grad_norm']:.6f} vs "
            f"{m_cpu['grad_norm']:.6f} ({rel['grad_norm']:.2e}), worst "
            f"gradient {g_rel[1]} {g_rel[0]:.2e} of the largest entry "
            f"{g_top:.3e} (limit {TOL_STEP['grad']:.0e}), {state_line}")
        del g_gpu

    gpu16 = BertForQuestionAnswering(cfg, torch.bfloat16)  # fp32 weights
    gpu16.load_state_dict(init.state_dict())
    m16, g16, _, _ = _squad_step(gpu16.to(DEV), torch.bfloat16, batch, DEV,
                                 "adamw")
    del gpu16
    a = torch.cat([g16[n].cpu().double().flatten() for n in g_cpu])
    b = torch.cat([g_cpu[n].double().flatten() for n in g_cpu])
    cos = float(a @ b / (a.norm() * b.norm()))
    g16_rel = max((max_err(g16[n], g_cpu[n]) / g_top, n) for n in g_cpu)
    check(math.isfinite(m16["loss"]) and cos >= MIN_COS_GRAD_BF16,
          f"bf16 SQuAD step: loss {m16['loss']}, gradient cosine {cos:.5f}")
    say("17 finetune parity", f"K1/K2 vs plain at the fine-tuning shapes "
        f"(bshd, bf16, masked, dropout 0.1), max abs err: {kernels}; "
        f"BERT-Large SQuAD ({cfg.num_layers} layers) b2 s{S} fp32, one step, "
        f"card vs CPU: "
        + "; ".join(lines) + f"; bf16 card step (adamw): loss "
        f"{m16['loss']:.6f}, gradient cosine vs fp32 CPU {cos:.6f}, worst "
        f"gradient {g16_rel[1]} {g16_rel[0]:.2e} of the largest entry (the "
        f"control); {time.perf_counter() - t0:.1f} s")
    return (max(c["err"][1] for c in cases), max(c["err"][0] for c in cases))


# -- phase 18 ----------------------------------------------------------------


def _squad_files(tmp: Path) -> tuple[dict[str, str], int]:
    """phase 6's three questions as a dev file, the first two as a train
    file, and a vocabulary of their words; returns the paths and the dev
    features' count at S=384."""
    para = SQUAD["data"][0]["paragraphs"][0]
    words = sorted({w for text in [para["context"]]
                    + [qa["question"] for qa in para["qas"]]
                    for w in BertTokenizer({}).basic.tokenize(text)})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (tmp / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (tmp / "dev.json").write_text(json.dumps(SQUAD))
    train = copy.deepcopy(SQUAD)
    train["data"][0]["paragraphs"][0]["qas"] = para["qas"][:2]
    (tmp / "train.json").write_text(json.dumps(train))
    dev = convert_examples_to_features(
        read_squad_examples(str(tmp / "dev.json"), is_training=False),
        BertTokenizer(str(tmp / "vocab.txt")), max_seq_length=S,
        doc_stride=128, is_training=False)
    return {k: str(tmp / f"{k}.{e}") for k, e in
            (("vocab", "txt"), ("dev", "json"), ("train", "json"))}, len(dev)


def phase_finetune() -> dict[str, int]:
    """``bert-squad``, ``bert-glue`` and ``bert-swag`` through the CLI's
    runners on the card; returns the launches of the five runs (the
    fine-tuning path, counts set to 0 just before each)."""
    work = ROOT / "workspace" / "chip_smoke_finetune"
    total = dict.fromkeys(_counts(), 0)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        files, n_dev = _squad_files(Path(tmp))
        base = BERT_CONFIGS["base"].num_layers
        large = ["--bert-model", "large", "--lr", FT_LR]
        synthetic = [*large, "--batch-size", str(FT_B), "--steps-per-epoch", "10"]
        # (label, command, steps, layers, eval batches, flags, metric keys)
        runs = [
            ("squad adamw", "bert-squad", 10, LAYERS, 0,
             [*synthetic, "--optimizer", "adamw"], ()),
            ("squad bert_adam", "bert-squad", 10, LAYERS, 0,
             [*synthetic, "--optimizer", "bert_adam"], ()),
            ("squad files", "bert-squad", 2, LAYERS, n_dev,
             [*large, "--batch-size", "1", "--train-file", files["train"],
              "--predict-file", files["dev"], "--vocab-file", files["vocab"]],
             ("val.exact_match", "val.f1")),
            ("glue", "bert-glue", 5, base, 1,
             ["--lr", GLUE_LR, "--steps-per-epoch", "5"], ("dev.accuracy",)),
            ("swag", "bert-swag", 5, base, 1,
             ["--lr", GLUE_LR, "--steps-per-epoch", "5"], ("val.accuracy",)),
        ]
        for label, command, steps, layers, evals, flags, keys in runs:
            ws = work / label.replace(" ", "_")
            shutil.rmtree(ws, ignore_errors=True)
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()  # this fine-tuning path starts here
            t0 = time.perf_counter()
            state, _ = cli([command, "--workspace", str(ws), *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = _counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            check(state.step == steps, f"{label}: {state.step} steps, want {steps}")
            del state
            data = _raport_data(ws / f"{command.replace('-', '_')}_raport.json")
            shutil.rmtree(ws, ignore_errors=True)
            losses = [d["train.loss"] for d in data if "train.loss" in d]
            times = [d["train.compute_time"] for d in data if "train.loss" in d]
            check(len(losses) == steps and all(math.isfinite(x) for x in losses),
                  f"{label}: losses {losses}")
            want = {**dict.fromkeys(launched, 0),
                    "flash_fwd": layers * (steps + evals),
                    "flash_bwd_dq": layers * steps,
                    "flash_bwd_dkv": layers * steps}
            check(launched == want, f"{label}: launches {launched}, want {want}")
            metrics = {k: next(d[k] for d in data if k in d) for k in keys}
            for k, v in metrics.items():
                top = 100.0 if "squad" in label else 1.0
                check(math.isfinite(v) and 0.0 <= v <= top, f"{label}: {k} {v}")
            for k, v in launched.items():
                total[k] += v
            step_ms = statistics.median(times[1:]) * 1e3
            lines.append(
                f"{label} {steps} steps: loss "
                + " ".join(f"{x:.4f}" for x in losses)
                + "".join(f", {k} {v:.4f}" for k, v in metrics.items())
                + f", median step {step_ms:.1f} ms, peak device memory "
                f"{peak_gb:.2f} GB, run {wall:.1f} s; K1 {launched['flash_fwd']}"
                f" ({evals} eval batches), K2 {launched['flash_bwd_dq']}+"
                f"{launched['flash_bwd_dkv']}")
    shutil.rmtree(work, ignore_errors=True)
    say("18 finetune", f"bert-squad BERT-Large B={FT_B} S={S} bf16 lr {FT_LR} "
        f"and bert-glue / bert-swag at their defaults (BERT-Base, B={GLUE_B}, "
        f"S={GLUE_S}, lr {GLUE_LR}), dropout 0.1, through the CLI: "
        + "; ".join(lines) + " (step time: the loop's host clock per step, "
        "median after the first)")
    return total


# -- phase 19 ----------------------------------------------------------------

CN_B, CN_EFF_B = 8, 2  # EfficientNet-B0 at B=4 before PR 12
# bench.py's ResNet-50 recipe (bench.py:72-94), the CLI's flags for it
CN_LR, CN_MOM, CN_WD, CN_LS = 0.256, 0.875, 3.0517578125e-05, 0.1
CN_FLAGS = ["--lr", str(CN_LR), "--momentum", str(CN_MOM), "--weight-decay",
            str(CN_WD), "--label-smoothing", str(CN_LS)]
# One fp32 ConvNets step on the card (TF32 off, cuDNN's algorithms fixed)
# against the same step on the CPU in float64: the loss to 1e-5 relative;
# each BN running statistic after the step to 1e-4 of its own largest entry;
# each gradient and SGD update to a limit of its own largest entry (or of
# FLOOR times the largest entry of all, where that is more: EfficientNet's
# shift-invariant proj.bn biases are 0 but for rounding) and to another of
# the largest entry of all, fixed per step below. The training-mode
# ResNet-50 step is badly conditioned: its gradient through the batch
# statistics subtracts two means from dy that nearly cancel it, stage after
# stage, and fp32 loses up to 2e-2 of a tensor's largest entry there and
# 1.4e-3 of the largest entry of all, on the card (2.06e-2, 1.38e-3) and on
# the CPU alike (3.11e-2, 1.49e-3), where the bf16 step (the control, which
# must miss) reads 4.43e-1 and 2.22e-1 (NVIDIA H100 80GB HBM3, PERF.md). Its
# limits lie between the two; the same step with BN on its running
# statistics (2.97e-4, 2.93e-5) is held to 1e-3 and 1e-4, and
# EfficientNet-B0's steps (4.41e-5, 3.24e-6 in training mode) to 1e-4.
FLOOR = 1e-3
TOL_CONV = {"loss": 1e-5, "stats": 1e-4,
            # (of each tensor's largest entry, of the largest entry of all)
            "resnet50": (1e-1, 1e-2), "resnet50 eval": (1e-3, 1e-4),
            "efficientnet-b0": (1e-4, 1e-4),
            "efficientnet-b0 eval": (1e-4, 1e-4),
            # GPUNet-0 (phase 26d): ResNet-50's limits
            "gpunet-0": (1e-1, 1e-2), "gpunet-0 eval": (1e-3, 1e-4)}
# QAT forward of ResNet-50, card against CPU. Each QATConv runs on the card
# on the CPU model's own input to it: the int8 grid of that input and of the
# kernel entry by entry (a value on a rounding edge may land one step apart:
# at most this share of entries), and the layer's output to 1e-4 of its
# largest entry, where a plain convolution of the same input (the control)
# must miss. The logits, where the layers' small differences add up, to
# TOL_QAT_LOGITS of the largest (2.01e-3 on the H100; the plain model's 8.56e-3
# must miss).
TOL_QAT_EDGES = 1e-4
TOL_QAT_LAYER = 1e-4
TOL_QAT_LOGITS = 5e-3


def _convnet(arch: str, dtype, quantized: bool = False, exact: bool = False):
    """A full-width model on the CPU from SEED with every BN scale and bias
    redrawn, so that each branch carries gradient: scales 1 + 0.2 N(0, 1),
    but 0.1 N(0, 1) on each residual branch's last BN, which JAX starts at 0
    (a state early in training; with those scales near 1 too, the fp32
    forward itself drifts further from float64 at each stage). ``exact``: an
    EfficientNet without stochastic depth and dropout."""
    if exact and arch in EFFNET_ARCHS:
        model = EfficientNet(dataclasses.replace(
            EFFNET_ARCHS[arch], survival_prob=1.0, dropout=0.0), 1000, dtype,
            quantized=quantized)
    else:
        model = build_model(arch, 1000, dtype, quantized)
    gen = torch.Generator().manual_seed(SEED)
    model.init_weights_(gen)
    _redraw_bn(model, gen)
    return model


@torch.no_grad()
def _redraw_bn(model, gen: torch.Generator) -> None:
    """Every BN scale 1 + 0.2 N(0, 1), but 0.1 N(0, 1) on each residual
    branch's last BN (JAX starts it at 0); every BN bias 0.1 N(0, 1)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            z = torch.randn(m.weight.shape, generator=gen)
            m.weight.copy_(0.1 * z if m.zero_init else 1.0 + 0.2 * z)
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))


def _float64(model, dtype=torch.float64):
    """The model computing in float64, or ``dtype``, parameters and all (its
    layers' compute dtype too: a ``dtype``, or a ``compute_dtype`` that is
    set)."""
    model = model.to(dtype)
    for m in model.modules():
        for attr in ("dtype", "compute_dtype"):
            if getattr(m, attr, None) is not None:
                setattr(m, attr, dtype)
    return model


def _convnet_batch(b: int, size: int) -> dict:
    return next(iter(SyntheticImageLoader(b, size, 1000, steps=1)))


def _convnet_step(model, batch, device):
    """One SGD step (bench.py's recipe) in the model's compute dtype and
    mode (eval: BN on its running statistics), the images in the
    parameters' dtype: (loss, grads, param deltas, BN buffers after), on
    the CPU."""
    task = ClassificationTask("resnet50", model.dtype, label_smoothing=CN_LS)
    params = dict(model.named_parameters())
    tx = sgd(CN_LR, CN_MOM, CN_WD, mask=no_decay_mask(params))
    state = create_train_state(model, tx, SEED, params=params,
                               model_state=task.model_state(model))
    step = make_train_step(task.loss_fn, tx)
    before = {n: p.detach().clone() for n, p in params.items()}
    t = {"image": torch.from_numpy(batch["image"]).to(
        device, next(model.parameters()).dtype),
         "label": torch.from_numpy(batch["label"]).to(device)}
    _, metrics = step(state, t)
    return (float(metrics["loss"]),
            {n: p.grad.detach().cpu() for n, p in params.items()},
            {n: (p.detach() - before[n]).cpu() for n, p in params.items()},
            {n: b.detach().cpu() for n, b in model.named_buffers()})


def _worst(got: dict, want: dict) -> tuple[tuple, tuple]:
    """The worst (error, name) over each tensor's largest entry (or FLOOR
    times the largest of all, where that is more) and over the largest
    entry of all."""
    top = max(float(w.abs().max()) for w in want.values())
    errs = {n: float((got[n].double() - want[n].double()).abs().max())
            for n in want}
    return (max((e / max(float(want[n].abs().max()), FLOOR * top), n)
                for n, e in errs.items()),
            max((e / top, n) for n, e in errs.items()))


def _fmt(worst: tuple[tuple, tuple]) -> str:
    (r, n), (q, m) = worst
    return f"{n} {r:.2e} of its own, {m} {q:.2e} of the largest of all"


def _within(worst: tuple[tuple, tuple], limits: tuple[float, float]) -> bool:
    return worst[0][0] <= limits[0] and worst[1][0] <= limits[1]


def _convnet_reference(arch: str, b: int, size: int):
    """19's weights and batch for one arch and its two float64 steps on the
    CPU (training mode, then BN on its running statistics), started on the
    host thread (``_HOST``) beside the card's work."""
    init = _convnet(arch, torch.float32, exact=True)
    batch = _convnet_batch(b, size)
    return init, batch, _HOST.submit(lambda: (
        _convnet_step(_float64(copy.deepcopy(init)), batch, "cpu"),
        _convnet_step(_float64(copy.deepcopy(init)).eval(), batch, "cpu")))


def _convnet_parity(arch: str, b: int, size: int,
                    phase: str = "19 ConvNets parity", ref=None) -> str:
    """One fp32 step of ``arch`` card vs CPU float64 (``ref``: its
    ``_convnet_reference``, started now if not given)."""
    init, batch, f64 = ref or _convnet_reference(arch, b, size)
    l_gpu, g_gpu, d_gpu, s_gpu = _convnet_step(copy.deepcopy(init).to(DEV),
                                               batch, DEV)
    # the same step with BN on its running statistics
    _, e_gpu, _, _ = _convnet_step(copy.deepcopy(init).to(DEV).eval(), batch,
                                   DEV)
    (l64, g64, d64, s64), (_, e64, _, _) = f64.result()
    g_rel, d_rel = _worst(g_gpu, g64), _worst(d_gpu, d64)
    st_rel = max((max_err(s_gpu[n], s64[n]) / max(
        float(s64[n].abs().max()), 1e-30), n) for n in s64)
    rel_loss = abs(l_gpu - l64) / abs(l64)
    e_rel = _worst(e_gpu, e64)
    lim, lim_eval = TOL_CONV[arch], TOL_CONV[f"{arch} eval"]
    rm = s_gpu[next(n for n in s_gpu if n.endswith("running_mean"))]
    rv = s_gpu[next(n for n in s_gpu if n.endswith("running_var"))]
    line = (f"{arch} b{b}, one step, card fp32 vs CPU float64: loss "
            f"{l_gpu:.7f} vs {l64:.7f} ({rel_loss:.2e}); worst gradients: "
            f"{_fmt(g_rel)} (limits {lim[0]:.0e}, {lim[1]:.0e}); with BN on its "
            f"running statistics: {_fmt(e_rel)} (limits {lim_eval[0]:.0e}, "
            f"{lim_eval[1]:.0e}); BN statistics worst {st_rel[1]} "
            f"{st_rel[0]:.2e} (the first BN: running mean in "
            f"[{float(rm.min()):.4f}, {float(rm.max()):.4f}], running var in "
            f"[{float(rv.min()):.4f}, {float(rv.max()):.4f}]); worst updates: "
            f"{_fmt(d_rel)}")
    if arch == "resnet50":  # the bf16 control, which must miss
        gpu16 = _convnet(arch, torch.bfloat16)
        gpu16.load_state_dict(init.state_dict())
        l16, g16, _, _ = _convnet_step(gpu16.to(DEV), batch, DEV)
        a = torch.cat([g16[n].double().flatten() for n in g64])
        c = torch.cat([g64[n].flatten() for n in g64])
        cos = float(a @ c / (a.norm() * c.norm()))
        w16 = _worst(g16, g64)
        check(math.isfinite(l16), f"bf16 {arch} step: loss {l16}")
        line += (f"; bf16 card step (the control): loss {l16:.6f}, gradient "
                 f"cosine vs float64 {cos:.6f}, worst gradients {_fmt(w16)}")
        check(w16[0][0] > lim[0] and w16[1][0] > lim[1],
              f"the bf16 control meets the fp32 limits: {w16}")
    say(phase, line)
    check(rel_loss <= TOL_CONV["loss"], f"{arch} fp32 loss: card {l_gpu} vs "
          f"CPU float64 {l64}")
    check(_within(g_rel, lim), f"{arch} fp32 gradients: {g_rel}")
    check(_within(d_rel, lim), f"{arch} fp32 updates: {d_rel}")
    check(st_rel[0] <= TOL_CONV["stats"], f"{arch} BN statistics: {st_rel}")
    check(_within(e_rel, lim_eval),
          f"{arch} fp32 gradients, BN on running statistics: {e_rel}")
    return line


def _qat_parity() -> str:
    """A QAT forward of full-width ResNet-50 (fp32, eval mode: BN on its
    running statistics) on the card against the CPU, layer by layer on the
    CPU's inputs (with a plain convolution as the control) and whole."""
    cpu = _convnet("resnet50", torch.float32, quantized=True).eval()
    gpu = copy.deepcopy(cpu).to(DEV)
    plain = _convnet("resnet50", torch.float32).eval()
    plain.load_state_dict(cpu.state_dict())
    plain = plain.to(DEV)
    x = torch.from_numpy(_convnet_batch(CN_B, 224)["image"]).permute(0, 3, 1, 2)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, a, out, n=n: seen.__setitem__(n, (a[0], out)))
        for n, m in cpu.named_modules() if isinstance(m, QATConv)]
    with torch.no_grad():
        want = cpu(x)
        for h in hooks:
            h.remove()
        got, got_plain = gpu(x.to(DEV)).cpu(), plain(x.to(DEV)).cpu()
        card, host = dict(gpu.named_modules()), dict(cpu.named_modules())
        k_diff = x_diff = x_all = 0
        layer, control = (0.0, ""), (math.inf, "")
        for n, (a, out) in seen.items():
            m, a_dev = card[n], a.to(DEV)
            k_diff += int((m.kernel().cpu() != host[n].kernel()).sum())
            x_diff += int((quant.fake_quantize_per_tensor(a_dev).cpu()
                           != quant.fake_quantize_per_tensor(a)).sum())
            x_all += a.numel()
            top = float(out.abs().max())
            layer = max(layer, (max_err(m(a_dev), out) / top, n))
            control = min(control, (max_err(torch.nn.functional.conv2d(
                a_dev, m.weight, None, m.stride, m.padding, 1, m.groups),
                out) / top, n))
    k_all = sum(m.weight.numel() for m in card.values()
                if isinstance(m, QATConv))
    top = float(want.abs().max())
    rel, rel_plain = max_err(got, want) / top, max_err(got_plain, want) / top
    line = (f"QAT resnet50 b{CN_B} fp32 eval forward, card vs CPU, "
            f"{len(seen)} QATConv layers each on the CPU's input to it: int8 "
            f"kernel entries that differ {k_diff} of {k_all}, input entries "
            f"{x_diff} of {x_all}; worst layer output {layer[1]} "
            f"{layer[0]:.2e} of its largest entry (limit {TOL_QAT_LAYER:.0e}; "
            f"a plain convolution, the control, at least {control[0]:.2e} "
            f"at {control[1]}); logits {rel:.2e} of the largest apart (limit "
            f"{TOL_QAT_LOGITS:.0e}; the plain model on the card, the control, "
            f"{rel_plain:.2e})")
    say("19 ConvNets parity", line)
    check(bool(torch.isfinite(got).all()) and k_diff <= TOL_QAT_EDGES * k_all
          and x_diff <= TOL_QAT_EDGES * x_all and layer[0] <= TOL_QAT_LAYER
          and control[0] > TOL_QAT_LAYER and rel <= TOL_QAT_LOGITS
          and rel_plain > TOL_QAT_LOGITS, f"QAT forward: {line}")
    return line


def _convnet_references() -> dict:
    """19's float64 references of ResNet-50 and EfficientNet-B0."""
    return {"resnet50": _convnet_reference("resnet50", CN_B, 224),
            "efficientnet-b0": _convnet_reference("efficientnet-b0", CN_EFF_B,
                                                  224)}


def phase_convnet_parity(refs: dict) -> None:
    """19 on ``_convnet_references``."""
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    try:
        lines = [_convnet_parity("resnet50", CN_B, 224,
                                 ref=refs["resnet50"]), _qat_parity(),
                 _convnet_parity("efficientnet-b0", CN_EFF_B, 224,
                                 ref=refs["efficientnet-b0"])]
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    say("19 ConvNets parity", f"TF32 off, SGD lr {CN_LR} momentum {CN_MOM} "
        f"weight decay {CN_WD}, label smoothing {CN_LS}: {len(lines)} "
        f"checks passed; {time.perf_counter() - t0:.1f} s")


# -- phase 20 ----------------------------------------------------------------

# Phases 19-22 run while nvcc builds the kernels (phase 2) and the float64
# references of 19 and 22 run on the host thread: the times they print are
# taken with the host under that load, and are not the card's unloaded ones
UNDER_LOAD = ("timed with the host under load (nvcc's build and the float64 "
              "references beside it)")

# (arch, batch size, steps, extra flags) through the CLI's runner
QAT = ["--quant-policy", "qat"]
CN_RUNS = [
    ("resnet50", 256, 20, []),
    ("resnet50", 256, 5, ["--mixup", "0.2"]),
    ("resnet50", 256, 5, QAT),
    ("resnext101-32x4d", 64, 5, []),
    ("resnext101-32x4d", 64, 5, QAT),
    ("se-resnext101-32x4d", 64, 5, []),
    ("se-resnext101-32x4d", 64, 5, QAT),
    # the EfficientNets' first runs are mostly cuDNN's autotuning of their
    # depthwise convolutions at the run's batch (about 48 s each at B=256
    # and B=32, PR 12 run 1); smaller batches keep every layer and flag
    ("efficientnet-b0", 64, 5, ["--ema", "0.9999"]),
    ("efficientnet-b0", 64, 5, QAT),
    ("efficientnet-b4", 8, 5, ["--ema", "0.9999"]),
    ("efficientnet-b4", 8, 5, QAT),
]
# NVIDIA's A100 80GB figures for the reference (bench.py BASELINES; another
# card): ResNet-50 training img/s at B=256, inference img/s at B=256, ms at
# B=1
A100 = {"train": 2470.0, "infer_bs256": 1261.0, "infer_bs1_ms": 10.37}


def _convnet_run(arch: str, b: int, steps: int, extra: list[str],
                 work: Path, loss0_tol: float = 0.5,
                 autotune: bool = False) -> tuple[str, float]:
    """One CLI run with the launch counts set to 0 just before it: every
    loss finite, the first within ``loss0_tol`` of ln 1000, eval's
    top1/top5/val_loss; K1-K6 launched 0 times. Returns its line and its
    median step (ms). Without ``autotune`` cuDNN takes its heuristics'
    algorithms (``cli_main.CUDNN_BENCHMARK`` off): these runs check
    correctness, and the autotuning cost about 50 s an EfficientNet and
    25-37 s a GPUNet on the H100)."""
    ws = work / f"{arch}_{len(extra)}"
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the ConvNets path starts here
    t0 = time.perf_counter()
    cli_main.CUDNN_BENCHMARK = autotune
    try:
        state, best = cli([arch, "--batch-size", str(b), "--steps-per-epoch",
                           str(steps), "--workspace", str(ws), *CN_FLAGS,
                           *extra])
    finally:
        cli_main.CUDNN_BENCHMARK = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(state.step == steps, f"{arch} {extra}: {state.step} steps")
    del state
    raport = ws / f"{arch}_raport.json"
    losses, times = _raport_losses_and_times(raport)
    val = [d for d in _raport_data(raport) if "val.top1" in d]
    shutil.rmtree(ws, ignore_errors=True)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(1000)) < loss0_tol,
          f"{arch} {extra}: losses {losses}")
    check(len(val) == 1 and all(math.isfinite(val[0][k]) for k in
                                ("val.top1", "val.top5", "val.val_loss"))
          and val[0]["val.top1"] == best, f"{arch} {extra}: eval {val}")
    check(launched == dict.fromkeys(launched, 0),
          f"{arch} {extra}: K1-K6 launched {launched} on the ConvNets path")
    median = statistics.median(times[1:]) * 1e3
    return (f"{arch} {' '.join(extra) or 'fp'} B={b}: loss "
            + " ".join(f"{x:.4f}" for x in losses)
            + f"; val top1 {val[0]['val.top1']:.4f} top5 "
            f"{val[0]['val.top5']:.4f} val_loss {val[0]['val.val_loss']:.4f}; "
            f"median step {median:.2f} ms ({b / median * 1e3:.1f} img/s); "
            f"peak device memory {peak_gb:.2f} GB; run {wall:.1f} s"), median


def _infer_times(model, b: int, iters: int,
                 size: int = 224) -> tuple[float, float]:
    """An image model's eval forward at batch ``b`` on ``size`` x ``size``
    images: ms per forward on CUDA events over ``iters`` back-to-back calls,
    and the median host clock of ``iters`` calls each ending in
    ``synchronize()``."""
    x = torch.randn(b, size, size, 3, device=DEV).permute(0, 3, 1, 2)
    with torch.inference_mode():
        ev = _event_ms(lambda: model(x), iters)
        host = []
        for _ in range(iters):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
    return ev, statistics.median(host)


def phase_convnets() -> dict[str, int]:
    """The five ConvNets commands through the CLI's runner on the card,
    then ResNet-50's bf16 eval forward at B=256 and B=1; returns the
    kernels' launches on these paths (all 0: no kernel of the port lies on
    them)."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke"
    lines, rn50 = [], None
    for i, (arch, b, steps, extra) in enumerate(CN_RUNS):
        # the first run's img/s is the synthetic reading 26b compares with:
        # it alone autotunes
        line, median = _convnet_run(arch, b, steps, extra, work,
                                    autotune=i == 0)
        lines.append(line)
        if arch == "resnet50" and not extra:
            rn50 = b / median * 1e3
            RN50_SYNTHETIC["img/s"] = rn50
    shutil.rmtree(work, ignore_errors=True)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        _reset_counts()
        model = ClassificationTask("resnet50", torch.bfloat16).init(
            torch.Generator().manual_seed(SEED), DEV).eval()
        with torch.inference_mode():
            pooled = model(torch.randn(2, 224, 224, 3, device=DEV).permute(
                0, 3, 1, 2), return_features=True)[-1]
        check(pooled.is_contiguous(memory_format=torch.channels_last)
              and pooled.dtype == torch.bfloat16,
              f"the pool's input: {pooled.dtype} {pooled.stride()}")
        ev256, host256 = _infer_times(model, 256, 20)
        ev1, host1 = _infer_times(model, 1, 50)
        check(_counts() == dict.fromkeys(_counts(), 0),
              f"inference launched {_counts()}")
        del model
    finally:
        torch.backends.cudnn.benchmark = benchmark
    say("20 ConvNets", f"through the CLI, bench.py's recipe (lr {CN_LR}, "
        f"momentum {CN_MOM}, weight decay {CN_WD}, label smoothing {CN_LS}, "
        "cosine), bf16, channels_last, then the 10-batch eval: "
        + "; ".join(lines)
        + f". On {card()}: resnet50 training {rn50:.1f} img/s at B="
        f"{CN_RUNS[0][1]} (the loop's median step, host clock); eval forward bf16 "
        f"B=256 {ev256:.3f} ms on CUDA events ({256 / ev256 * 1e3:.1f} "
        f"img/s), {host256:.3f} ms on the host clock; B=1 {ev1:.3f} ms on "
        f"CUDA events back to back, {host1:.3f} ms on the host clock per "
        f"call. NVIDIA's A100 80GB figures for the reference (another card): "
        f"{A100['train']:.0f} img/s training, {A100['infer_bs256']:.0f} img/s "
        f"at B=256, {A100['infer_bs1_ms']} ms at B=1; every time here "
        f"{UNDER_LOAD}. K1-K6 launched 0 times on these paths; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict.fromkeys(_counts(), 0)


# -- phase 21 ----------------------------------------------------------------

SSD_B, SSD_PARITY_B, SSD_STEPS, SSD_SIZE = 128, 4, 20, 300
# bench.py's SSD300 optimizer (bench.py:108: optax.sgd(2.6e-3,
# momentum=0.9)), the CLI's flags for it
SSD_FLAGS = ["--lr", "2.6e-3", "--momentum", "0.9", "--weight-decay", "0",
             "--lr-schedule", "constant"]
# fixed color-twist parameters for the parity step, inside the reference's
# ranges
SSD_TWIST = dict(hue_deg=[0.3, -0.4, 0.1, -0.2], saturation=[0.7, 1.3, 1.0, 0.5],
                 brightness=[0.9, 1.1, 1.0, 0.875],
                 contrast=[0.6, 1.4, 1.0, 1.5])
# One fp32 SSD300 step on the card against the CPU in float64 is held to
# phase 19's ResNet-50 limits (TOL_CONV["resnet50"]): the loss to 1e-5
# relative, the BN running statistics to 1e-4 of each tensor's largest entry,
# each gradient to 1e-1 of its own largest entry and 1e-2 of the largest of
# all; the bf16 step (the control) must miss them. predict_fn's boxes and
# probabilities on the card to 5e-5 of their largest entry from the CPU's
# in float64, where the bf16 model (the control) must miss: the card's fp32
# read 9.42e-6 and the CPU's 4.33e-6, and card fp32 against CPU fp32 read
# 1.02e-5 (NVIDIA H100 80GB HBM3, 700 W, PERF.md §6).
TOL_SSD_PREDICT = 5e-5
# NVIDIA's A100 figures for the reference (bench.py BASELINES; another
# card): SSD300 training img/s (AMP, B=64), inference img/s at B=1 (TF32)
A100_SSD = {"train": 662.91, "infer_bs1": 158.83}


def _ssd():
    """Full-width fp32 SSD300 (81 classes) on the CPU from SEED, its BN
    redrawn as phase 19's models."""
    gen = torch.Generator().manual_seed(SEED)
    model = SSD300(81, torch.float32)
    model.init_weights_(gen)
    _redraw_bn(model, gen)
    return model.train()


def _ssd_step(model, batch, device):
    """One SGD step (bench.py's optimizer) in the model's compute dtype:
    (loss, grads, BN buffers after), on the CPU."""
    task = SSDTask(dtype=model.dtype, color_jitter=False)
    params = dict(model.named_parameters())
    tx = sgd(2.6e-3, 0.9)
    state = create_train_state(model, tx, SEED, params=params,
                               model_state=task.model_state(model))
    dtype = next(model.parameters()).dtype
    t = {k: torch.from_numpy(v).to(device, dtype if v.dtype == np.float32
                                   else None)
         for k, v in batch.items()}
    _, metrics = make_train_step(task.loss_fn, tx)(state, t)
    return (float(metrics["loss"]),
            {n: p.grad.detach().cpu() for n, p in params.items()},
            {n: b.detach().cpu() for n, b in model.named_buffers()})


def phase_ssd_parity() -> None:
    """21 a-b: one fp32 SSD300 training step on the card against the CPU in
    float64, the bf16 control; the color twist on the card against the CPU; ``predict_fn`` card against
    the CPU in float64, then ``evaluate_ssd`` on the card over two batches
    with ground truth."""
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    try:
        init = _ssd()
        batch = next(iter(SyntheticSSDLoader(SSD_PARITY_B, dboxes300_coco(),
                                             steps=1)))
        twist = {k: torch.tensor(v) for k, v in SSD_TWIST.items()}
        x = torch.from_numpy(batch["image"])
        twisted = color_twist(x, **twist)
        twist_err = max_err(color_twist(x.to(DEV), **{
            k: v.to(DEV) for k, v in twist.items()}), twisted)
        batch["image"] = twisted.numpy()  # the same images on both devices
        l_gpu, g_gpu, s_gpu = _ssd_step(copy.deepcopy(init).to(DEV), batch, DEV)
        l64, g64, s64 = _ssd_step(_float64(copy.deepcopy(init)), batch, "cpu")
        gpu16 = SSD300(81, torch.bfloat16)
        gpu16.load_state_dict(init.state_dict())
        l16, g16, _ = _ssd_step(gpu16.train().to(DEV), batch, DEV)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    lim = TOL_CONV["resnet50"]
    g_rel, w16 = _worst(g_gpu, g64), _worst(g16, g64)
    st_rel = max((max_err(s_gpu[n], s64[n]) / max(
        float(s64[n].abs().max()), 1e-30), n) for n in s64)
    rel_loss = abs(l_gpu - l64) / abs(l64)
    say("21 SSD300", f"parity: ssd300 b{SSD_PARITY_B} (81 classes, 8732 "
        f"anchors, images twisted at fixed parameters: card vs CPU "
        f"{twist_err:.2e}), one fp32 step, card vs CPU float64: loss "
        f"{l_gpu:.7f} vs {l64:.7f} ({rel_loss:.2e}); worst gradients: "
        f"{_fmt(g_rel)} (limits {lim[0]:.0e}, {lim[1]:.0e}); BN statistics worst "
        f"{st_rel[1]} {st_rel[0]:.2e}; bf16 card step (the control): loss "
        f"{l16:.6f}, worst gradients {_fmt(w16)}")
    check(twist_err <= 1e-6, f"color twist, card vs CPU: {twist_err}")
    check(rel_loss <= TOL_CONV["loss"], f"ssd300 fp32 loss: card {l_gpu} vs "
          f"CPU float64 {l64}")
    check(_within(g_rel, lim), f"ssd300 fp32 gradients: {g_rel}")
    check(st_rel[0] <= TOL_CONV["stats"], f"ssd300 BN statistics: {st_rel}")
    check(math.isfinite(l16) and w16[0][0] > lim[0] and w16[1][0] > lim[1],
          f"the bf16 control meets the fp32 limits: {l16} {w16}")

    # b: predict_fn card vs CPU float64 (and the CPU's fp32 beside it),
    # then evaluate_ssd on the card
    task, cpu = SSDTask(), init
    gpu = copy.deepcopy(cpu).to(DEV)
    images = torch.from_numpy(batch["image"])
    want = task.predict_fn(_float64(copy.deepcopy(cpu)), None, images)

    def predict_err(model, x) -> tuple[float, ...]:
        """(boxes, probabilities), each's error over its largest entry."""
        return tuple(max_err(g, w) / float(w.abs().max())
                     for g, w in zip(task.predict_fn(model, None, x), want))

    gpu16 = SSD300(81, torch.bfloat16)
    gpu16.load_state_dict(cpu.state_dict())
    p_err, p_cpu = predict_err(gpu, images.to(DEV)), predict_err(cpu, images)
    p16 = predict_err(gpu16.train().to(DEV), images.to(DEV))
    del gpu16
    rng = np.random.default_rng(SEED)
    val = []
    for _ in range(2):
        gt = []
        for i in range(SSD_PARITY_B):
            lt = rng.uniform(0.0, 0.7, (6, 2))
            boxes_i = np.concatenate([lt, lt + rng.uniform(0.1, 0.3, (6, 2))],
                                     1).astype(np.float32)
            labels = rng.integers(1, 81, 6).astype(np.int32)
            check(bool((encode(task.dboxes, boxes_i, labels)[1] > 0).any()),
                  "encode matched no anchor")
            gt.append((i, boxes_i, labels))
        val.append({"image": rng.normal(size=(SSD_PARITY_B, SSD_SIZE, SSD_SIZE,
                                              3)).astype(np.float32),
                    "gt": gt})
    detections = [0]

    def counting_nms(*args, **kwargs):
        out = nms_single(*args, **kwargs)
        detections[0] += len(out[0])
        return out

    with mock.patch.object(ssd_evaluate, "nms_single", counting_nms):
        scores = ssd_evaluate.evaluate_ssd(task, gpu, val)
    check(gpu.training, "evaluate_ssd left the model in eval mode")
    fmt = lambda e: f"boxes {e[0]:.2e}, probabilities {e[1]:.2e}"  # noqa: E731
    say("21 SSD300", f"predict_fn vs CPU float64, of each output's largest "
        f"entry: card fp32 {fmt(p_err)} (limit {TOL_SSD_PREDICT:.0e}); the "
        f"CPU's fp32 {fmt(p_cpu)}; card bf16 (the control) {fmt(p16)}; "
        f"evaluate_ssd on the "
        f"card, 2 batches of {SSD_PARITY_B} with ground truth from encode's "
        f"boxes: mAP {scores['mAP']:.6f}, mAP50 {scores['mAP50']:.6f}, "
        f"{detections[0]} detections after NMS (random weights); "
        f"{time.perf_counter() - t0:.1f} s")
    check(max(p_err) <= TOL_SSD_PREDICT < min(p16),
          f"predict_fn card vs CPU float64: fp32 {p_err}, bf16 {p16}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()),
          f"evaluate_ssd: {scores}")


def phase_ssd() -> dict[str, int]:
    """21 c-d: ``ssd300`` through the CLI's runner at B=128 bf16 with
    bench.py's optimizer, then 2 steps with ``--resume``, then the bf16 eval
    forward at B=1 and B=128; returns the kernels' launches on these paths
    (all 0: no kernel of the port lies on them)."""
    t0 = time.perf_counter()
    ws = ROOT / "workspace" / "chip_smoke" / "ssd300"
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the SSD300 path starts here
    state, _ = cli(["ssd300", "--batch-size", str(SSD_B), "--steps-per-epoch",
                    str(SSD_STEPS), "--workspace", str(ws), *SSD_FLAGS])
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(state.step == SSD_STEPS, f"ssd300: {state.step} steps")
    del state
    losses, times = _raport_losses_and_times(ws / "ssd300_raport.json")
    check(len(losses) == SSD_STEPS and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"ssd300: losses {losses}")
    median = statistics.median(times[4:]) * 1e3  # steps 5-20
    # two more steps from the checkpoint at step 20, as a second epoch
    state, _ = cli(["ssd300", "--batch-size", str(SSD_B), "--steps-per-epoch",
                    str(SSD_STEPS), "--workspace", str(ws), "--resume",
                    "--epochs", "2", "--prof", "2", *SSD_FLAGS])
    resumed, _ = _raport_losses_and_times(ws / "ssd300_raport.json")
    check(state.step == SSD_STEPS + 2 and len(resumed) == 2
          and all(math.isfinite(x) for x in resumed),
          f"ssd300 --resume: step {state.step}, losses {resumed}")
    del state
    shutil.rmtree(ws, ignore_errors=True)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        model = SSDTask().init(torch.Generator().manual_seed(SEED), DEV).eval()
        ev128, host128 = _infer_times(model, SSD_B, 20, SSD_SIZE)
        ev1, host1 = _infer_times(model, 1, 50, SSD_SIZE)
        del model
    finally:
        torch.backends.cudnn.benchmark = benchmark
    launched = _counts()
    check(launched == dict.fromkeys(launched, 0),
          f"K1-K6 launched {launched} on the SSD300 path")
    say("21 SSD300", f"through the CLI, bench.py's optimizer (SGD lr 2.6e-3, "
        f"momentum 0.9, constant), bf16, B={SSD_B}, {SSD_STEPS} steps on one "
        f"repeated batch with the color twist: loss "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; median step over steps 5-{SSD_STEPS} {median:.2f} ms "
        f"({SSD_B / median * 1e3:.1f} img/s, host clock); peak device memory "
        f"{peak_gb:.2f} GB; --resume: step {SSD_STEPS + 2}, loss "
        + " ".join(f"{x:.4f}" for x in resumed)
        + f". On {card()}: eval forward bf16 B={SSD_B} {ev128:.3f} ms on CUDA "
        f"events ({SSD_B / ev128 * 1e3:.1f} img/s), {host128:.3f} ms on the "
        f"host clock; B=1 {ev1:.3f} ms on CUDA events back to back "
        f"({1e3 / ev1:.1f} img/s), {host1:.3f} ms on the host clock per call. "
        f"NVIDIA's A100 figures for the reference (another card): "
        f"{A100_SSD['train']} img/s training, {A100_SSD['infer_bs1']} img/s "
        f"at B=1; every time here {UNDER_LOAD}. K1-K6 launched 0 times on "
        f"these paths; {time.perf_counter() - t0:.1f} s")
    return launched


# -- phase 22 ----------------------------------------------------------------

# bench.py's shapes (bench.py:326-363): Tacotron2 B=128 (text 128, mel 600),
# WaveGlow B=10 (segment 8000), bf16, and their rates (the CLI's own default
# is CommonConfig's 0.1, ROADMAP quirk 8h)
T2_B, T2_STEPS, T2_LR = 128, 3, "1e-3"  # 10 steps before PR 12
WG_B, WG_STEPS, WG_LR = 10, 20, "1e-4"
# the fp32 parity steps: Tacotron2 at B=4, text length 64, mel length 96;
# WaveGlow at B=2, segment 8000
T2_PARITY, WG_PARITY_B = (4, 64, 48), 2  # mel 96 before PR 12
# 22b's WaveGlow at full width and 8 of its 12 flows (one early output, at
# flow 4, as at 12): its float64 step and infer on the host set phase 22's
# end, 40 s after the card's work (PR 18 run 8)
WG_PARITY_FLOWS = 8
# One fp32 step of each on the card (TF32 off) against the CPU in float64,
# every dropout at 0, under clip + Adam: the loss to 1e-5 relative, the BN
# running statistics to 1e-4 of each tensor's largest entry, each gradient
# to TOL_TTS of its own largest entry (or FLOOR times the largest of all,
# where that is more) and of the largest entry of all; the bf16 step (the
# control) must miss them. WaveGlow's infer at sigma 0 on the card to
# TOL_WG_INFER of its largest sample from the CPU's float64, where the bf16
# model (the control) must miss. The limits lie between the readings of an
# H100 run (fp32 step, of its own / of all: Tacotron2 2.3e-4 / 8.1e-7,
# WaveGlow 2.5e-6 / 2.0e-7; the bf16 control: 2.2 / 1.1e-2 and 1.3e-2 /
# 3.0e-3; infer at sigma 0: 1.1e-6, the bf16 control 1.2e-2).
TOL_TTS = {"tacotron2": (1e-2, 1e-4), "waveglow": (1e-3, 1e-4)}
TOL_WG_INFER = 1e-4
# The card's clip + Adam update (each parameter's delta and Adam's first
# moment) against the same update in float64 on the card's own gradients,
# for the fp32 and the bf16 step: of each tensor's largest entry (or FLOOR
# times the largest of all) and of the largest entry of all. Adam's first
# step is about -lr * sign(g) whatever the clip, so the deltas cannot show
# it: the moments (0.1 times the clipped gradient) do, and the same update
# with the clip's other branch (the control) must miss. Two devices' whole
# steps are not compared entry by entry: an entry whose gradient is
# rounding noise steps -lr or +lr. The limits lie between the readings of
# an H100 run (deltas 6.6e-5, the fp32 rounding of a parameter near 1;
# moments at most 1.9e-7; global norms 4.15 and 1.66, so the clip scaled
# both steps) and the control's (7.6e-1 and 4.0e-1).
TOL_TTS_UPDATE = (1e-3, 1e-3)
TTS_TEXTS = ["Printing, in the only sense with which we are at present "
             "concerned, differs from most if not from all the arts.",
             "The quick brown fox jumps over the lazy dog.",
             "Dr. Smith paid $3.50 for it in 1905."]
# NVIDIA's A100 figures for the reference (bench.py:47-48; another card, the
# reference's own widths): Tacotron2 frames/s and WaveGlow samples/s training
A100_TTS = {"tacotron2": 26484.0, "waveglow": 149479.0}


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, TtsDropout):
            m.p = 0.0
    return model


@torch.no_grad()
def _randomise_end(model, gen: torch.Generator):
    """Every WN ``end`` (zeros at init, which makes each coupling the
    identity) redrawn at 0.01 N(0, 1)."""
    for wn in model.WN:
        wn.end.weight.copy_(0.01 * torch.randn(wn.end.weight.shape,
                                               generator=gen))
        wn.end.bias.copy_(0.01 * torch.randn(wn.end.bias.shape, generator=gen))
    return model


def _tts_init(name: str):
    """Full-width fp32 Tacotron2 (BN redrawn as phase 19's models) or
    WaveGlow (every ``end`` randomised) on the CPU from SEED, every dropout
    at 0."""
    gen = torch.Generator().manual_seed(SEED)
    if name == "tacotron2":
        model = Tacotron2Task(dtype=torch.float32).init(gen, "cpu")
        _redraw_bn(model, gen)
    else:
        model = _randomise_end(WaveGlowTask(
            WaveGlowConfig(n_flows=WG_PARITY_FLOWS),
            dtype=torch.float32).init(gen, "cpu"),
                               gen)
    return _no_dropout(model)


def _tts_copy(model, dtype):
    """``model``'s weights in a new model computing in ``dtype``."""
    cls = type(model)
    out = _no_dropout(cls(model.cfg, dtype))
    out.load_state_dict(model.state_dict())
    return out.train()


def _tts_step(model, batch: dict, device) -> dict:
    """One clip + Adam step (JAX's run_tts optimizer at lr 1e-3) in the
    model's compute dtype and training mode, the float inputs in the
    parameters' dtype, on the CPU: the loss, the global norm of the
    gradients (above 1 the clip scales them), the gradients, the parameter
    deltas, Adam's first moments and the BN running statistics after."""
    task = (Tacotron2Task if isinstance(model, Tacotron2) else WaveGlowTask)(
        cfg=model.cfg, dtype=model.dtype)
    model = model.to(device)
    params = dict(model.named_parameters())
    tx = chain(clip_by_global_norm(1.0), adam(1e-3))
    state = create_train_state(model, tx, SEED, params=params,
                               model_state=task.model_state(model))
    before = {n: p.detach().clone() for n, p in params.items()}
    dtype = next(model.parameters()).dtype
    t = {k: torch.from_numpy(v).to(device, dtype if v.dtype == np.float32
                                   else None)
         for k, v in batch.items()}
    state, metrics = make_train_step(task.loss_fn, tx)(state, t)
    cpu = lambda d: {n: x.detach().cpu() for n, x in d.items()}  # noqa: E731
    return {"loss": float(metrics["loss"]),
            "norm": float(metrics["grad_norm"]),
            "grads": cpu({n: p.grad for n, p in params.items()}),
            "deltas": cpu({n: p.detach() - before[n]
                           for n, p in params.items()}),
            "mu": cpu(state.opt_state[-1].mu),
            "stats": cpu({n: b for n, b in model.named_buffers()
                          if ".running_" in n})}


def _update64(step: dict, other_branch: bool = False) -> tuple[dict, dict]:
    """The first update of optax's clip at 1 and Adam at lr 1e-3 on
    ``step``'s own gradients, written out in float64 on the CPU: (deltas,
    Adam's first moments). ``other_branch``: the clip takes the branch its
    norm does not call for (the control)."""
    g = {n: x.double() for n, x in step["grads"].items()}
    norm = math.sqrt(sum(float((x * x).sum()) for x in g.values()))
    scale = 1.0 / norm if (norm >= 1.0) != other_branch else 1.0
    # m_hat = g, sqrt(v_hat) = |g| at the first step
    return ({n: -1e-3 * x * scale / ((x * scale).abs() + 1e-8)
             for n, x in g.items()},
            {n: 0.1 * x * scale for n, x in g.items()})


def _tts_reference(name: str, batch: dict):
    """22 a-b's weights for one model and its float64 step on the CPU,
    started on the host thread (``_HOST``) beside the card's work."""
    init = _tts_init(name)
    return batch, init, _HOST.submit(_tts_step, _float64(copy.deepcopy(init)),
                                     batch, "cpu")


def _tts_parity(name: str, ref) -> tuple[str, dict]:
    """22 a-b: one fp32 step card vs CPU float64 (``ref``: the model's
    ``_tts_reference``), the bf16 card step the control."""
    batch, init, f64 = ref
    gpu = _tts_step(copy.deepcopy(init), batch, DEV)
    b16 = _tts_step(_tts_copy(init, torch.bfloat16), batch, DEV)
    f64 = f64.result()
    lim = TOL_TTS[name]
    g64 = f64["grads"]
    g_rel, w16 = (_worst(s["grads"], g64) for s in (gpu, b16))
    s_gpu, s64 = gpu["stats"], f64["stats"]
    st_rel = max(((max_err(s_gpu[n], s64[n]) / max(
        float(s64[n].abs().max()), 1e-30), n) for n in s64),
        default=(0.0, "none"))
    l_gpu, l64 = gpu["loss"], f64["loss"]
    rel_loss = abs(l_gpu - l64) / abs(l64)
    # the card's clip + Adam update against float64 on the card's own
    # gradients, for the fp32 and the bf16 step; the control takes the
    # clip's other branch
    upd = {}
    for what, s in (("fp32", gpu), ("bf16", b16)):
        d64, mu64 = _update64(s)
        upd[what] = (_worst(s["deltas"], d64), _worst(s["mu"], mu64))
    other = _worst(gpu["mu"], _update64(gpu, other_branch=True)[1])
    line = (f"{name}: one fp32 step, card vs CPU float64: loss {l_gpu:.7f} vs "
            f"{l64:.7f} ({rel_loss:.2e}); worst gradients: {_fmt(g_rel)} "
            f"(limits {lim[0]:.0e}, {lim[1]:.0e}); BN statistics worst "
            f"{st_rel[1]} {st_rel[0]:.2e}; bf16 card step (the control): loss "
            f"{b16['loss']:.6f}, worst gradients {_fmt(w16)}; global gradient "
            f"norm (the clip scales above 1): card fp32 {gpu['norm']:.6g}, "
            f"CPU float64 {f64['norm']:.6g}, card bf16 {b16['norm']:.6g}; the "
            f"card's clip + Adam update vs float64 on its own gradients "
            f"(limits {TOL_TTS_UPDATE[0]:.0e}, {TOL_TTS_UPDATE[1]:.0e}): "
            + "; ".join(f"{k} step deltas {_fmt(d)}, first moments {_fmt(m)}"
                        for k, (d, m) in upd.items())
            + f"; the fp32 step's first moments vs float64 with the clip's "
            f"other branch (the control): {_fmt(other)}")
    check(rel_loss <= TOL_CONV["loss"], f"{name} fp32 loss: card {l_gpu} vs "
          f"CPU float64 {l64}")
    check(_within(g_rel, lim), f"{name} fp32 gradients: {g_rel}")
    check(st_rel[0] <= TOL_CONV["stats"], f"{name} BN statistics: {st_rel}")
    check(math.isfinite(b16["loss"]) and w16[0][0] > lim[0]
          and w16[1][0] > lim[1],
          f"{name}: the bf16 control meets the fp32 limits: {b16['loss']} {w16}")
    for what, (d, m) in upd.items():
        check(_within(d, TOL_TTS_UPDATE) and _within(m, TOL_TTS_UPDATE),
              f"{name} {what} clip + Adam update: deltas {d}, moments {m}")
    check(not _within(other, TOL_TTS_UPDATE),
          f"{name}: the clip's other branch meets the limits: norm "
          f"{gpu['norm']}, {other}")
    return line, init


def _tts_references() -> dict:
    """22 a-b's float64 references on the host thread: Tacotron2's and
    WaveGlow's steps, then WaveGlow's infer at sigma 0 (and the CPU's fp32
    infer beside it)."""
    b, text_len, mel_len = T2_PARITY
    refs = {"tacotron2": _tts_reference("tacotron2", next(iter(
        SyntheticTacotronLoader(b, text_len, mel_len, steps=1)))),
        "waveglow": _tts_reference("waveglow", next(iter(
            SyntheticWaveGlowLoader(WG_PARITY_B, steps=1))))}
    batch, init, _ = refs["waveglow"]
    mel = torch.from_numpy(batch["mel"])
    refs["infer"] = _HOST.submit(lambda: (
        _float64(copy.deepcopy(init)).infer(mel.double(), 0.0),
        copy.deepcopy(init).infer(mel, 0.0)))
    return refs


def phase_tts_parity(refs: dict) -> None:
    """22 a-b: one fp32 Tacotron2 step (B=4, text 64, mel 48) and one fp32
    WaveGlow step (WG_PARITY_FLOWS flows, B=2, segment 8000) on the card
    against the CPU in float64 (``refs``: ``_tts_references``), with bf16
    controls; then
    WaveGlow's infer at sigma 0 on the card against the CPU in float64."""
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    try:
        t2_line, _ = _tts_parity("tacotron2", refs["tacotron2"])
        wg_line, init = _tts_parity("waveglow", refs["waveglow"])
        mel = torch.from_numpy(refs["waveglow"][0]["mel"])
        want, cpu32 = refs["infer"].result()
        errs = {}
        for what, model in (("card fp32", copy.deepcopy(init).to(DEV)),
                            ("CPU fp32", None),
                            ("card bf16", _tts_copy(init, torch.bfloat16).to(DEV))):
            got = cpu32 if model is None else model.infer(
                mel.to(next(model.parameters()).device), 0.0)
            errs[what] = max_err(got, want) / float(want.abs().max())
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    say("22 TTS", f"parity: {t2_line}. {wg_line}. WaveGlow infer at sigma 0 "
        f"(B={WG_PARITY_B}, {mel.shape[1]} frames) vs CPU float64, of its "
        f"largest sample: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (limit {TOL_WG_INFER:.0e}); {time.perf_counter() - t0:.1f} s")
    check(errs["card fp32"] <= TOL_WG_INFER < errs["card bf16"],
          f"WaveGlow infer at sigma 0, card vs CPU float64: {errs}")


def _tts_run(name: str, b: int, steps: int, lr: str, work: Path):
    """One CLI run with the launch counts set to 0 just before it: every
    loss finite, the last below the first (one repeated batch); K1-K6
    launched 0 times. Returns (losses, host-clock step times, peak GB)."""
    ws = work / name
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the TTS training path starts here
    state, _ = cli([name, "--batch-size", str(b), "--steps-per-epoch",
                    str(steps), "--workspace", str(ws), "--lr", lr])
    torch.cuda.synchronize()
    launched = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(state.step == steps, f"{name}: {state.step} steps")
    del state
    losses, times = _raport_losses_and_times(ws / f"{name}_raport.json")
    shutil.rmtree(ws, ignore_errors=True)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"{name}: losses {losses}")
    check(launched == dict.fromkeys(launched, 0),
          f"{name}: K1-K6 launched {launched} on the TTS path")
    return losses, times, peak_gb


def _timed(times: dict, name: str, fn):
    """``fn`` with its host-clock time, between two ``synchronize()``,
    added to ``times[name]``."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out
    return run


def phase_tts() -> dict[str, int]:
    """22 c-d: ``tacotron2`` (B=128) and ``waveglow`` (B=10) through the
    CLI's runner, bf16 at bench.py's rates; then ``TTSPipeline`` from three
    sentences to wavs (800 decoder steps, the denoiser at 0.01); returns
    the kernels' launches on these paths (all 0: no kernel of the port lies
    on them)."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "tts"
    lines = []
    frames = int(next(iter(SyntheticTacotronLoader(T2_B, steps=1)))[
        "mel_lengths"].sum())  # the CLI's batch: seed 0
    for name, b, steps, lr, per_step, unit in (
            ("tacotron2", T2_B, T2_STEPS, T2_LR, frames, "frames/s"),
            ("waveglow", WG_B, WG_STEPS, WG_LR, WG_B * 8000, "samples/s")):
        losses, times, peak = _tts_run(name, b, steps, lr, work)
        median = statistics.median(times[2:])
        lines.append(
            f"{name} B={b} lr {lr}, {steps} steps: loss "
            + " ".join(f"{x:.4f}" for x in losses)
            + f"; median step over steps 3-{steps} {median * 1e3:.1f} ms "
            f"(host clock; least {min(times[2:]) * 1e3:.1f}), {per_step} "
            f"{unit.split('/')[0]} a step: {per_step / median:.0f} {unit} "
            f"(NVIDIA's A100 figure for the reference, another card and the "
            f"reference's widths: {A100_TTS[name]:.0f}); peak device memory "
            f"{peak:.2f} GB")
    shutil.rmtree(work, ignore_errors=True)

    _reset_counts()  # the inference path starts here
    t2_task, wg_task = Tacotron2Task(), WaveGlowTask()
    times: dict[str, float] = {}
    t2 = t2_task.init(torch.Generator().manual_seed(SEED), DEV).eval()
    with torch.no_grad():  # no row finishes: every wav is 800 frames long
        t2.decoder.gate_layer.linear_layer.bias.fill_(-1e3)
    wg = wg_task.init(torch.Generator().manual_seed(SEED + 1), DEV).eval()
    t1 = time.perf_counter()
    pipe = TTSPipeline(
        t2_task, t2, wg_task, wg,
        max_decoder_steps=800, denoiser_strength=0.01,
        generator=torch.Generator().manual_seed(SEED))
    bias_s = time.perf_counter() - t1
    t2_task.infer_fn = _timed(times, "tacotron2", t2_task.infer_fn)
    wg_task.infer_fn = _timed(times, "waveglow", wg_task.infer_fn)
    pipe._denoiser = _timed(times, "denoiser", pipe._denoiser)
    runs = []
    for _ in range(2):  # the first warms cuDNN's plans and the allocator
        times.clear()
        t1 = time.perf_counter()
        wavs, mel_lens = pipe(TTS_TEXTS)
        runs.append((time.perf_counter() - t1, dict(times)))
    launched = _counts()
    order = [len(t) for t in TTS_TEXTS]
    check(len(wavs) == 3 and all(
        np.isfinite(w).all() and int(n) == 800 and len(w) == int(n) * 256
        for w, n in zip(wavs, mel_lens)),
        f"TTSPipeline: {[w.shape for w in wavs]} for mel lengths {mel_lens}")
    check(launched == dict.fromkeys(launched, 0),
          f"K1-K6 launched {launched} on the inference path")
    total, parts = runs[-1]
    say("22 TTS", "through the CLI, bf16, one repeated synthetic batch: "
        + "; ".join(lines)
        + f". TTSPipeline on {card()}: three sentences ({sorted(order, reverse=True)} "
        f"characters, ordered by decreasing text length), 800 decoder steps "
        f"at B=3, mel lengths {mel_lens.tolist()} (random weights, the gate "
        f"bias at -1e3 so that no row finishes), wavs of "
        f"{[len(w) for w in wavs]} samples; text to wav {total:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f" (first call {runs[0][0]:.3f} s; the denoiser's bias "
        f"{bias_s:.3f} s at construction); every time here {UNDER_LOAD}. "
        f"K1-K6 launched 0 times on these paths; "
        f"{time.perf_counter() - t0:.1f} s")
    return launched


# -- phase 23 ----------------------------------------------------------------

# 23a: one fp32 training step of each encoder-decoder model on the card (TF32
# off, every dropout at 0) under the CLI's optimizer, against the same step
# on the CPU in float64: the loss to 1e-5
# relative; each gradient to TOL_S2S of its own largest entry (or FLOOR
# times the largest of all, where that is more: BART's key biases, whose
# gradient the softmax cancels, are 0 but for rounding) and of the largest
# entry of all; the bf16 step (the control) must miss them. The card's
# AdamW update (each delta, the first moments) against the same update in
# float64 on the card's own gradients, to TOL_S2S_UPDATE: two devices'
# whole steps are not compared entry by entry (AdamW's first step is about
# -lr * sign(g)); each delta may differ from the update by the rounding of
# p + u (an ulp of the parameter, which swamps an update below it). The
# shapes: Transformer-base at B=4, source 64 left-padded by 0, 5, 17 and
# 40, target 64 right-padded; bart-large at B=2, source 64 and target 32,
# both right-padded; GNMT at B=2, source and target 48, right-padded. The
# CPU steps stop at the gradients. The limits lie between the readings of an H100 run (NVIDIA
# H100 80GB HBM3, 700 W; of its own / of all) of the fp32 steps, card and
# CPU alike, and the bf16 controls': Transformer-base card 6.72e-3 /
# 1.04e-3, CPU fp32 7.90e-3 / 1.37e-3, bf16 6.90e-1 / 2.80e-2 (the ReLU
# FFNs: of 12 x 524,288 inputs a few lie within fp32 rounding of the kink,
# and each that flips moves its fc1 row by one token's share); bart-large
# (exact GELU) card 5.28e-5 / 7.61e-7, CPU 4.50e-5 / 1.34e-6, bf16 6.38e-1
# / 1.09e-2; GNMT card 4.18e-6 / 2.69e-6, CPU 9.67e-6 / 4.88e-6, bf16
# 2.82e-2 / 2.56e-2. The update read at most 6.9e-6 (deltas) and 7.1e-8
# (moments).
TOL_S2S = {"transformer": (5e-2, 5e-3), "bart": (1e-3, 1e-4),
           "gnmt": (1e-3, 1e-4)}
TOL_S2S_UPDATE = (1e-4, 1e-4)
S2S_PARITY = {  # (B, source, target, source lengths, target lengths)
    "transformer": (4, 64, 64, (64, 59, 47, 24), (64, 50, 37, 21)),
    "bart": (2, 64, 32, (64, 45), (32, 19)),
    "gnmt": (2, 12, 12, (12, 8), (12, 7)),  # 48 steps before PR 18, 24 PR 19
}
# 23b: K1/K2 against their plain versions at this slice's shapes (B, Sq, Sk,
# H, causal, masked), with TOL and TOL_BWD; times for bf16. Every shape at
# which 23c-d run K1 or K2: Transformer-base at B=128 (source 64, target 63)
# and its cached decode; the CLI's bart (B=8, 4 heads, source 128, target
# 33, denoising target 129) and its decode; the bart-large step (B=8,
# source 1024, target 128: the decoder runs 127 queries, a ragged last
# tile) and decode (B=4, beam 4, source 1024)
S2S_ATTN = {
    "encoder self": (128, 64, 64, 8, False, True),
    "decoder self": (128, 63, 63, 8, True, False),
    "cross": (128, 63, 64, 8, False, True),
    "cross Sq=1 (cached decode)": (32, 1, 64, 8, False, True),
    "cli bart encoder self": (8, 128, 128, 4, False, True),
    "cli bart decoder self": (8, 33, 33, 4, True, True),
    "cli bart cross": (8, 33, 128, 4, False, True),
    "cli bart pretrain decoder self": (8, 129, 129, 4, True, True),
    "cli bart pretrain cross": (8, 129, 128, 4, False, True),
    "cli bart cross Sq=1 (cached decode)": (32, 1, 128, 4, False, True),
    "bart decoder self": (8, 128, 128, 16, True, True),
    "bart-large encoder self": (8, 1024, 1024, 16, False, True),
    "bart-large decoder self": (8, 127, 127, 16, True, True),
    "bart-large cross": (8, 127, 1024, 16, False, True),
    "bart-large decode encoder": (4, 1024, 1024, 16, False, True),
    "cross Sq=1 bart-large S=1024": (16, 1, 1024, 16, False, True),
}
# 23c: beam search on the card in fp32, Transformer-base at B=8, beam 4,
# max_len 64: cached against uncached sequences equal and scores to
# TOL_S2S_CACHED relative; the card's best-first sequences re-scored by
# teacher forcing on the CPU in float64, the length-normalised scores to
# TOL_S2S_RESCORE relative
S2S_BEAM = (8, 4, 64)
TOL_S2S_CACHED = 1e-5
TOL_S2S_RESCORE = 1e-4
# 23d: through the CLI's runners, bf16: transformer at B=128 for 20 steps at
# lr 5e-4 (the JAX runner's fallback rate; without --lr it is 0.1, quirk
# 8i), bart summarize and pretrain at B=8 and lr 1e-3, gnmt at B=128 for 5
# steps at lr 1e-3; then a bart-large AdamW step at B=8, source 1024,
# target 128, and a cached beam decode at B=4, beam 4, source 1024
S2S_T_B, S2S_T_STEPS = 128, 20
S2S_BART_B = 8
# bart summarize trains 24 epochs of the synthetic set's 8 batches (192
# steps; 40 epochs before PR 12): after 8 steps every best hypothesis was
# empty (EOS first) and ROUGE 0, after 96 on the CPU (bf16) the hypotheses
# had 6 tokens and after 320 they depended on the source. The card's bf16 best scores against float64 teacher forcing:
# the CPU's bf16 decode read 3.3e-3 after 320 steps, so the limit is 3e-2
S2S_BART_EPOCHS = 24  # 40 before PR 12
TOL_S2S_ROUGE_RESCORE = 3e-2
S2S_GNMT_B, S2S_GNMT_STEPS = 128, 5
S2S_DECODE = (4, 4, 1024, 64)  # B, beam, source, max_len
# 23a's bart-large step at bart-large's width and 2 + 2 of its 12 + 12 layers
# (the CPU's float64 step of all 24 took most of 23a's 72 s, PR 12 run 1; 4 +
# 4 still set phase 23's end on a slow host, PR 17: the bf16 control missed
# the limits by 80-200x there)
S2S_BART_PARITY_LAYERS = 2


def _s2s_init(kind: str):
    """A full-width fp32 model on the CPU from SEED, every dropout at 0,
    each bias redrawn at 0.02 N(0, 1) and each LayerNorm scale at 1 + 0.1
    N(0, 1), so that no branch sits at its zero init."""
    gen = torch.Generator().manual_seed(SEED)
    if kind == "transformer":
        model = TransformerTask(TransformerConfig(dropout=0.0),
                                torch.float32).init(gen, "cpu")
    elif kind == "bart":
        cfg = BartConfig(dropout=0.0, encoder_layers=S2S_BART_PARITY_LAYERS,
                         decoder_layers=S2S_BART_PARITY_LAYERS)
        model = BartTask(cfg, torch.float32).init(gen, "cpu")
    else:  # 3 of GNMT's 4 layers (4 before PR 12): one residual layer
        model = GnmtTask(GnmtConfig(dropout=0.0, num_layers=3),
                         torch.float32).init(gen, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            elif leaf == "weight" and p.dim() == 1:  # a LayerNorm's scale
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
    return model


def _s2s_copy(model, dtype):
    out = type(model)(model.cfg, dtype)
    out.load_state_dict(model.state_dict())
    return out.train()


def _s2s_batch(kind: str) -> dict:
    b, s, t, src_len, tgt_len = S2S_PARITY[kind]
    cfg = {"transformer": TransformerConfig(), "bart": BartConfig(),
           "gnmt": GnmtConfig()}[kind]
    rng = np.random.default_rng(SEED)
    src = np.full((b, s), cfg.pad_id, np.int32)
    tgt = np.full((b, t), cfg.pad_id, np.int32)
    for i, (n, m) in enumerate(zip(src_len, tgt_len)):
        ids = rng.integers(4, cfg.vocab_size, n)
        if kind == "transformer":  # the reference left-pads the source
            src[i, s - n:] = ids
        else:
            src[i, :n] = ids
        tgt[i, 0], tgt[i, m - 1] = cfg.bos_id, cfg.eos_id
        tgt[i, 1:m - 1] = rng.integers(4, cfg.vocab_size, m - 2)
    return {"src": src, "tgt": tgt}


# the CLI's optimizers (lr(0) is the base rate: one warmup step of ten)
S2S_TX = {
    "transformer": (5e-4, 0.0, lambda: adamw(lr_poly_warmup(5e-4, 1, 10),
                                             b2=0.997, weight_decay=0.0)),
    "bart": (1e-3, 0.01, lambda: adamw(lr_poly_warmup(1e-3, 1, 10),
                                       weight_decay=0.01)),
    "gnmt": (1e-3, 0.0, lambda: adam(1e-3)),
}


def _s2s_step(kind: str, model, batch: dict, device,
              update: bool = True) -> dict:
    """One step through ``make_train_step`` under the CLI's optimizer in the
    model's compute dtype: the loss, the gradients, the parameters before,
    the deltas and AdamW's first moments, on the CPU. ``update=False``: the
    loss and the gradients only."""
    task = {"transformer": TransformerTask, "bart": BartTask,
            "gnmt": GnmtTask}[kind](model.cfg, model.dtype)
    model = model.to(device).train()
    params = dict(model.named_parameters())
    if not update:
        t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = task.loss_fn(model, {}, t, torch.Generator())
        loss.backward()
        return {"loss": float(loss.detach()),
                "grads": {n: p.grad.detach().cpu() for n, p in params.items()}}
    tx = S2S_TX[kind][2]()
    state = create_train_state(model, tx, SEED, params=params)
    before = {n: p.detach().clone() for n, p in params.items()}
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    state, metrics = make_train_step(task.loss_fn, tx)(state, t)
    cpu = lambda d: {n: x.detach().cpu() for n, x in d.items()}  # noqa: E731
    return {"loss": float(metrics["loss"]),
            "grads": cpu({n: p.grad for n, p in params.items()}),
            "before": cpu(before),
            "deltas": cpu({n: p.detach() - before[n] for n, p in params.items()}),
            "mu": cpu(state.opt_state.mu)}


def _adamw64(kind: str, step: dict) -> tuple[dict, dict]:
    """AdamW's first update on ``step``'s own gradients, in float64:
    (deltas, first moments)."""
    lr, wd = S2S_TX[kind][:2]
    g = {n: x.double() for n, x in step["grads"].items()}
    return ({n: -lr * (x / (x.abs() + 1e-8) + wd * step["before"][n].double())
             for n, x in g.items()},
            {n: 0.1 * x for n, x in g.items()})


def _worst_update(deltas: dict, want: dict, before: dict):
    """``_worst`` of the deltas against the float64 update, each entry
    allowed one ulp of its fp32 parameter after the step (the rounding of p
    + u, which swamps an update below that ulp)."""
    top = max(float(w.abs().max()) for w in want.values())
    out = ([], [])
    for n, w in want.items():
        after = before[n] + deltas[n]
        ulp = (torch.nextafter(after, torch.full_like(after, math.inf))
               - after).double()
        err = float(((deltas[n].double() - w).abs() - ulp).clamp(min=0).max())
        out[0].append((err / max(float(w.abs().max()), FLOOR * top), n))
        out[1].append((err / top, n))
    return max(out[0]), max(out[1])


def _s2s_reference(kind: str):
    """23a's batch and weights for one model, and its float64 step on the
    CPU, started on the host thread (``_HOST``) so that it runs beside the
    card's work of 23c-d."""
    batch, init = _s2s_batch(kind), _s2s_init(kind)
    return batch, init, _HOST.submit(
        _s2s_step, kind, _float64(copy.deepcopy(init)), batch, "cpu",
        update=False)


def _s2s_parity(kind: str, ref) -> None:
    """23a for one model, on its ``_s2s_reference``."""
    t0 = time.perf_counter()
    batch, init, f64 = ref
    gpu = _s2s_step(kind, copy.deepcopy(init), batch, DEV)
    b16 = _s2s_step(kind, _s2s_copy(init, torch.bfloat16), batch, DEV)
    f64 = f64.result()
    del init
    lim = TOL_S2S[kind]
    g64 = f64["grads"]
    g_rel, w16 = (_worst(s["grads"], g64) for s in (gpu, b16))
    rel_loss = abs(gpu["loss"] - f64["loss"]) / abs(f64["loss"])
    upd = {}
    for what, s in (("fp32", gpu), ("bf16", b16)):
        d64, mu64 = _adamw64(kind, s)
        upd[what] = (_worst_update(s["deltas"], d64, s["before"]),
                     _worst(s["mu"], mu64))
    b, s_len, t_len = S2S_PARITY[kind][:3]
    line = (f"{kind} B={b} source {s_len} target {t_len}: one fp32 step, card "
            f"vs CPU float64: loss {gpu['loss']:.7f} vs {f64['loss']:.7f} "
            f"({rel_loss:.2e}); worst gradients: {_fmt(g_rel)} (limits "
            f"{lim[0]:.0e}, {lim[1]:.0e}); bf16 card step (the "
            f"control): loss {b16['loss']:.6f}, worst gradients {_fmt(w16)}; "
            f"the card's update vs float64 on its own gradients (limits "
            f"{TOL_S2S_UPDATE[0]:.0e}, {TOL_S2S_UPDATE[1]:.0e}): "
            + "; ".join(f"{k} step deltas {_fmt(d)}, first moments {_fmt(m)}"
                        for k, (d, m) in upd.items())
            + f" ({time.perf_counter() - t0:.1f} s)")
    say("23 seq2seq", f"parity: {line}")
    check(rel_loss <= TOL_CONV["loss"], f"{kind} fp32 loss: card "
          f"{gpu['loss']} vs CPU float64 {f64['loss']}")
    check(_within(g_rel, lim), f"{kind} fp32 gradients: {g_rel}")
    check(math.isfinite(b16["loss"]) and not _within(w16, lim),
          f"{kind}: the bf16 control meets the fp32 limits: {b16['loss']} {w16}")
    for what, (d, m) in upd.items():
        check(_within(d, TOL_S2S_UPDATE) and _within(m, TOL_S2S_UPDATE),
              f"{kind} {what} update: deltas {d}, moments {m}")


def phase_s2s_parity(refs: dict) -> None:
    """23a: one fp32 step of Transformer-base, bart-large and GNMT, card
    against CPU float64 (``refs``: each model's ``_s2s_reference``), with
    bf16 controls; each model's line is printed before its checks, and
    every model runs before the first failure is raised."""
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    failed = []
    try:
        for kind in S2S_PARITY:
            try:
                _s2s_parity(kind, refs[kind])
            except AssertionError as e:
                failed.append(str(e))
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    check(not failed, "; ".join(failed))


def _s2s_attn_inputs(b, sq, sk, h, dtype, masked, seed=SEED):
    """q (B, Sq, H, 64), k, v (B, Sk, H, 64) and a key mask with lengths
    in [Sk / 4, Sk], the last row fully masked."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, D), generator=g).to(DEV, dtype)
    k, v = (torch.randn((b, sk, h, D), generator=g).to(DEV, dtype)
            for _ in range(2))
    mask = None
    if masked:
        lengths = torch.randint(sk // 4, sk + 1, (b,), generator=g)
        mask = (torch.arange(sk)[None, :] < lengths[:, None]).to(torch.int32)
        mask[-1] = 0
        mask = mask.to(DEV)
    return q, k, v, mask


def _s2s_attn_case(b, sq, sk, h, causal, masked, dtype, rate=0.0, seed=0):
    """K1 and K2 against their plain versions at one shape, with dropout at
    ``rate`` (raises past TOL and TOL_BWD): (K1's out error, K2's worst
    error over its largest entry, K2's worst error)."""
    q, k, v, mask = _s2s_attn_inputs(b, sq, sk, h, dtype, masked)
    for t in (q, k, v):
        t.requires_grad_()
    kw = dict(causal=causal, layout="bshd", dropout_rate=rate,
              dropout_seed=seed)
    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    ref, ref_lse = fa.mha_reference(q.detach(), k.detach(), v.detach(), mask,
                                    **kw)
    e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
    check(e_out <= TOL[dtype][0] and e_lse <= TOL[dtype][1],
          f"K1 vs plain b{b} sq{sq} sk{sk} h{h} {dtype}: out {e_out:.3e} "
          f"lse {e_lse:.3e}")
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                       ).to(DEV, dtype)
    out.backward(dout)
    torch.cuda.synchronize()
    check((fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
          == tuple(n + 1 for n in before), "K1/K2 not launched")
    want = fa.mha_backward_reference(q.detach(), k.detach(), v.detach(), mask,
                                     out.detach(), lse, dout, causal,
                                     layout="bshd", dropout_rate=rate,
                                     dropout_seed=seed)
    rel = worst = 0.0
    for name, got, ref in zip("qkv", (q.grad, k.grad, v.grad), want):
        err, scale = max_err(got, ref), float(ref.float().abs().max())
        check(math.isfinite(err) and err <= TOL_BWD[dtype] * scale,
              f"K2 vs plain b{b} sq{sq} sk{sk} h{h} {dtype}: d{name} {err:.3e}"
              f" of {scale:.3e}")
        rel, worst = max(rel, err / max(scale, 1e-30)), max(worst, err)
    return e_out, rel, worst


def _s2s_time(b, sq, sk, h, causal, masked, rate=0.0, seed=0) -> str:
    """bf16 K1 (with dropout at ``rate``), its plain version and SDPA
    (without) at one shape, in turns, with the bound: one line."""
    q, k, v, mask = _s2s_attn_inputs(b, sq, sk, h, torch.bfloat16, masked)
    sdpa_mask = None
    if mask is not None:
        sdpa_mask = mask.bool()[:, None, None, :].expand(b, 1, sq, sk)
    if causal:
        tri = torch.ones(sq, sk, dtype=torch.bool, device=DEV).tril()
        sdpa_mask = tri if sdpa_mask is None else sdpa_mask & tri
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.inference_mode():
        ms = _clocks({
            "ms": (lambda: fa.flash_attention(
                q, k, v, mask, causal=causal, layout="bshd", dropout_rate=rate,
                dropout_seed=seed), 30),
            "plain_ms": (lambda: fa.mha_reference(
                q, k, v, mask, causal, layout="bshd", dropout_rate=rate,
                dropout_seed=seed), 10),
            "library_ms": (lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask), 30)}, turns=2)
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    bound, by = _bound(2 * b * (sq + sk) * h * D * 2 + b * h * sq * 4
                       + (b * sk * 4 if masked else 0), 4 * pairs * D,
                       torch.bfloat16)
    return (f"K1 {ms['ms'][0]:.4f} [{ms['ms'][1]:.4f}] ms, plain "
            f"{ms['plain_ms'][0]:.4f} ms, SDPA {ms['library_ms'][0]:.4f} "
            f"[{ms['library_ms'][1]:.4f}] ms, bound {bound:.4f} ms ({by})")


def phase_s2s_kernels() -> tuple[float, float]:
    """23b: K1 and K2 against their plain versions at this slice's shapes in
    bf16 and fp32, with bf16 times. Returns the worst K1 out error and K2
    error (max abs)."""
    t0 = time.perf_counter()
    worst_fwd = worst_bwd = 0.0
    lines = []
    for name, (b, sq, sk, h, causal, masked) in S2S_ATTN.items():
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            e_out, rel, e_bwd = _s2s_attn_case(b, sq, sk, h, causal, masked,
                                               dtype)
            worst_fwd, worst_bwd = max(worst_fwd, e_out), max(worst_bwd, e_bwd)
            errs.append(f"{'fp32' if dtype == torch.float32 else 'bf16'} "
                        f"{e_out:.2e}/{rel:.2e}")
        lines.append(f"{name} (B={b} Sq={sq} Sk={sk} H={h}"
                     f"{' causal' if causal else ''}"
                     f"{' masked' if masked else ''}): K1 out err / K2 err of "
                     f"its largest {', '.join(errs)}; bf16 "
                     + _s2s_time(b, sq, sk, h, causal, masked))
    # K2's times at the training shapes whose queries and keys are one
    # sequence: the encoder's masked self-attention, the decoder's causal
    # one, BART's causal and masked decoder, bart-large's encoder and decoder
    bwd = {"encoder self B=128 S=64 H=8 masked": (128, 64, 8, True, False),
           "decoder self B=128 S=63 H=8 causal": (128, 63, 8, False, True),
           "bart decoder self B=8 S=128 H=16 causal masked":
               (8, 128, 16, True, True),
           "bart-large encoder self B=8 S=1024 H=16 masked":
               (8, 1024, 16, True, False),
           "bart-large decoder self B=8 S=127 H=16 causal masked":
               (8, 127, 16, True, True)}
    for name, (b, s, h, masked, causal) in bwd.items():
        lines.append(f"K2 {name}: " + _fmt_bwd_times(
            _time_bwd(b, s, h, D, "bshd", masked=masked, causal=causal)))
    say("23 seq2seq", "K1/K2 at the slice's shapes vs plain (D=64, bshd): "
        + "; ".join(lines) + " (CUDA events, least of 2 (K2: 3) in turns; "
        f"[the card's clock alone]; {time.perf_counter() - t0:.1f} s)")
    return worst_fwd, worst_bwd


def _rescore64(model64, src: np.ndarray, seqs: torch.Tensor, beam: int,
               cfg) -> torch.Tensor:
    """The length-normalised score of each (B, beam, L) sequence by teacher
    forcing on the CPU in float64: the log-probabilities of its tokens up to
    and with its first EOS (pads after it cost 0)."""
    b, _, length = seqs.shape
    flat = seqs.reshape(b * beam, length).cpu()
    with torch.no_grad():
        memory, mask = model64.encode(torch.from_numpy(src))
        logits = model64.decode(flat, memory.repeat_interleave(beam, 0),
                                mask.repeat_interleave(beam, 0))
    logp = torch.log_softmax(logits, -1)[:, :-1]
    tok = flat[:, 1:]
    gain = logp.gather(-1, tok[..., None])[..., 0]
    done_before = torch.cumsum((tok == cfg.eos_id).long(), 1) - (
        tok == cfg.eos_id).long() > 0
    score = torch.where(done_before, 0.0, gain).sum(1)
    lengths = (flat != cfg.pad_id).sum(1).double()
    return (score / ((5.0 + lengths) / 6.0) ** 0.6).reshape(b, beam)


def phase_s2s_decode() -> dict[str, int]:
    """23c: plain and cached beam search of fp32 Transformer-base on the
    card; the cached search's K1 launches; the card's sequences re-scored on
    the CPU in float64."""
    t0 = time.perf_counter()
    b, beam, max_len = S2S_BEAM
    cfg = TransformerConfig()
    init = TransformerTask(cfg, torch.float32).init(
        torch.Generator().manual_seed(SEED), "cpu").eval()
    model = copy.deepcopy(init).to(DEV)
    rng = np.random.default_rng(SEED)
    src = np.full((b, 64), cfg.pad_id, np.int32)
    for i, n in enumerate(rng.integers(32, 65, b)):
        src[i, 64 - n:] = rng.integers(4, cfg.vocab_size, n)
    kw = dict(beam_size=beam, max_len=max_len, bos_id=cfg.bos_id,
              eos_id=cfg.eos_id, pad_id=cfg.pad_id, vocab_size=cfg.vocab_size)
    with torch.no_grad():
        memory, mask = model.encode(torch.from_numpy(src).to(DEV))
    mem, msk = memory.repeat_interleave(beam, 0), mask.repeat_interleave(beam, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = fa.launches
    plain = beam_search(lambda ids: model.decode(ids, mem, msk), b,
                        device=DEV, **kw)
    torch.cuda.synchronize()
    t_plain, plain_k1 = time.perf_counter() - t1, fa.launches - before
    t1 = time.perf_counter()
    before = fa.launches
    cached = beam_search_cached(model, mem, msk, b, **kw)
    torch.cuda.synchronize()
    t_cached, cached_k1 = time.perf_counter() - t1, fa.launches - before
    layers = cfg.decoder_layers
    check(cached_k1 == layers * (max_len - 1),
          f"cached search launched K1 {cached_k1} times, not "
          f"{layers * (max_len - 1)}")
    check(plain_k1 == 2 * layers * (max_len - 1),
          f"plain search launched K1 {plain_k1} times")
    same = bool((plain[0] == cached[0]).all())
    rel_cached = max_err(plain[1], cached[1]) / float(cached[1].abs().max())
    want = _rescore64(_float64(copy.deepcopy(init)), src, cached[0], beam, cfg)
    rel_rescore = max_err(cached[1], want) / float(want.abs().max())
    lengths = (cached[0][:, 0] != cfg.pad_id).sum(1).tolist()
    say("23 seq2seq", f"beam search, fp32 Transformer-base on the card, B={b} "
        f"beam {beam} max_len {max_len}: plain and cached sequences equal: "
        f"{same}; scores {rel_cached:.2e} apart (limit {TOL_S2S_CACHED:.0e}); "
        f"the cached search's best-first scores vs teacher forcing on the CPU "
        f"in float64: {rel_rescore:.2e} (limit {TOL_S2S_RESCORE:.0e}); best "
        f"lengths {lengths}; K1 launches: cached {cached_k1} (= {layers} "
        f"layers x {max_len - 1} steps, the cross-attention at Sq=1), plain "
        f"{plain_k1}; host clock: plain {t_plain:.3f} s, cached "
        f"{t_cached:.3f} s ({time.perf_counter() - t0:.1f} s)")
    check(same and rel_cached <= TOL_S2S_CACHED,
          f"cached vs plain beam search: equal {same}, scores {rel_cached}")
    check(rel_rescore <= TOL_S2S_RESCORE,
          f"beam scores vs float64 teacher forcing: {rel_rescore}")
    return {"flash_fwd": cached_k1 + plain_k1}


def _s2s_counts_ok(name: str, launched: dict, attention: bool) -> None:
    k12 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    want_zero = {k: v for k, v in launched.items() if k not in k12}
    check(want_zero == dict.fromkeys(want_zero, 0),
          f"{name}: K3-K6 launched {launched}")
    if attention:
        check(all(launched[k] > 0 for k in k12),
              f"{name}: K1/K2 not launched {launched}")
    else:
        check(all(launched[k] == 0 for k in k12),
              f"{name}: K1/K2 launched {launched}")


def _s2s_cli(name: str, args: list[str], work: Path, attention: bool = True,
             after=None):
    """One CLI run with the counts set to 0 just before it: (launches,
    losses, host-clock step times, peak GB, what the runner returned, what
    ``after(state, workspace, returned)`` returned, called once the counts
    are read)."""
    ws = work / name
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # this path starts here
    state, out = cli([name.split("-")[0], *args, "--workspace", str(ws)])
    torch.cuda.synchronize()
    launched = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    checked = after(state, ws, out) if after else None
    del state
    losses, times = _raport_losses_and_times(
        ws / f"{name.split('-')[0]}_raport.json")
    shutil.rmtree(ws, ignore_errors=True)
    check(losses and all(math.isfinite(x) for x in losses),
          f"{name}: losses {losses}")
    _s2s_counts_ok(name, launched, attention)
    return launched, losses, times, peak, out, checked


def _bart_rouge_check(state, ws: Path, out: dict) -> str:
    """The summarize run's val decode, again on the card from the trained
    state (``bart_decode_val``, as the runner calls it): every best
    hypothesis non-empty, the runner's ROUGE equal to ``rouge_scores`` of
    these sequences, ROUGE-1 above 0, and the best scores (bf16) against
    teacher forcing of the same sequences on the CPU in float64, to
    TOL_S2S_ROUGE_RESCORE relative to the largest."""
    cfg = cli_main.BartCliConfig(task="summarize", batch_size=S2S_BART_B,
                                 workspace=str(ws))
    data_dir, tok = cli_main.bart_corpus(cfg)
    got = cli_main.bart_decode_val(cfg, state.model, data_dir, tok)
    lengths = [len(h) for h in got["hyps"]]
    again = {f"val.{k}": v for k, v in
             rouge_scores(got["hyps"], got["refs"]).items()}
    mcfg = state.model.cfg
    want = _rescore64(_float64(copy.deepcopy(state.model).cpu()), got["src"],
                      got["seqs"][:, None], 1, mcfg)[:, 0]
    rel = max_err(got["scores"], want) / float(want.abs().max())
    check(lengths and min(lengths) > 0,
          f"bart summarize: empty hypotheses, lengths {lengths}")
    check(again == out, f"bart summarize: ROUGE {out} vs {again} of the "
          "decoded sequences")
    check(out["val.rouge1"] > 0.0, f"bart summarize: ROUGE {out}")
    check(rel <= TOL_S2S_ROUGE_RESCORE,
          f"bart summarize: best scores vs float64 teacher forcing {rel}")
    return (f"{len(lengths)} val hypotheses of {min(lengths)}-{max(lengths)} "
            f"tokens, their best scores vs teacher forcing on the CPU in "
            f"float64 {rel:.2e} (limit {TOL_S2S_ROUGE_RESCORE:.0e}), the "
            f"runner's ROUGE that of these sequences")


def phase_s2s() -> dict[str, int]:
    """23d: transformer, bart (summarize, pretrain) and gnmt through the
    CLI's runners in bf16; a bart-large step and cached decode; returns the
    kernels' launches on these paths."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "s2s"
    total = dict.fromkeys(_counts(), 0)
    lines = []
    tokens = S2S_T_B * (64 + 63)
    launched, losses, times, peak, _, _ = _s2s_cli(
        "transformer", ["--batch-size", str(S2S_T_B), "--steps-per-epoch",
                        str(S2S_T_STEPS), "--lr", "5e-4"], work)
    check(losses[-1] < losses[0], f"transformer: losses {losses}")
    med = statistics.median(times[2:])
    lines.append(f"transformer B={S2S_T_B} lr 5e-4, {S2S_T_STEPS} steps: loss "
                 f"{losses[0]:.4f} -> {losses[-1]:.4f}; median step over steps "
                 f"3-{S2S_T_STEPS} {med * 1e3:.1f} ms (host clock), {tokens} "
                 f"tokens a step: {tokens / med:.0f} tokens/s; peak {peak:.2f} "
                 f"GB; launches {launched}")
    for k, v in launched.items():
        total[k] += v
    launched, losses, times, peak, out, decoded = _s2s_cli(
        "bart-summarize", ["--task", "summarize", "--lr", "1e-3",
                           "--batch-size", str(S2S_BART_B), "--epochs",
                           str(S2S_BART_EPOCHS)], work,
        after=_bart_rouge_check)
    check(set(out) == {"val.rouge1", "val.rouge2", "val.rougeL"}
          and all(0.0 <= v <= 1.0 for v in out.values()),
          f"bart summarize: ROUGE {out}")
    lines.append(f"bart --task summarize B={S2S_BART_B} lr 1e-3, "
                 f"{len(losses)} steps: loss {losses[0]:.4f} -> "
                 f"{losses[-1]:.4f}, beam-decoded val ROUGE "
                 + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
                 + f"; {decoded}; launches {launched}")
    for k, v in launched.items():
        total[k] += v
    launched, losses, times, peak, _, _ = _s2s_cli(
        "bart-pretrain", ["--task", "pretrain", "--lr", "1e-3", "--batch-size",
                          str(S2S_BART_B), "--steps-per-epoch", "5"], work)
    lines.append(f"bart --task pretrain B={S2S_BART_B} lr 1e-3, 5 steps: loss "
                 f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launched}")
    for k, v in launched.items():
        total[k] += v
    launched, losses, times, peak, _, _ = _s2s_cli(
        "gnmt", ["--batch-size", str(S2S_GNMT_B), "--steps-per-epoch",
                 str(S2S_GNMT_STEPS), "--lr", "1e-3"], work, attention=False)
    med = statistics.median(times[1:])
    tokens = S2S_GNMT_B * (48 + 47)
    lines.append(f"gnmt B={S2S_GNMT_B} lr 1e-3, {S2S_GNMT_STEPS} steps: loss "
                 f"{losses[0]:.4f} -> {losses[-1]:.4f}; median step over steps "
                 f"2-{S2S_GNMT_STEPS} {med * 1e3:.1f} ms, {tokens / med:.0f} "
                 f"tokens/s; peak {peak:.2f} GB (K1-K6 launched 0 times: GNMT's "
                 "attention is Bahdanau's, in plain ops as in JAX)")
    shutil.rmtree(work, ignore_errors=True)

    # bart-large: one bf16 AdamW step at B=8, source 1024, target 128
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # this path starts here
    step, state, batch = profile_seq2seq._bart_large(DEV)
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launched = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(float(m["loss"])), f"bart-large loss {m['loss']}")
    _s2s_counts_ok("bart-large step", launched, True)
    for k, v in launched.items():
        total[k] += v
    shape = profile_seq2seq.BART_SHAPE
    lines.append(f"bart-large B={shape['batch']} source {shape['src']} target "
                 f"{shape['tgt']}, bf16 AdamW step: "
                 f"{' '.join(f'{x:.1f}' for x in step_ms)} ms (host clock; "
                 f"the first warms up), loss {float(m['loss']):.4f}, peak "
                 f"{peak:.2f} GB; launches {launched}")

    # bart-large: a cached beam decode at B=4, beam 4, source 1024
    model = state.model
    del state, step, batch
    torch.cuda.empty_cache()
    b, beam, s, max_len = S2S_DECODE
    cfg = model.cfg
    src = torch.from_numpy(np.random.default_rng(SEED).integers(
        4, cfg.vocab_size, (b, s))).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # this path starts here
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        memory, mask = model.encode(src)
    seqs, scores = beam_search_cached(
        model, memory.repeat_interleave(beam, 0),
        mask.repeat_interleave(beam, 0), b, beam, max_len=max_len,
        bos_id=cfg.bos_id, eos_id=cfg.eos_id, pad_id=cfg.pad_id,
        vocab_size=cfg.vocab_size)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t1
    launched = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launched["flash_fwd"] == cfg.encoder_layers
          + cfg.decoder_layers * (max_len - 1),
          f"bart-large decode: K1 launched {launched['flash_fwd']}")
    check(bool(torch.isfinite(scores).all()) and seqs.shape == (b, beam, max_len),
          f"bart-large decode: {seqs.shape}, {scores}")
    for k, v in launched.items():
        total[k] += v
    lines.append(f"bart-large cached beam decode B={b} beam {beam} source {s} "
                 f"max_len {max_len}: {t_dec:.3f} s (host clock, encoder "
                 f"included: {t_dec / (max_len - 1) * 1e3:.1f} ms a step), "
                 f"peak {peak:.2f} GB; K1 launched {launched['flash_fwd']} "
                 f"times (= {cfg.encoder_layers} + {cfg.decoder_layers} x "
                 f"{max_len - 1})")
    del model
    say("23 seq2seq", f"paths on {card()}, bf16: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return total


# -- phase 24 ----------------------------------------------------------------

# K1/K2 where this slice runs them off the earlier shapes: BERT's 4l-312
# distillation student (12 heads of 312 / 12 = 26) at B=32 S=128, and
# BERT-Large's heads at every bucket length of the binned phase-2 loader
# (B=16, the phase-2 batch)
D26 = dict(b=32, s=128, h=12, d=26)
BUCKETS = tuple(range(64, 513, 64))
TIMED_BUCKETS = (64, 192, 320, 512)
P2_B = 16
CORPUS_DOCS = 240  # documents of the corpus phase 24 writes
CORPUS_STEPS = 10  # --config-file run (20 before PR 12)
TOL_REMAT = 1e-6  # remat vs not, fp32 on the card: of the largest entry
# the distillation step card fp32 vs CPU float64 (dropout off): the loss,
# and each gradient against the largest gradient entry of all
TOL_DISTILL = {"loss": 1e-5, "grad": 1e-4}
DISTILL_B, DISTILL_STEPS = 32, 10
# 24d's teacher at BERT-Large's width and 12 of its 24 layers (a multiple of
# both students' 4 and 6; cut for time, PR 19: it is built five times and its
# float64 forward runs on the host)
DISTILL_TEACHER_LAYERS = 12
DLRM_BIN_CARDS = tuple(150_000 - 4_000 * i for i in range(26))  # 2.6M rows
DLRM_BIN_ROWS, DLRM_BIN_STEPS = 4_000_000, 20


def _case_name(c: dict) -> str:
    return (f"{'f32' if c['dtype'] == torch.float32 else 'bf16'} b{c['b']} "
            f"s{c['s']} h{c['h']} d{c['d']}"
            f"{' drop' if c.get('rate') else ''}")


def phase_bert_data_kernels() -> tuple[float, float, dict]:
    """24a: K1 and K2 against their plain versions at head dim 26 (bf16 and
    fp32, masked, dropout 0.1) and at the binned loader's bucket lengths
    (bf16); times beside SDPA and the bound. Returns K1's and K2's worst
    errors and the times."""
    t0 = time.perf_counter()
    cases = [dict(**D26, dtype=dt, layout="bshd", rate=0.1, seed=-24680)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [dict(b=P2_B, s=s, h=16, d=64, dtype=torch.bfloat16,
                   layout="bshd", rate=0.1, seed=s) for s in BUCKETS]
    for c in cases:
        _fwd_bwd_case(c)
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        key = f"d26 {'f32' if dt == torch.float32 else 'bf16'}"
        times[key] = (_time_fwd(D26["b"], D26["s"], D26["h"], 26, "bshd",
                                dtype=dt),
                      _time_bwd(D26["b"], D26["s"], D26["h"], 26, "bshd",
                                dtype=dt))
    for s in TIMED_BUCKETS:
        times[f"b{P2_B} s{s} h16 d64 bf16"] = (
            _time_fwd(P2_B, s, 16, 64, "bshd"), _time_bwd(P2_B, s, 16, 64, "bshd"))
    say("24a kernels", "K1/K2 vs plain, max abs err of out/lse and of "
        "dq/dk/dv, and the worst over the gradient's largest entry: "
        + ", ".join(f"{_case_name(c)}: {c['err'][1]:.2e}/{c['err'][2]:.2e}, "
                    f"{c['err'][0]:.2e} ({c['rel']:.2e})" for c in cases)
        + "; times (CUDA events, least of 3 in turns; [the card's clock "
        "alone]): " + "; ".join(f"{k}: forward {_fmt_times(f)}; backward "
                                f"{_fmt_bwd_times(b)}"
                                for k, (f, b) in times.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    return (max(c["err"][1] for c in cases), max(c["err"][0] for c in cases),
            times)


def _grads_of(model, task, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    loss, _ = task.loss_fn(model, {}, batch, gen)
    loss.backward()
    return float(loss), {n: p.grad.detach() for n, p in model.named_parameters()}


def phase_remat() -> str:
    """24b: one fp32 BERT-Large step (B=4 S=128, dropout 0.1, TF32 off)
    with ``remat`` against the same step without; then the phase-2 step
    (B=16 S=512 bf16) with and without, for peak memory and time."""
    t0 = time.perf_counter()
    cfg = BERT_CONFIGS["large"]
    init = BertForPreTraining(cfg)
    init_bert_weights_(init, torch.Generator().manual_seed(SEED),
                       cfg.initializer_range)
    sd = init.state_dict()
    del init
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in _pretrain_batch(4, TS, 20).items()}
    p2 = {k: torch.from_numpy(v).to(DEV)
          for k, v in _pretrain_batch(P2_B, 512, 76).items()}
    grads, lines = {}, []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = BertForPreTraining(c, torch.float32)
        model.load_state_dict(sd)
        model.to(DEV)
        before = dict(_counts())
        loss, grads[remat] = _grads_of(
            model, BertPretrainTask(c, torch.float32, 20), batch, SEED + 24)
        torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in _counts().items()}
        k1 = LAYERS * (2 if remat else 1)  # the recompute runs K1 again
        check(n["flash_fwd"] == k1 and n["flash_bwd_dq"] == LAYERS
              and n["flash_bwd_dkv"] == LAYERS,
              f"remat {remat}: launches {n}, want K1 {k1}, K2 {LAYERS}")
        del model
        # phase 2 in bf16: peak memory and the time of a forward + backward
        model = BertForPreTraining(c, torch.bfloat16)
        model.load_state_dict(sd)
        model.to(DEV)
        task = BertPretrainTask(c, torch.bfloat16, 76)
        ms = []
        for i in range(3):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            _grads_of(model, task, p2, SEED + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, task
        torch.cuda.empty_cache()
        lines.append(f"{'remat' if remat else 'no remat'}: fp32 loss {loss:.6f}, K1 "
                     f"{n['flash_fwd']} K2 {n['flash_bwd_dq']}+"
                     f"{n['flash_bwd_dkv']}; phase 2 b{P2_B} s512 bf16 "
                     f"forward + backward {min(ms[1:]):.1f} ms (least of 2 "
                     f"after one warm-up), peak {peak:.2f} GB")
    top = max(float(g.abs().max()) for g in grads[False].values())
    worst, name = max((max_err(grads[True][n], g) / top, n)
                      for n, g in grads[False].items())
    lines.append(f"remat vs none: worst gradient {name} {worst:.2e} of the "
                 "largest entry")
    check(worst <= TOL_REMAT, f"remat: {name} {worst:.3e} of the largest "
          f"gradient entry (limit {TOL_REMAT:.0e})")
    del grads
    say("24b remat", f"BERT-Large, dropout 0.1, TF32 off: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return "; ".join(lines)


def _write_corpus(root: Path) -> tuple[str, str]:
    """Text files of blank-line-separated documents, capitalised sentences of
    4 to 200 words drawn from a vocabulary of a few thousand made-up words
    (whole words, so every id is below BERT's vocabulary), and that
    vocabulary; returns (the glob of the text files, the vocab file)."""
    rng = np.random.default_rng(SEED)
    syll = ["ka", "lo", "mi", "ne", "tu", "ra", "si", "vo", "de", "pa", "be",
            "go", "fu", "zi", "ho"]
    words = sorted({"".join(rng.choice(syll, size=rng.integers(1, 5)))
                    for _ in range(8000)})
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","] + words)
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    # Zipf-like word frequencies, and mostly short sentences with a long tail
    weights = 1.0 / np.arange(1, len(words) + 1)
    weights /= weights.sum()
    for f in range(4):
        docs = []
        for _ in range(CORPUS_DOCS // 4):
            sents = []
            for _ in range(rng.integers(4, 16)):
                n = int(min(3 + rng.geometric(1 / 45), 200))
                ws = rng.choice(words, size=n, p=weights)
                sents.append(" ".join(ws).capitalize() + ".")
            docs.append("\n".join(" ".join(sents[i:i + 2])
                                  for i in range(0, len(sents), 2)))
        (root / f"part_{f}.txt").write_text("\n\n".join(docs) + "\n")
    return str(root / "part_*.txt"), str(root / "vocab.txt")


def _cli_run(args: list[str], ws: Path) -> dict:
    """One CLI run with the launch counts set to 0 before it: its state, the
    counts after it, its raport's losses, step and data times, val records
    and parameters, and its peak memory."""
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # this path starts here
    t0 = time.perf_counter()
    state, best, *_ = cli([*args, "--workspace", str(ws)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _counts()
    raport = next(ws.glob("*_raport.json"))
    data = _raport_data(raport)
    train = [d for d in data if "train.loss" in d]
    out = {"state": state, "best": best, "launched": launched, "wall": wall,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": [d["train.loss"] for d in train],
           "step_ms": [d["train.compute_time"] * 1e3 for d in train],
           "data_ms": [d.get("train.data_time", 0.0) * 1e3 for d in train],
           # every step's wait for its batch, in step order (an entry of the
           # raport pairs a step's loss with the next step's wait)
           "waits_ms": [d["train.data_time"] * 1e3 for d in data
                        if "train.data_time" in d],
           "val": [d for d in data if any(k.startswith("val.") for k in d)],
           "params": next(d for d in data if "batch_size" in d and "lr" in d)}
    shutil.rmtree(ws, ignore_errors=True)
    return out


def phase_bert_corpus() -> dict[str, int]:
    """24c: ``bert-pretrain`` on a corpus the phase writes, through the
    CLI's runner at full width (BERT-Large, bf16): ``--config-file
    configs.yml --precision bf16`` (B=64 S=128 lr 0.006 from the file), 20
    steps; ``--phase2 --binned --remat`` at B=16; ``--attention-impl xla``;
    the host time to make a batch. Returns the kernels' launches on the
    CLI runs."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "corpus"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    texts, vocab = _write_corpus(work)
    t1 = time.perf_counter()
    n_docs = bert_prep.prepare_corpus(texts, vocab, str(work / "shards"),
                                      n_shards=4)
    prep_s = time.perf_counter() - t1
    check(n_docs == CORPUS_DOCS, f"prepare_corpus wrote {n_docs} documents")
    shards = str(work / "shards")
    corpus = ["--data-backend", "corpus", "--data-dir", shards, "--mode",
              "benchmark-training"]
    total = dict.fromkeys(_counts(), 0)
    lines = [f"corpus of {n_docs} documents prepared in {prep_s:.1f} s"]
    eval_batches = 10  # the corpus backend's val loader

    # configs.yml's phase-1 settings, 20 steps
    r = _cli_run(["bert-pretrain", "--config-file", "configs.yml",
                  "--precision", "bf16", *corpus, "--steps-per-epoch",
                  str(CORPUS_STEPS)], work / "cfg")
    prm = r["params"]
    check((prm["batch_size"], prm["seq_len"], prm["lr"], prm["amp"])
          == (64, 128, 0.006, True), f"--config-file resolved {prm}")
    losses = r["losses"]
    check(len(losses) == CORPUS_STEPS and all(map(math.isfinite, losses)),
          f"corpus run: losses {losses}")
    check(statistics.mean(losses[-5:]) < losses[0],
          f"corpus run: the loss did not fall: {losses}")
    want = {**dict.fromkeys(r["launched"], 0),
            "flash_fwd": LAYERS * (CORPUS_STEPS + eval_batches),
            "flash_bwd_dq": LAYERS * CORPUS_STEPS,
            "flash_bwd_dkv": LAYERS * CORPUS_STEPS}
    check(r["launched"] == want, f"corpus run: launches {r['launched']}, "
          f"want {want}")
    for k, v in r["launched"].items():
        total[k] += v
    val = r["val"][0]
    lines.append(f"--config-file configs.yml --precision bf16 (B "
                 f"{prm['batch_size']}, S {prm['seq_len']}, lr {prm['lr']}), "
                 f"{CORPUS_STEPS} steps: loss " + " ".join(f"{x:.4f}" for x in losses)
                 + f"; val mlm_acc {val.get('val.mlm_acc', float('nan')):.4f}; "
                 f"median step {statistics.median(r['step_ms'][1:]):.1f} ms, "
                 f"data {statistics.median(r['data_ms'][1:]):.2f} ms (the loop's "
                 f"host clock); peak {r['peak_gb']:.2f} GB; launches "
                 f"{r['launched']}")
    del r

    # phase 2, binned, remat
    steps = 5
    args = ["bert-pretrain", *corpus, "--phase2", "--binned", "--remat",
            "--batch-size", str(P2_B), "--lr", PRETRAIN_LR,
            "--steps-per-epoch", str(steps)]
    cfg = cli_main.BertCliConfig(data_backend="corpus", data_dir=shards,
                                 batch_size=P2_B, seq_len=512,
                                 max_predictions=76, binned=True,
                                 mode="benchmark-training",
                                 steps_per_epoch=steps)
    loader, _ = cli_main._corpus_loaders(cfg, BERT_CONFIGS["large"].vocab_size)
    buckets = [b["input_ids"].shape[1] for b in loader]
    r = _cli_run(args, work / "p2")
    check(len(r["losses"]) == steps and all(map(math.isfinite, r["losses"])),
          f"phase 2 binned remat: losses {r['losses']}")
    want = {**dict.fromkeys(r["launched"], 0),
            # the recompute runs each layer's K1 again in the backward
            "flash_fwd": LAYERS * (2 * steps + eval_batches),
            "flash_bwd_dq": LAYERS * steps, "flash_bwd_dkv": LAYERS * steps}
    check(r["launched"] == want, f"phase 2 binned remat: launches "
          f"{r['launched']}, want {want}")
    for k, v in r["launched"].items():
        total[k] += v
    lines.append(f"--phase2 --binned --remat B={P2_B}, {steps} steps at "
                 f"bucket lengths {buckets}: loss "
                 + " ".join(f"{x:.4f}" for x in r["losses"])
                 + f"; steps {' '.join(f'{x:.1f}' for x in r['step_ms'])} ms; "
                 f"peak {r['peak_gb']:.2f} GB; per step K1 "
                 f"{2 * LAYERS} ({LAYERS} + {LAYERS} recomputed), K2 "
                 f"{r['launched']['flash_bwd_dq'] // steps}+"
                 f"{r['launched']['flash_bwd_dkv'] // steps}")
    del r

    # the plain attention path
    r = _cli_run(["bert-pretrain", *corpus, "--attention-impl", "xla",
                  "--batch-size", str(TB), "--seq-len", str(TS), "--lr",
                  PRETRAIN_LR, "--steps-per-epoch", str(steps)], work / "xla")
    check(len(r["losses"]) == steps and all(map(math.isfinite, r["losses"])),
          f"xla: losses {r['losses']}")
    check(r["launched"] == dict.fromkeys(r["launched"], 0),
          f"xla: launches {r['launched']}, want none")
    lines.append(f"--attention-impl xla B={TB} S={TS}, {steps} steps: loss "
                 + " ".join(f"{x:.4f}" for x in r["losses"])
                 + f"; median step {statistics.median(r['step_ms'][1:]):.1f} "
                 f"ms; launches {r['launched']}")
    del r

    # the host time to make a batch, plain and binned
    host = {}
    for name, binned, b, s, p in (("plain b64 s128", False, TB, TS, 20),
                                  ("binned b64 s128", True, TB, TS, 20),
                                  ("binned b16 s512", True, P2_B, 512, 76)):
        cfg = cli_main.BertCliConfig(data_backend="corpus", data_dir=shards,
                                     batch_size=b, seq_len=s,
                                     max_predictions=p, binned=binned,
                                     mode="benchmark-training",
                                     steps_per_epoch=20)
        loader, _ = cli_main._corpus_loaders(cfg,
                                             BERT_CONFIGS["large"].vocab_size)
        t1 = time.perf_counter()
        n = sum(1 for _ in loader)
        host[name] = (time.perf_counter() - t1) * 1e3 / n
    lines.append("host time to make a batch: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in host.items()))

    shutil.rmtree(work, ignore_errors=True)
    say("24c corpus", f"bert-pretrain BERT-Large bf16 on a written corpus "
        "through the CLI: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return total


def _distill_train(task, teacher, student, lr=1e-4):
    """(train step, state) of ``task``'s hidden-state loss under AdamW."""
    params = dict(student.named_parameters())
    tx = adamw(lr, weight_decay=0.01)
    state = create_train_state(student, tx, SEED, params=params)
    return make_train_step(task.loss_fn(teacher), tx), state


def phase_distill() -> str:
    """24d: one distillation step (hidden MSE, AdamW) of the 4l-312 and
    6l-768 students under a BERT-Large teacher (``DISTILL_TEACHER_LAYERS``
    of its layers) at B=32 S=128 bf16, timed;
    the same loss and gradients at B=2 in fp32 (dropout off) on the card
    against the CPU in float64."""
    t0 = time.perf_counter()
    tcfg = dataclasses.replace(BERT_CONFIGS["large"],
                               num_layers=DISTILL_TEACHER_LAYERS)
    t_init = BertModel(tcfg)
    init_bert_weights_(t_init, torch.Generator().manual_seed(SEED),
                       tcfg.initializer_range)
    t_sd = t_init.state_dict()
    batch = {k: torch.from_numpy(v) for k, v in _pretrain_batch(
        DISTILL_B, TS, 20).items() if k in INPUTS}
    small = {k: v[:2] for k, v in batch.items()}
    lines = []
    for name in ("4l-312", "6l-768"):
        scfg = STUDENT_CONFIGS[name]
        # bf16, timed
        task = DistillationTask(tcfg, scfg, torch.bfloat16)
        teacher = task.teacher(DEV)
        teacher.load_state_dict(t_sd)
        student = task.init(torch.Generator().manual_seed(SEED + 1), DEV)
        step, state = _distill_train(task, teacher, student)
        dev_batch = {k: v.to(DEV) for k, v in batch.items()}
        before = dict(_counts())
        ms = []
        for _ in range(DISTILL_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, dev_batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        n = {k: (v - before[k]) // DISTILL_STEPS for k, v in _counts().items()}
        check(n["flash_fwd"] == tcfg.num_layers + scfg.num_layers
              and n["flash_bwd_dq"] == scfg.num_layers
              and n["flash_bwd_dkv"] == scfg.num_layers,
              f"{name}: launches a step {n}")
        check(math.isfinite(float(m["loss"])), f"{name}: loss {m['loss']}")
        bf16_loss = float(m["loss"])
        del teacher, student, state, step
        # fp32 on the card against float64 on the CPU, dropout off
        scfg0 = dataclasses.replace(scfg, hidden_dropout=0.0,
                                    attention_dropout=0.0)
        task = DistillationTask(tcfg, scfg0, torch.float32)
        s_init = task.init(torch.Generator().manual_seed(SEED + 1), "cpu")
        got = []
        for dev, f64 in ((DEV, False), ("cpu", True)):
            teacher = BertModel(tcfg, torch.float32)
            teacher.load_state_dict(t_sd)
            student = copy.deepcopy(s_init)
            if f64:
                teacher, student = _float64(teacher), _float64(student)
            teacher.to(dev).requires_grad_(False)
            student.to(dev)
            loss, _ = task.loss_fn(teacher)(
                student, {}, {k: v.to(dev) for k, v in small.items()},
                torch.Generator())
            loss.backward()
            got.append((float(loss), {n: p.grad.detach().cpu().double()
                                      for n, p in student.named_parameters()
                                      if p.grad is not None}))
            del teacher, student
        (l32, g32), (l64, g64) = got
        top = max(float(g.abs().max()) for g in g64.values())
        worst, wname = max((float((g32[k] - g).abs().max()) / top, k)
                           for k, g in g64.items())
        rel = abs(l32 - l64) / abs(l64)
        lines.append(f"{name} (head dim {scfg.head_dim}): bf16 B={DISTILL_B} "
                     f"S={TS} step {statistics.median(ms[1:]):.1f} ms median, "
                     f"{min(ms[1:]):.1f} least (host clock), loss "
                     f"{bf16_loss:.6f}, per step K1 {n['flash_fwd']} K2 "
                     f"{n['flash_bwd_dq']}+{n['flash_bwd_dkv']}; fp32 B=2 card "
                     f"vs float64 CPU: loss {l32:.8f} vs {l64:.8f} ({rel:.2e}), "
                     f"worst gradient {wname} {worst:.2e} of the largest entry")
        check(rel <= TOL_DISTILL["loss"], f"{name}: loss {l32} vs {l64}")
        check(worst <= TOL_DISTILL["grad"], f"{name}: gradient {wname} "
              f"{worst:.3e} of the largest entry")
    say("24d distillation", f"BERT-Large teacher at {tcfg.num_layers} of "
        "its 24 layers, hidden MSE through "
        "distill_proj, AdamW: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return "; ".join(lines)


def phase_dlrm_binary() -> int:
    """24e: ``dlrm --data-backend binary`` through the CLI's runner at
    B=65,536 on a Criteo binary set the phase writes (26 unequal tables,
    2.6M rows in all, 4M records): 20 steps at lr 0.1, AUC over the trailing
    2%, the step time beside the synthetic backend's. Returns K4's
    launches."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "criteo"
    shutil.rmtree(work, ignore_errors=True)
    t1 = time.perf_counter()
    criteo.write_synthetic_dataset(
        str(work / "data"), criteo.FeatureSpec(
            categorical_cardinalities=list(DLRM_BIN_CARDS)),
        DLRM_BIN_ROWS, seed=SEED)
    write_s = time.perf_counter() - t1
    size_mb = sum(f.stat().st_size for f in (work / "data").iterdir()) / 1e6
    spec = criteo.FeatureSpec.from_yaml(str(work / "data" / "feature_spec.yaml"))
    check(sum(spec.categorical_cardinalities) == sum(DLRM_BIN_CARDS)
          and spec.categorical_cardinalities != list(DLRM_BIN_CARDS),
          f"the spec's cardinalities {spec.categorical_cardinalities}")
    n_eval = DLRM_BIN_ROWS - int(DLRM_BIN_ROWS * 0.98)
    eval_batches = -(-n_eval // DLRM_B)
    runs = {}
    for name, args in (
            ("binary", ["--data-backend", "binary", "--data-dir",
                        str(work / "data"), "--prof", str(DLRM_BIN_STEPS)]),
            ("synthetic", ["--steps-per-epoch", str(DLRM_BIN_STEPS)])):
        r = _cli_run(["dlrm", "--batch-size", str(DLRM_B), "--lr",
                      DLRM_LR_STABLE, *args], work / name)
        check(r["state"].step == DLRM_BIN_STEPS, f"dlrm {name}: "
              f"{r['state'].step} steps")
        losses = r["losses"]
        check(len(losses) == DLRM_BIN_STEPS and all(map(math.isfinite, losses)),
              f"dlrm {name}: losses {losses}")
        evals = eval_batches if name == "binary" else 5
        want = {**dict.fromkeys(r["launched"], 0),
                "gather_rows": DLRM_BIN_STEPS + evals}
        check(r["launched"] == want, f"dlrm {name}: launches {r['launched']}")
        check(len(r["val"]) == 1 and 0.0 <= r["val"][0]["val.auc"] <= 1.0,
              f"dlrm {name}: eval {r['val']}")
        r.pop("state")
        runs[name] = r
    shutil.rmtree(work, ignore_errors=True)
    say("24e DLRM binary", f"dlrm --data-backend binary, {len(DLRM_BIN_CARDS)} "
        f"tables of {min(DLRM_BIN_CARDS)}-{max(DLRM_BIN_CARDS)} rows "
        f"({sum(DLRM_BIN_CARDS)} in all, read in the spec's sorted key order), "
        f"{DLRM_BIN_ROWS} records ({size_mb:.0f} MB written in {write_s:.1f} "
        f"s), B={DLRM_B} bf16, lr {DLRM_LR_STABLE}, {DLRM_BIN_STEPS} steps "
        f"then the trailing {n_eval} records in {eval_batches} batches: "
        + "; ".join(
            f"{k}: loss {v['losses'][0]:.4f} -> {v['losses'][-1]:.4f}, "
            f"val.auc {v['val'][0]['val.auc']:.6f}, median step "
            f"{statistics.median(v['step_ms'][1:]):.2f} ms, data "
            f"{statistics.median(v['data_ms'][1:]):.2f} ms (the loop's host "
            f"clock), peak {v['peak_gb']:.2f} GB, run {v['wall']:.1f} s, K4 "
            f"{v['launched']['gather_rows']}" for k, v in runs.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    return runs["binary"]["launched"]["gather_rows"]


def phase_bert_data() -> tuple[float, float, dict[str, int]]:
    """Phase 24: this slice's kernels, remat, the corpus paths,
    distillation and DLRM's binary backend. Returns K1's and K2's worst
    errors against their plain versions and the main paths' launches."""
    fwd_err, bwd_err, _ = phase_bert_data_kernels()
    phase_remat()
    launched = phase_bert_corpus()  # counts set to 0 there
    phase_distill()
    launched["gather_rows"] += phase_dlrm_binary()  # counts set to 0 there
    return fwd_err, bwd_err, launched

# -- phase 25 ----------------------------------------------------------------

# 25a: K1/K2 at the speech models' shapes, (B, S, H, masked, dropout rate):
# FastPitch's one head of 64 over the runner's 32 symbols and 900 mel
# frames, with its attention dropout, and wav2vec2 BASE's 12 unmasked heads
# over one second's 49 frames, at the CLI's B=32
SPEECH_ATTN = {
    "fastpitch encoder": (32, 32, 1, True, 0.1),
    "fastpitch decoder": (32, 900, 1, True, 0.1),
    "wav2vec2": (32, 49, 12, False, 0.0),
}
# 25b: one fp32 step of each model at full width, B=2, on the card (TF32
# off, every hidden dropout at 0, the draws the same on both sides) against
# the same step on the CPU in float64: the loss to TOL_CONV["loss"]
# relative, each gradient to limits (of its own largest entry, or FLOOR
# times the largest of all where that is more; of the largest of all)
# fixed per model from the CPU's own fp32 step (PERF.md, PR 12); the bf16
# step is the control and must miss them
SPEECH_B = 2
FP_TEXT, FP_MEL = 32, 900  # the JAX runner's shapes
W2V_AUDIO = 16000  # one second: 49 frames
JASPER_FRAMES, JASPER_LABELS = 256, 32
# (loss relative; of a tensor's own largest entry, of the largest of all),
# between PR 12 run 1's readings (NVIDIA H100 80GB HBM3) of the card's fp32
# step and of the bf16 control: FastPitch 2.04e-6, 4.45e-7 (bf16 8.81e-2,
# 1.19e-2); HiFi-GAN's generator 5.14e-3, 5.00e-4 (2.35e-1, 1.39e-2) and
# discriminators 4.91e-3, 2.20e-4 (7.20e-2, 1.67e-3); wav2vec2 1.08e-4,
# 1.88e-6 (1.22, 1.55e-2); JASPER_10x5DR 2.25e-1, 1.25e-2 (1.32, 5.79e-1);
# QUARTZNET_15x5 4.62e-1, 2.38e-1 (2.51, 1.25), its loss 6.75e-5 from
# float64. The CPU's own fp32 steps read alike (QuartzNet 4.85e-1, 2.52e-1,
# its loss 9.1e-5): a training-mode BN at every layer over B=2 x 128 frames
# leaves the gradient badly conditioned, as ResNet-50's in phase 19
TOL_SPEECH = {"fastpitch": (1e-5, 1e-4, 1e-5),
              "hifigan generator": (1e-5, 3e-2, 3e-3),
              "hifigan discriminators": (1e-5, 3e-2, 1e-3),
              "wav2vec2": (1e-5, 1e-3, 1e-5),
              "jasper 10x5dr": (1e-5, 1.0, 5e-2),
              "quartznet 15x5": (5e-4, 1.0, 5e-1)}
# 25c: the four commands through the CLI's runners, bf16, B=32, 5 batches
# twice, at the JAX runners' fallback rates (without --lr each is 0.1)
SPEECH_CLI = {"fastpitch": "1e-3", "hifigan": "2e-4", "wav2vec2": "5e-4",
              "jasper": "1e-3"}
SPEECH_CLI_B = 32
# 25d: a request served in a batch of 1-8 against the same request alone,
# fp32: GEMMs of other shapes sum in another order
TOL_SPEECH_SERVED = 1e-4
SPEECH_REQUESTS = 8


def _speech_batch(kind: str) -> dict:
    """25b's batch for one model, numpy, from SEED."""
    rng = np.random.default_rng(SEED)
    b = SPEECH_B
    if kind == "fastpitch":
        return {"text": rng.integers(1, 148, (b, FP_TEXT)).astype(np.int32),
                "durations": rng.integers(1, 6, (b, FP_TEXT)).astype(np.int32),
                "pitch": rng.normal(size=(b, FP_TEXT)).astype(np.float32),
                "mel": rng.normal(size=(b, FP_MEL, 80)).astype(np.float32)}
    if kind.startswith("hifigan"):
        return {"mel": rng.normal(size=(b, 32, 80)).astype(np.float32),
                "audio": (0.3 * rng.normal(size=(b, 8192))).astype(np.float32)}
    if kind == "wav2vec2":
        return {"audio": (0.1 * rng.normal(size=(b, W2V_AUDIO))).astype(
                    np.float32),
                "mask": sample_spans_mask(rng, b, 49, 0.5, 10)}
    fpad = np.zeros((b, JASPER_FRAMES), np.float32)
    fpad[1, 200:] = 1.0
    labels = rng.integers(1, 29, (b, JASPER_LABELS)).astype(np.int32)
    lpad = np.zeros((b, JASPER_LABELS), np.float32)
    lpad[1, 20:], labels[1, 20:] = 1.0, 0
    return {"feats": rng.normal(size=(b, JASPER_FRAMES, 64)).astype(np.float32),
            "feat_paddings": fpad, "labels": labels, "label_paddings": lpad}


_HIFIGAN_PAIR: list = []  # 25b's fp32 generator and discriminators


def _speech_init(kind: str):
    """A full-width fp32 model on the CPU from SEED, every hidden dropout at
    0 (FastPitch keeps its attention dropout: K1's hash, seeded from the
    step's CPU generator, drops the same probabilities on both devices).
    HiFi-GAN's two networks are drawn once and copied."""
    gen = torch.Generator().manual_seed(SEED)
    if kind == "fastpitch":
        cfg = FastPitchConfig(dropout=0.0, predictor_dropout=0.0)
        return FastPitchTask(cfg, torch.float32).init(gen, "cpu")
    if kind.startswith("hifigan"):
        if not _HIFIGAN_PAIR:
            _HIFIGAN_PAIR.extend(HiFiGanTask(dtype=torch.float32).init(
                gen, "cpu"))
        return copy.deepcopy(_HIFIGAN_PAIR[0 if kind.endswith("generator")
                                           else 1])
    if kind == "wav2vec2":
        return Wav2Vec2Task(Wav2Vec2Config(dropout=0.0),
                            torch.float32).init(gen, "cpu")
    cfg = JASPER_10x5DR if kind == "jasper 10x5dr" else QUARTZNET_15x5
    cfg = dataclasses.replace(cfg, blocks=tuple(
        dataclasses.replace(b, dropout=0.0) for b in cfg.blocks))
    return JasperTask(cfg, torch.float32).init(gen, "cpu")


def _speech_grads(kind: str, model, batch: dict, device, draws: dict) -> dict:
    """The loss and every gradient of one step of ``model`` (moved to
    ``device``, in its own compute dtype), on the CPU. The HiFi-GAN
    generator's step runs against the fp32 discriminators of 25b (on
    ``device``, their weights fixed) and theirs against the fp32 generator."""
    model = model.to(device).train()
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(SEED)
    params = dict(model.named_parameters())
    if kind.startswith("hifigan"):
        task = HiFiGanTask(dtype=model.dtype if kind.endswith("generator")
                           else torch.float32)
        other = _speech_init("hifigan discriminators" if kind.endswith(
            "generator") else "hifigan generator")
        other = (_float64(other) if model.dtype == torch.float64 else other)
        other = other.to(device).train()
        if kind.endswith("generator"):
            loss, _ = task.g_loss(model, other, t)
        else:
            loss = task.d_loss(other, model, t)
    elif kind == "fastpitch":
        task = FastPitchTask(model.cfg, model.dtype)
        loss, _ = task.loss_fn(model, {}, t, gen)
    elif kind == "wav2vec2":
        task = Wav2Vec2Task(model.cfg, model.dtype)
        with mock.patch.object(task, "draws", lambda *a: {
                k: v.to(device) for k, v in draws.items()}):
            loss, _ = task.loss_fn(model, {}, t, gen)
    else:
        task = JasperTask(model.cfg, model.dtype)
        loss, _ = task.loss_fn(model, task.model_state(model), t, gen)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {"loss": float(loss.detach()),
            "grads": {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
                      for (n, p), g in zip(params.items(), grads)}}


def _speech_reference(kind: str):
    """25b's batch, draws and weights for one model, and its float64 step
    on the CPU, started on the host thread (``_HOST``) beside 25c-e."""
    batch = _speech_batch(kind)
    draws = Wav2Vec2Task().draws(torch.Generator().manual_seed(SEED), SPEECH_B,
                                 49, "cpu") if kind == "wav2vec2" else {}
    init = _speech_init(kind)
    return batch, draws, init, _HOST.submit(
        _speech_grads, kind, _float64(copy.deepcopy(init)), batch, "cpu",
        draws)


def _speech_parity(kind: str, ref) -> None:
    """25b for one model, on its ``_speech_reference``."""
    t0 = time.perf_counter()
    batch, draws, init, f64 = ref
    gpu = _speech_grads(kind, copy.deepcopy(init), batch, DEV, draws)
    b16 = _speech_grads(kind, _s2s_copy(init, torch.bfloat16), batch, DEV,
                        draws)
    f64 = f64.result()
    del init
    loss_lim, *lim = TOL_SPEECH[kind]
    g64 = f64["grads"]
    g_rel, w16 = (_worst(x["grads"], g64) for x in (gpu, b16))
    rel_loss = abs(gpu["loss"] - f64["loss"]) / abs(f64["loss"])
    say("25 speech", f"parity: {kind} B={SPEECH_B}: one fp32 step, card vs "
        f"CPU float64: loss {gpu['loss']:.7f} vs {f64['loss']:.7f} "
        f"({rel_loss:.2e}, limit {loss_lim:.0e}); worst gradients: "
        f"{_fmt(g_rel)} (limits {lim[0]:.0e}, {lim[1]:.0e}); bf16 card step "
        f"(the control): loss "
        f"{b16['loss']:.6f}, worst gradients {_fmt(w16)} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(rel_loss <= loss_lim, f"{kind} fp32 loss: card "
          f"{gpu['loss']} vs CPU float64 {f64['loss']}")
    check(_within(g_rel, lim), f"{kind} fp32 gradients: {g_rel}")
    check(math.isfinite(b16["loss"]) and not _within(w16, lim),
          f"{kind}: the bf16 control meets the fp32 limits: {b16['loss']} {w16}")


def phase_speech_parity(refs: dict) -> None:
    """25b on each model's ``_speech_reference``: every model runs before
    the first failure is raised."""
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    failed = []
    try:
        for kind in TOL_SPEECH:
            try:
                _speech_parity(kind, refs[kind])
            except AssertionError as e:
                failed.append(str(e))
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
        _HIFIGAN_PAIR.clear()
    check(not failed, "; ".join(failed))


def phase_speech_kernels() -> tuple[float, float]:
    """25a: K1 and K2 against their plain versions at the speech shapes in
    bf16 and fp32, with bf16 times. Returns the worst K1 out error and K2
    error (max abs)."""
    t0 = time.perf_counter()
    worst_fwd = worst_bwd = 0.0
    lines = []
    for name, (b, s, h, masked, rate) in SPEECH_ATTN.items():
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            e_out, rel, e_bwd = _s2s_attn_case(b, s, s, h, False, masked,
                                               dtype, rate, seed=-7)
            worst_fwd, worst_bwd = max(worst_fwd, e_out), max(worst_bwd, e_bwd)
            errs.append(f"{'fp32' if dtype == torch.float32 else 'bf16'} "
                        f"{e_out:.2e}/{rel:.2e}")
        lines.append(f"{name} (B={b} S={s} H={h}{' masked' if masked else ''}"
                     f"{f' dropout {rate}' if rate else ''}): K1 out err / K2 "
                     f"err of its largest {', '.join(errs)}; bf16 "
                     + _s2s_time(b, s, s, h, False, masked, rate, seed=-7)
                     + "; K2 (no dropout) " + _fmt_bwd_times(
                         _time_bwd(b, s, h, D, "bshd", masked=masked)))
    say("25 speech", "K1/K2 at the slice's shapes vs plain (D=64, bshd): "
        + "; ".join(lines) + " (CUDA events, least of 2 (K2: 3) in turns; "
        f"[the card's clock alone]; {time.perf_counter() - t0:.1f} s)")
    return worst_fwd, worst_bwd


def _speech_cli(name: str, work: Path) -> tuple[dict, list, list, Any, float]:
    """One command through the CLI's runner at B=32, 10 steps, with the
    counts set to 0 just before it: (launches, the raport's LOG data,
    host-clock step times, what the runner returned, seconds)."""
    ws = work / name
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # this path starts here
    t0 = time.perf_counter()
    out = cli([name, "--batch-size", str(SPEECH_CLI_B), "--steps-per-epoch",
               "5", "--epochs", "2", "--lr", SPEECH_CLI[name], "--workspace",
               str(ws)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _counts()
    data = _raport_data(ws / f"{name}_raport.json")
    shutil.rmtree(ws, ignore_errors=True)
    times = [d["train.compute_time"] for d in data if "train.compute_time" in d]
    return launched, data, times, out, wall


def phase_speech() -> dict[str, int]:
    """25c: fastpitch, hifigan, wav2vec2 and jasper through the CLI's runners
    in bf16; returns the kernels' launches on these paths."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "speech"
    total = dict.fromkeys(_counts(), 0)
    lines = []
    k12 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for name in SPEECH_CLI:
        launched, data, times, out, wall = _speech_cli(name, work)
        others = {k: v for k, v in launched.items() if k not in k12}
        check(others == dict.fromkeys(others, 0),
              f"{name}: K3-K6 launched {launched}")
        attention = name in ("fastpitch", "wav2vec2")
        want = 12 * 10 if attention else 0
        check(all(launched[k] == want for k in k12),
              f"{name}: K1/K2 launches {launched}, want {want} each")
        if name == "hifigan":
            d_loss = [d["train.d_loss"] for d in data if "train.d_loss" in d]
            g_loss = [d["train.g_loss"] for d in data if "train.g_loss" in d]
            check(len(d_loss) == 2 and all(map(math.isfinite, d_loss + g_loss)),
                  f"hifigan: d {d_loss} g {g_loss}")
            lines.append(f"hifigan B={SPEECH_CLI_B} lr 2e-4, 10 d_step + g_step "
                         f"pairs: d_loss {d_loss[0]:.4f} -> {d_loss[-1]:.4f}, "
                         f"g_loss {g_loss[0]:.4f} -> {g_loss[-1]:.4f}, mel_l1 "
                         f"{out[2]['train.mel_l1']:.4f}; {wall:.1f} s for the "
                         f"run, init included ({wall / 10 * 1e3:.0f} ms a pair "
                         "at most); launches 0")
            continue
        losses = [d["train.loss"] for d in data if "train.loss" in d]
        check(len(losses) == 10 and all(map(math.isfinite, losses)),
              f"{name}: losses {losses}")
        if name in ("fastpitch", "jasper"):
            check(losses[-1] < losses[0], f"{name}: losses {losses}")
        med = statistics.median(times[2:])
        lines.append(f"{name} B={SPEECH_CLI_B} lr {SPEECH_CLI[name]}, 10 "
                     f"steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; median "
                     f"step over steps 3-10 {med * 1e3:.1f} ms (host clock); "
                     f"launches {launched['flash_fwd']} K1, "
                     f"{launched['flash_bwd_dq']} + "
                     f"{launched['flash_bwd_dkv']} K2")
        for k, v in launched.items():
            total[k] += v
    shutil.rmtree(work, ignore_errors=True)
    say("25 speech", f"commands on {card()}, bf16: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return total


def _serve_speech(ep, reqs: list[dict]) -> tuple[list, int, dict]:
    """``reqs`` sent at once, binary, to ``ep`` behind the HTTP server, with
    the counts set to 0 just before: (answers, K1 launches, the batcher's
    stats)."""
    ep.batcher.warmup(reqs[0])  # first launches before serving
    server = InferenceServer("127.0.0.1", 0)
    server.register(ep)
    server.start()
    try:
        results, errors = [None] * len(reqs), []

        def client(i):
            try:
                results[i] = http_infer(server.addr, ep.name, reqs[i],
                                        binary=True)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        _reset_counts()  # the serving path starts here
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launched = _counts()
        check(not any(t.is_alive() for t in threads), f"{ep.name}: hung")
        if errors:
            raise errors[0]
        stats = ep.batcher.stats()
    finally:
        server.stop()
    others = {k: v for k, v in launched.items() if k != "flash_fwd"}
    check(others == dict.fromkeys(others, 0), f"{ep.name}: {launched}")
    return [r["outputs"] for r in results], launched["flash_fwd"], stats


def phase_speech_serving() -> int:
    """25d: FastPitch -> HiFi-GAN and Jasper behind the HTTP server, fp32 at
    full width, each answer against a direct call of the endpoint's function
    on that request alone; returns K1's launches."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator().manual_seed(SEED)
    fp_task, hifi_task = FastPitchTask(dtype=torch.float32), \
        HiFiGanTask(dtype=torch.float32)
    fp = fp_task.init(gen, DEV)
    with torch.no_grad():  # about 4 frames a symbol, not 0
        fp.duration_predictor.fc.bias.fill_(math.log(5.0))
    hifi, _ = hifi_task.init(gen, DEV)
    ep = speech_recipes.fastpitch_hifigan_endpoint(fp_task, fp, hifi_task,
                                                   hifi)
    reqs = []
    for _ in range(SPEECH_REQUESTS):
        text = np.zeros(128, np.int32)
        n = int(rng.integers(16, 129))
        text[:n] = rng.integers(1, 148, n)
        reqs.append({"text": text})
    answers, launched, stats = _serve_speech(ep, reqs)
    worst = 0.0
    lens = []
    for req, ans in zip(reqs, answers):
        want = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)[0] for k, v
                in ep.batcher.infer_fn({"text": req["text"][None]}).items()}
        got = {k: np.asarray(ans[k]) for k in ("audio", "audio_len", "mel_len")}
        check(got["audio"].shape == (832 * 256,), f"audio {got['audio'].shape}")
        check(int(got["mel_len"]) == int(want["mel_len"])
              and int(got["audio_len"]) == int(got["mel_len"]) * 256,
              f"mel_len {got['mel_len']} vs {want['mel_len']}, audio_len "
              f"{got['audio_len']}")
        worst = max(worst, float(np.abs(got["audio"] - want["audio"]).max()))
        lens.append(int(got["mel_len"]))
    check(worst <= TOL_SPEECH_SERVED, f"tts served vs direct: {worst:.3e}")
    check(launched == 12 * stats["dispatches"] and launched > 0,
          f"tts: {launched} K1 launches for {stats['dispatches']} dispatches")
    line = (f"fastpitch_hifigan_endpoint, {SPEECH_REQUESTS} requests of 16-128 "
            f"symbols: mel_len {min(lens)}-{max(lens)} (audio_len = mel_len x "
            f"256), max abs err vs direct {worst:.2e}; dispatches "
            f"{stats['dispatches']}, mean_batch {stats['mean_batch']:.2f}, "
            f"device_ms p50 {stats['device_ms_p50']:.1f}; K1 {launched}")
    del ep, fp, hifi

    j_task = JasperTask(dtype=torch.float32)
    model = j_task.init(gen, DEV)
    ep = speech_recipes.jasper_offline_endpoint(j_task, model)
    reqs = [{"feats": rng.normal(size=(512, 64)).astype(np.float32),
             "feat_len": np.array([int(rng.integers(64, 513))], np.int32)}
            for _ in range(SPEECH_REQUESTS)]
    answers, j_launched, stats = _serve_speech(ep, reqs)
    n_tokens = []
    for req, ans in zip(reqs, answers):
        want = ep.batcher.infer_fn({k: v[None] for k, v in req.items()})
        check(np.array_equal(np.asarray(ans["tokens"]), want["tokens"][0])
              and np.array_equal(np.asarray(ans["n_tokens"]),
                                 want["n_tokens"][0]),
              f"jasper tokens {ans['n_tokens']} vs {want['n_tokens'][0]}")
        n_tokens.append(int(want["n_tokens"][0, 0]))
    check(j_launched == 0, f"jasper endpoint launched K1 {j_launched}")
    say("25 speech", f"serving on {card()}: {line}; jasper_offline_endpoint, "
        f"{SPEECH_REQUESTS} requests of 64-512 valid frames: tokens equal to "
        f"the direct calls', {min(n_tokens)}-{max(n_tokens)} a request; "
        f"dispatches {stats['dispatches']}, device_ms p50 "
        f"{stats['device_ms_p50']:.1f}; K1-K6 0 "
        f"({time.perf_counter() - t0:.1f} s)")
    return launched


def phase_speech_ctc() -> dict[str, int]:
    """25e: one bf16 ``Wav2Vec2CtcTask`` step at B=4 on the card, then its
    log-probabilities greedily decoded; returns the launches."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    task = Wav2Vec2CtcTask(dtype=torch.bfloat16)
    model = task.init(torch.Generator().manual_seed(SEED), DEV)
    b, frames = 4, 49
    fpad = np.zeros((b, frames), np.float32)
    lpad = np.zeros((b, 12), np.float32)
    labels = rng.integers(1, task.vocab_size, (b, 12)).astype(np.int32)
    for i, (f, n) in enumerate(zip((49, 40, 30, 20), (12, 8, 6, 4))):
        fpad[i, f:], lpad[i, n:], labels[i, n:] = 1.0, 1.0, 0
    batch = {"audio": (0.1 * rng.normal(size=(b, W2V_AUDIO))).astype(np.float32),
             "frame_paddings": fpad, "labels": labels, "label_paddings": lpad}
    t = {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}
    tx = adamw(5e-5, weight_decay=0.01)
    state = create_train_state(model, tx, SEED)
    _reset_counts()  # this path starts here
    state, m = make_train_step(task.loss_fn, tx)(state, t)
    with torch.no_grad():
        logp = model(t["audio"])
    decoded = greedy_ctc_decode(logp.float().cpu().numpy())
    torch.cuda.synchronize()
    launched = _counts()
    check(math.isfinite(float(m["loss"])), f"wav2vec2 ctc loss {m['loss']}")
    check(logp.shape == (b, frames, task.vocab_size)
          and bool(torch.isfinite(logp).all()), f"logp {logp.shape}")
    check(len(decoded) == b and all(0 <= x < task.vocab_size
                                    for row in decoded for x in row),
          f"decoded {decoded}")
    check(launched == {**dict.fromkeys(launched, 0), "flash_fwd": 24,
                       "flash_bwd_dq": 12, "flash_bwd_dkv": 12},
          f"wav2vec2 ctc launches {launched}")
    say("25 speech", f"Wav2Vec2CtcTask bf16 B={b}: loss {float(m['loss']):.4f}, "
        f"grad_norm {float(m['grad_norm']):.4f}; greedy decode of the eval "
        f"forward: {[len(r) for r in decoded]} tokens; launches {launched} "
        f"({time.perf_counter() - t0:.1f} s)")
    return launched


def phase_speech_all() -> tuple[float, float, dict[str, int]]:
    """Phase 25: (the worst K1 and K2 errors, the launches of the main
    paths 25c-e)."""
    fwd, bwd = phase_speech_kernels()
    # the float64 references of 25b on the host thread, beside 25c-e
    refs = {kind: _speech_reference(kind) for kind in TOL_SPEECH}
    launched = phase_speech()
    launched["flash_fwd"] += phase_speech_serving()
    for k, v in phase_speech_ctc().items():
        launched[k] += v
    phase_speech_parity(refs)
    return fwd, bwd, launched


# -- phase 26 ----------------------------------------------------------------

FIXTURES = ROOT / "tests" / "data" / "jpeg"
# The card's decode (nvJPEG, then the resample kernel) against JAX's plane
# (libjpeg, JDCT_IFAST, DCT-domain downscale; expected.npz), in pixel levels
# (0-255) of the normalized outputs times std: (most, mean). Set before the
# first run on the card from what two decoders can differ by on smooth
# images: libjpeg's ISLOW with fancy upsampling against IFAST, with the block
# mean in place of the 1/d decode, reads 3.14 and 1.02 on the CPU
# (tests/test_torch_dataplane.py); nvJPEG's IDCT and chroma upsampling are
# neither.
TOL_DECODE = (8.0, 1.5)
RD_B, RD_STEPS = 256, 3  # the data plane's batch (26a); SSD300's steps (26c)
# 26b: ResNet-50 on the ImageNet-sized fixtures (500 x 375 and 375 x 500,
# about 11 kB each), RD_RN50_STEPS steps timed from the third, beside the
# synthetic loader in the same phase
RD_RN50_STEPS = 8
IMAGENET_SIZED = ("landscape_500x375", "portrait_375x500")
RD_SSD_B = 128  # SSD300 on COCO-format data (26c)
GPUNET_B, GPUNET_STEPS = 32, 3  # 26d through the CLI, bf16
GPUNET_PARITY_B, GPUNET_PARITY_SIZE = 2, 320
DET_SIZE, DET_PARITY_B, DET_B, DET_STEPS, DET_PREDICT_B = 512, 2, 16, 3, 8
DET_LR = "0.01"
# EfficientDet-D0's fp32 step on the card against float64 on the CPU: phase
# 19's limits for a training-mode step (of each tensor's own largest entry,
# of the largest of all), the loss to 1e-5
TOL_DET = {"loss": 1e-5, "step": (1e-1, 1e-2), "stats": 1e-4}
RN50_SYNTHETIC = {}  # phase 20's ResNet-50 img/s, where it ran before


def _probe() -> str:
    """What the host offers the data plane: libjpeg's header and library,
    nvJPEG's, the cores, g++."""
    def has(path):
        return "yes" if Path(path).exists() else "no"

    libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                          timeout=60).stdout
    found = sorted({line.split()[0] for line in libs.splitlines()
                    if "libjpeg" in line or "libnvjpeg" in line})
    gxx = shutil.which("g++")
    ver = (subprocess.run([gxx, "--version"], capture_output=True, text=True,
                          timeout=60).stdout.splitlines()[0] if gxx else "none")
    return (f"/usr/include/jpeglib.h {has('/usr/include/jpeglib.h')}, "
            f"nvjpeg.h {has(Path(_build.nvcc()).parent.parent / 'include' / 'nvjpeg.h')}"
            f", libraries {', '.join(found) or 'none'}; nproc "
            f"{os.cpu_count()}; g++ {ver}")


def _fixtures() -> tuple[list[bytes], dict]:
    e = np.load(FIXTURES / "expected.npz")
    blobs = [(FIXTURES / f"{n}.jpg").read_bytes() for n in e["names"]]
    return blobs, e


def phase_dataplane() -> dict:
    """26a: the card's data plane on the fixtures against JAX's
    (expected.npz), the resample kernel against its plain version at the
    main path's shapes (B=256 at 224), and the decode rate."""
    t0 = time.perf_counter()
    say("26a data plane", f"probe: {_probe()}; the card's plane: nvJPEG "
        "(csrc/nvjpeg_decode.cu) and the resample kernel "
        "(csrc/resample_normalize.cu)")
    plane = DataPlane(os.cpu_count(), "cuda")
    blobs, e = _fixtures()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        got = plane.decode_batch(blobs, e["crops"], e["flips"],
                                 int(e["out_size"])).cpu().numpy()
    levels = np.abs(got - e["images"]) * np.float32(STD) * 255
    per = {n: (float(lv.max()), float(lv.mean()))
           for n, lv in zip(e["names"], levels)}
    zero = [n for n, g in zip(e["names"], got) if not g.any()]
    check(zero == [n for n, f in zip(e["names"], e["failed"]) if f]
          and any("failed to decode" in str(w.message) for w in warned),
          f"zero-filled {zero}, expected {e['failed']}")
    most, mean = float(levels.max()), float(levels.mean())
    # the fixtures again as a batch of RD_B, the main path's batch (each
    # decoder state decodes about RD_B / nproc images in turn), each image
    # held to its expected.npz entry and to its decode in the call above
    idx = np.arange(RD_B) % len(blobs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the cut file, as above
        big = plane.decode_batch([blobs[i] for i in idx], e["crops"][idx],
                                 e["flips"][idx],
                                 int(e["out_size"])).cpu().numpy()
    big_lv = (np.abs(big - e["images"][idx]) * np.float32(STD) * 255
              ).reshape(RD_B, -1)
    big_most, big_mean = big_lv.max(1), big_lv.mean(1)
    big_vs_small = float(np.abs(big - got[idx]).max())
    check(bool((big_most <= TOL_DECODE[0]).all()
               and (big_mean <= TOL_DECODE[1]).all()) and big_vs_small == 0.0,
          f"a batch of {RD_B} fixtures vs expected.npz: worst {big_most.max()}"
          f", mean {big_mean.max()}; vs the 14-image call {big_vs_small}")
    # the main path's batch: 256 fixtures at 224, RRC-like crops, flips
    jpegs = [b for b, f in zip(blobs, e["failed"]) if not f]
    rng = np.random.default_rng(SEED)
    batch = [jpegs[i % len(jpegs)] for i in range(RD_B)]
    crops = np.stack([rng.uniform(0, .3, RD_B), rng.uniform(0, .3, RD_B),
                      rng.uniform(.4, .7, RD_B), rng.uniform(.4, .7, RD_B)],
                     1).astype(np.float32)
    flips = rng.integers(0, 2, RD_B).astype(np.int32)
    src, offsets, dims, n_failed = plane._impl.decode(batch, crops, 224)
    check(n_failed == 0, f"nvJPEG failed on {n_failed} fixtures")
    args = (src, offsets, dims, torch.from_numpy(crops).to(DEV),
            torch.from_numpy(flips).to(DEV), 224, MEAN, STD)
    before = resample.launches
    out = resample.resample_normalize(*args)
    want = resample.resample_normalize_reference(*args)
    err = max_err(out, want)
    check(resample.launches == before + 1 and err == 0.0,
          f"resample_normalize vs its plain version: {err}")
    ms = _event_ms(lambda: resample.resample_normalize(*args), 50)
    plain_ms = _event_ms(lambda: resample.resample_normalize_reference(*args),
                         3)
    # the bytes the call needs: each image's crop of its decoded pixels
    # (whole d x d blocks), read once, and the fp32 output written once;
    # about 12 fp32 operations a channel of an output pixel
    need = sum(float(c[2] * c[3]) * int(d[0]) * int(d[1]) * int(d[2])
               for c, d in zip(crops, dims.cpu().numpy()))
    out_bytes = RD_B * 224 * 224 * 3 * 4
    bound, by = _bound(need + out_bytes, RD_B * 224 * 224 * 3 * 12,
                       torch.float32)
    # the decode rate at 224, the whole call (header parse, nvJPEG, kernel),
    # on the few-kB fixtures and on the two ImageNet-sized ones
    sized = [(FIXTURES / f"{n}.jpg").read_bytes() for n in IMAGENET_SIZED]
    rates = {}
    for what, jp in (("fixtures", batch),
                     ("500x375", [sized[i % 2] for i in range(RD_B)])):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            plane.decode_batch(jp, crops, flips, 224)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        rates[what] = RD_B / statistics.median(times[1:])
    pixels = float((dims[:, 0].double() * dims[:, 1]).mean())
    kb = sum(len(b) for b in batch) / len(batch) / 1e3
    say("26a data plane", f"fixtures on the card vs JAX's plane "
        f"(expected.npz, {len(blobs)} JPEGs at {int(e['out_size'])}): worst "
        f"{most:.2f} pixel levels, mean {mean:.3f} (limits {TOL_DECODE[0]}, "
        f"{TOL_DECODE[1]}); per image (most, mean): "
        + ", ".join(f"{n} {a:.2f}/{b:.3f}" for n, (a, b) in per.items())
        + f"; zero-filled with a warning: {zero}. The same as one batch of "
        f"{RD_B}: every image within the limits (worst {big_most.max():.2f}, "
        f"worst image mean {big_mean.max():.3f}), equal to the 14-image "
        f"call's (max abs {big_vs_small}). resample_normalize at "
        f"B={RD_B} 224 vs its plain version on the card: max abs err {err}; "
        f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound:.4f} ms by "
        f"{by}). Decode rate at 224 with {os.cpu_count()} threads, median "
        f"of 4 batches of {RD_B}: the few-kB fixtures {rates['fixtures']:.1f}"
        f" img/s ({pixels:.0f} pixels, {kb:.1f} kB an image on average), the "
        f"500 x 375 and 375 x 500 fixtures {rates['500x375']:.1f} img/s "
        f"({sum(map(len, sized)) / 2e3:.1f} kB an image; ImageNet's JPEGs "
        f"are larger files); on {card()}; {time.perf_counter() - t0:.1f} s")
    check(most <= TOL_DECODE[0] and mean <= TOL_DECODE[1],
          f"the card's decode vs expected.npz: {most}, {mean}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _zero_but_resample(launched: dict, what: str) -> int:
    """K1-K6 launched 0 times on a real-data path; the resample kernel's
    launches."""
    others = {k: v for k, v in launched.items() if k != "resample_normalize"}
    check(others == dict.fromkeys(others, 0),
          f"{what}: K1-K6 launched {others}")
    return launched["resample_normalize"]


def phase_imagenet(work: Path) -> int:
    """26b: ``resnet50 --data-backend imagenet`` at B=256 on an ImageFolder
    of hard links to the ImageNet-sized fixtures (RD_RN50_STEPS x 256
    training files, one val batch), and the synthetic loader for as many
    steps just before it; each step's wall time (the wait for its batch
    and its compute) from the third on."""
    jpegs = [FIXTURES / f"{n}.jpg" for n in IMAGENET_SIZED]
    root = imagenet_tree(jpegs, work / "imagenet", 4,
                         RD_RN50_STEPS * RD_B // 4, RD_B // 4)
    runs = {}
    for name, args in (("synthetic", ["--steps-per-epoch",
                                      str(RD_RN50_STEPS)]),
                       ("imagenet", ["--data-backend", "imagenet",
                                     "--data-dir", str(root)])):
        runs[name] = _cli_run(["resnet50", *args, "--batch-size", str(RD_B),
                               *CN_FLAGS], work / f"ws_rn50_{name}")
    check(runs["synthetic"]["launched"] == dict.fromkeys(
        runs["synthetic"]["launched"], 0),
          f"resnet50 synthetic: {runs['synthetic']['launched']}")
    run = runs["imagenet"]
    launched = _zero_but_resample(run["launched"], "resnet50 on ImageNet data")
    val = [v for v in run["val"] if "val.top1" in v]
    check(run["state"].step == RD_RN50_STEPS
          and len(run["losses"]) == RD_RN50_STEPS
          and all(math.isfinite(x) for x in run["losses"]) and len(val) == 1
          and launched == RD_RN50_STEPS + 1,
          f"resnet50 imagenet: {run['losses']}, {val}, {launched} resamples")
    walls = {k: statistics.median([c + d for c, d in zip(
        r["step_ms"][2:], r["waits_ms"][2:])]) for k, r in runs.items()}
    # the reader alone: the train split's batches made back to back with no
    # step between them (the first epoch fills the header cache, the second
    # is timed)
    loader = ImageNetLoader(str(root), "train", RD_B, device=DEV)
    for _ in loader:
        pass
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = sum(1 for _ in loader)
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t) * 1e3 / n
    # its parts, for one batch: the files read as the loader reads them,
    # then the plane's decode of those bytes at RRC crops and flips
    t = time.perf_counter()
    files = []
    for path, _ in loader.samples[:RD_B]:
        with open(path, "rb") as f:
            files.append(f.read())
    read_ms = (time.perf_counter() - t) * 1e3
    rng = np.random.default_rng(SEED)
    crops = np.asarray([sample_rrc_pixels(rng, *loader.plane.jpeg_info(b))
                        for b in files], np.float32)
    flips = rng.integers(0, 2, RD_B).astype(np.int32)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loader.plane.decode_batch(files, crops, flips, 224)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    decode_ms = min(times)
    del loader
    synth20 = RN50_SYNTHETIC.get("img/s")
    say("26b ResNet-50 on ImageNet-format data", f"B={RD_B} bf16, bench.py's "
        f"recipe, {RD_RN50_STEPS} steps on {RD_RN50_STEPS * RD_B} files (500 "
        f"x 375 and 375 x 500) and the val pass ({RD_B} files): loss "
        + " ".join(f"{x:.4f}" for x in run["losses"])
        + f"; val top1 {val[0]['val.top1']:.4f}; "
        + "; ".join(f"{k}: step {walls[k]:.2f} ms ({RD_B / walls[k] * 1e3:.1f}"
                    f" img/s; median over steps 3-{RD_RN50_STEPS} of the wait "
                    f"for the batch and the compute, host clock), waits "
                    + " ".join(f"{x:.1f}" for x in r["waits_ms"]) + " ms"
                    for k, r in runs.items())
        + f"; imagenet / synthetic {walls['synthetic'] / walls['imagenet']:.3f}"
        + f"; the reader alone {alone:.2f} ms a batch ({RD_B / alone * 1e3:.1f}"
          " img/s, the mean of an epoch of batches made back to back): "
          f"reading a batch's files {read_ms:.2f} ms, the plane's decode of "
          f"their bytes at RRC crops {decode_ms:.2f} ms (least of 3)"
        + "; phase 20's synthetic rate "
        + (f"{synth20:.1f} img/s in this run, {UNDER_LOAD}" if synth20 else
           "not measured in this run")
        + f"; resample_normalize launched {launched} times, K1-K6 0; peak "
        f"{run['peak_gb']:.2f} GB; runs {runs['synthetic']['wall']:.1f}, "
        f"{run['wall']:.1f} s; on {card()}")
    return launched


def phase_coco(work: Path) -> int:
    """26c: ``ssd300 --data-backend coco`` at B=128 on a COCO tree of the
    fixtures, 3 steps and one eval epoch with its mAP."""
    root = coco_tree(sorted(FIXTURES.glob("*.jpg")), work / "coco",
                     RD_STEPS * RD_SSD_B, RD_SSD_B, seed=SEED)
    run = _cli_run(["ssd300", "--data-backend", "coco", "--data-dir",
                    str(root), "--batch-size", str(RD_SSD_B), *SSD_FLAGS],
                   work / "ws_ssd")
    launched = _zero_but_resample(run["launched"], "ssd300 on COCO data")
    val = [v for v in run["val"] if "val.mAP" in v]
    check(run["state"].step == RD_STEPS and all(math.isfinite(x) for x in
                                               run["losses"])
          and len(val) == 1 and 0.0 <= val[0]["val.mAP"] <= 1.0
          and run["best"] == val[0]["val.mAP"] and launched == RD_STEPS + 1,
          f"ssd300 coco: {run['losses']}, {val}, {launched} resamples")
    say("26c SSD300 on COCO-format data", f"B={RD_SSD_B} bf16, "
        f"{RD_STEPS} steps on {RD_STEPS * RD_SSD_B} images (every 14th the "
        f"cut fixture, zero-filled) and the eval epoch on {RD_SSD_B}: loss "
        + " ".join(f"{x:.4f}" for x in run["losses"])
        + f"; val mAP {val[0]['val.mAP']:.5f} mAP50 "
        f"{val[0]['val.mAP50']:.5f} (watched, the best {run['best']:.5f}); "
        f"median step {statistics.median(run['step_ms'][1:]):.2f} ms; "
        f"resample_normalize launched {launched} times, K1-K6 0; run "
        f"{run['wall']:.1f} s")
    return launched


def phase_gpunet(work: Path) -> None:
    """26d: one fp32 full-width GPUNet-0 step on the card against float64
    on the CPU (phase 19's limits), then the three archs through the CLI in
    bf16, one of them with QAT."""
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    try:
        _convnet_parity("gpunet-0", GPUNET_PARITY_B, GPUNET_PARITY_SIZE,
                        "26d GPUNet")
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    lines = []
    for arch, extra in (("gpunet-0", []), ("gpunet-1", []), ("gpunet-2", []),
                        ("gpunet-1", QAT)):
        # GPUNet's head is not zero-initialised and its dropout scales by
        # 1 / 0.8: the first loss lies further above ln 1000 than ResNet's
        lines.append(_convnet_run(arch, GPUNET_B, GPUNET_STEPS, extra, work,
                                  loss0_tol=1.0)[0])
    say("26d GPUNet", "through the CLI (bf16, bench.py's ResNet-50 recipe, "
        "the 10-batch eval): " + "; ".join(lines)
        + f". K1-K6 and resample_normalize launched 0 times; "
        f"{time.perf_counter() - t0:.1f} s")


def _det_batch(b: int, seed: int = SEED) -> dict:
    return next(iter(SyntheticDetectionLoader(b, DET_SIZE, 90, max_gt=32,
                                              steps=1, seed=seed)))


def _det_step(model, batch: dict, device):
    """One step under the CLI's update (clip by global norm 10, then SGD
    with momentum 0.9 at lr 0.01): (loss, grads, deltas, BN buffers), on
    the CPU."""
    task = EfficientDetTask(EfficientDetConfig(image_size=DET_SIZE),
                            model.dtype)
    params = dict(model.named_parameters())
    tx = chain(clip_by_global_norm(10.0), sgd(float(DET_LR), 0.9))
    state = create_train_state(model, tx, SEED, params=params,
                               model_state=task.model_state(model))
    before = {n: p.detach().clone() for n, p in params.items()}
    dtype = next(model.parameters()).dtype
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    t["image"] = t["image"].to(dtype)
    t["boxes"] = t["boxes"].to(dtype)
    _, metrics = make_train_step(task.loss_fn, tx)(state, t)
    return (float(metrics["loss"]),
            {n: p.grad.detach().cpu() for n, p in params.items()},
            {n: (p.detach() - before[n]).cpu() for n, p in params.items()},
            {n: b.detach().cpu() for n, b in model.named_buffers()})


def phase_efficientdet(work: Path) -> int:
    """26e: one fp32 EfficientDet-D0 step at 512 on the card against
    float64 on the CPU; ``efficientdet`` through the CLI on synthetic
    batches and on a COCO tree with its val AP; ``predict`` at B=8 with its
    peak memory. Returns the resample kernel's launches."""
    t0 = time.perf_counter()
    init = EfficientDetTask(EfficientDetConfig(image_size=DET_SIZE),
                            torch.float32).init(
        torch.Generator().manual_seed(SEED), "cpu")
    _redraw_bn(init, torch.Generator().manual_seed(SEED + 1))
    batch = _det_batch(DET_PARITY_B)
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    try:
        l_gpu, g_gpu, d_gpu, s_gpu = _det_step(copy.deepcopy(init).to(DEV),
                                               batch, DEV)
        l64, g64, d64, s64 = _det_step(_float64(copy.deepcopy(init)), batch,
                                       "cpu")
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    g_rel, d_rel = _worst(g_gpu, g64), _worst(d_gpu, d64)
    st_rel = max((max_err(s_gpu[n], s64[n]) / max(float(s64[n].abs().max()),
                                                   1e-30), n) for n in s64)
    rel_loss = abs(l_gpu - l64) / abs(l64)
    parity = (f"EfficientDet-D0 {DET_SIZE} B={DET_PARITY_B}, one fp32 step "
              f"(clip 10, SGD lr {DET_LR} momentum 0.9), card vs CPU "
              f"float64: loss {l_gpu:.7f} vs {l64:.7f} ({rel_loss:.2e}); "
              f"worst gradients {_fmt(g_rel)}, updates {_fmt(d_rel)} (limits "
              f"{TOL_DET['step'][0]:.0e}, {TOL_DET['step'][1]:.0e}); BN "
              f"statistics worst {st_rel[1]} {st_rel[0]:.2e}")
    say("26e EfficientDet", parity)
    check(rel_loss <= TOL_DET["loss"] and _within(g_rel, TOL_DET["step"])
          and _within(d_rel, TOL_DET["step"])
          and st_rel[0] <= TOL_DET["stats"], parity)
    del init
    synth = _cli_run(["efficientdet", "--batch-size", str(DET_B),
                      "--steps-per-epoch", str(DET_STEPS), "--lr", DET_LR],
                     work / "ws_det")
    _zero_but_resample(synth["launched"], "efficientdet synthetic")
    check(synth["launched"]["resample_normalize"] == 0
          and synth["state"].step == DET_STEPS
          and all(math.isfinite(x) for x in synth["losses"]),
          f"efficientdet synthetic: {synth['losses']}")
    root = coco_tree(sorted(FIXTURES.glob("*.jpg")), work / "coco_det",
                     DET_STEPS * DET_B, DET_B, seed=SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the EfficientDet COCO path starts here
    ws = work / "ws_det_coco"
    state, _, val = cli(["efficientdet", "--data-backend", "coco",
                         "--data-dir", str(root), "--batch-size", str(DET_B),
                         "--lr", DET_LR, "--workspace", str(ws)])
    torch.cuda.synchronize()
    launched = _zero_but_resample(_counts(), "efficientdet on COCO data")
    losses, _ = _raport_losses_and_times(ws / "efficientdet_raport.json")
    shutil.rmtree(ws, ignore_errors=True)
    check(state.step == DET_STEPS and all(math.isfinite(x) for x in losses)
          and val is not None and 0.0 <= val["val.bbox_mAP"] <= 1.0
          and launched == DET_STEPS + 1,
          f"efficientdet coco: {losses}, {val}, {launched} resamples")
    model = state.model
    del state
    task = EfficientDetTask(EfficientDetConfig(image_size=DET_SIZE))
    images = torch.from_numpy(_det_batch(DET_PREDICT_B)["image"]).to(DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    boxes, scores, labels, valid = task.predict(model, images)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    n = task.anchors(DEV).shape[0]
    check(boxes.shape == (DET_PREDICT_B, 100, 4) and bool(valid.any())
          and bool(torch.isfinite(scores).all())
          and peak < n * n * 4 / 1e9, f"predict: peak {peak} GB")
    _zero_but_resample(_counts(), "efficientdet predict")
    say("26e EfficientDet", f"through the CLI (bf16, clip 10 + SGD lr "
        f"{DET_LR}): synthetic B={DET_B} {DET_STEPS} steps, loss "
        + " ".join(f"{x:.3f}" for x in synth["losses"])
        + f", median step {statistics.median(synth['step_ms'][1:]):.1f} ms; "
        f"COCO tree B={DET_B} {DET_STEPS} steps, loss "
        + " ".join(f"{x:.3f}" for x in losses)
        + f", val box AP {val['val.bbox_mAP']:.5f} AP50 "
        f"{val['val.bbox_mAP50']:.5f}; resample_normalize launched "
        f"{launched} times, K1-K6 0. predict at B={DET_PREDICT_B} (bf16, NMS "
        f"100 a image over {n} anchors): {predict_s * 1e3:.1f} ms, peak "
        f"{peak:.2f} GB above the model (one image's N x N IoU would be "
        f"{n * n * 4 / 1e9:.1f} GB); {int(valid.sum())} detections; on "
        f"{card()}; {time.perf_counter() - t0:.1f} s")
    return launched


def phase_real_data() -> tuple[dict, int]:
    """Phase 26: (the resample kernel's entry of the kernels line, its
    launches on the real-data paths 26b, 26c and 26e)."""
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_26_"))
    try:
        result = phase_dataplane()
        launched = phase_imagenet(work)
        launched += phase_coco(work)
        phase_gpunet(work)
        launched += phase_efficientdet(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("26 real data", f"{time.perf_counter() - t0:.1f} s")
    return result, launched


# -- phase 27 ----------------------------------------------------------------

MESH_STEPS = 2  # each run's checked steps (3 before PR 18)
MESH_TURN_STEPS = 3  # 27a's timed turns, alone on the card after 27b
# 27b's bert-pretrain at BERT-Large's width and 6 of its 24 layers (cut for
# time, PR 19: each rank builds it, rank 0 twice, and every step stages its
# gradients through the host; 27a keeps all 24 for phase 10's losses)
MESH_BERT_LAYERS = 6
MESH_OFFSET = 32  # a data rank's half of bert-pretrain's batch of 64
# Two gloo ranks on the card against the one-rank run of the same global
# batch, bf16: each rank's forward multiplies 32 rows where the one rank
# multiplies 64 (cuBLAS rounds them apart), the gradients add over the ranks
# in another order, ZeRO takes ||p|| and ||u|| from two halves. LAMB's first
# steps are about lr * sign(g) an entry, so an entry whose gradient is
# rounding noise (the key biases') steps either way: the parameters are
# compared in norm over the model, never entry by entry. Limits: each loss
# relative to the one rank's; ||p(2 ranks) - p(1 rank)|| over
# ||p(1 rank) - p(before)||, the distance the steps moved the model; the BN
# running statistics' distance over their norm. Each lies between the sound
# readings and those of planted faults (scripts/mesh_fault_check.py, NVIDIA
# H100 80GB HBM3, 700 W): sound BERT / ResNet-50 losses 5.0e-5 / 3.2e-5,
# parameters 1.39% / 1.89% of their move, BN statistics 3.6e-5; BN on the
# rank's rows 2.5e-3, 14.0%, 4.9e-3; K1's hash on the local row (BERT)
# 1.2e-3, 11.1%; no gradient mean over the data axis 1.2e-2 / 2.2e-1, 57% /
# 106%, 3.7e-2.
TOL_MESH = {"loss": 3e-4, "param_of_move": 0.05, "stats": 4e-4}
# 27a under torchrun at world 1 runs phase 10's tree run (its seed, batch,
# dropout draws and schedule) with --zero: its losses are phase 10's
TOL_MESH_WORLD1 = 1e-5


def _offset_kernels() -> float:
    """K1 and K2 on a data rank's half of bert-pretrain's batch (rows 32-63
    of B=64, S=128, H=16, D=64, bf16, masked, dropout 0.1 with the batch
    offset 32) against their plain versions with the same offset, and
    against rows 32.. of the whole batch's launches bit for bit. Returns
    the worst error against the plain versions."""
    q, k, v, mask = _attn_inputs(TB, TS, 16, 64, torch.bfloat16, "bshd")
    kw = dict(layout="bshd", dropout_rate=0.1, dropout_seed=-77)
    scale = 1.0 / math.sqrt(64)
    half = [t[MESH_OFFSET:].contiguous() for t in (q, k, v, mask)]
    whole, whole_lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    out, lse = fa.flash_attention_with_lse(
        *half, dropout_batch_offset=MESH_OFFSET, **kw)
    check(torch.equal(out, whole[MESH_OFFSET:])
          and torch.equal(lse, whole_lse[MESH_OFFSET:]),
          "K1 at batch offset 32 is not rows 32.. of the whole batch's")
    ref, ref_lse = fa.mha_reference(*half, **kw,
                                    dropout_batch_offset=MESH_OFFSET)
    fwd_err = max_err(out, ref)
    check(fwd_err <= TOL[torch.bfloat16][0]
          and max_err(lse, ref_lse) <= TOL[torch.bfloat16][1],
          f"K1 at batch offset 32 against its plain version: {fwd_err}")
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                       ).to(DEV, torch.bfloat16)
    args = (False, scale, "bshd", 0.1, -77)
    grads = fa._flash_bwd_cuda(*half[:3], half[3], out, lse, dout, *args,
                               MESH_OFFSET)
    whole_grads = fa._flash_bwd_cuda(
        q, k, v, mask, whole, whole_lse,
        torch.cat([torch.zeros_like(dout), dout]), *args, 0)
    check(all(torch.equal(g, w[MESH_OFFSET:])
              for g, w in zip(grads, whole_grads)),
          "K2 at batch offset 32 is not rows 32.. of the whole batch's")
    want = fa.mha_backward_reference(*half[:3], half[3], out, lse, dout,
                                     layout="bshd", dropout_rate=0.1,
                                     dropout_seed=-77,
                                     dropout_batch_offset=MESH_OFFSET)
    bwd_err = max(max_err(g, w) / float(w.float().abs().max())
                  for g, w in zip(grads, want))
    check(bwd_err <= TOL_BWD[torch.bfloat16],
          f"K2 at batch offset 32 against its plain backward: {bwd_err}")
    return max(fwd_err, bwd_err)


def _dropout_draw_ms() -> tuple[float, float, int]:
    """What hidden dropout's global draw costs a data rank of 2 at
    bert-pretrain's shape: (ms to draw the global batch's uniforms and keep
    the rank's rows, ms to draw the rank's rows alone, draws a step: the
    embeddings' and two a layer, each again in the backward)."""
    gen = torch.Generator(device=DEV)
    shape = (TB // 2, TS, BERT_CONFIGS["large"].hidden_size)

    def draw(rows, off):  # as ops/dropout.py's _keep_scale at rank 1
        gen.manual_seed(5)
        return torch.rand((rows, *shape[1:]), generator=gen,
                          device=DEV)[off:off + shape[0]]

    return (_event_ms(lambda: draw(TB, TB // 2)),
            _event_ms(lambda: draw(shape[0], 0)), 2 * (1 + 2 * LAYERS))


def _mesh_steps(run, cfg, steps: int = MESH_STEPS):
    """``steps`` of a CLI build's train step on its loader's batches (this
    rank's rows, ``cli.main.to_device``): the losses and each step's ms on
    CUDA events. The run's state moves on."""
    batches = iter(cli_main.to_device(run.loader, cfg.device,
                                      cfg.accum_steps))
    losses, ms = [], []
    for _ in range(steps):
        batch = next(batches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run.state, metrics = run.train_step(run.state, batch)
        end.record()
        losses.append(float(metrics["loss"]))
        ms.append(start.elapsed_time(end))
    return losses, ms


def _mesh_cfgs(work: Path, data: int, model: int) -> dict:
    """The three commands' configs at the mesh (data, model), as the CLI
    makes them from flags."""
    ws = str(work)
    return {
        "bert": cli_main.BertCliConfig(
            bert_model="large", batch_size=TB, seq_len=TS, max_predictions=20,
            steps_per_epoch=10, lr=float(PRETRAIN_LR), zero=True,
            mesh_data=data, workspace=ws),
        # fp32 (TF32 off): in bf16 at lr 0.256 a rounding apart grows from
        # step to step (a narrow ResNet's third step lands 17% of its
        # distance apart on the CPU), where fp32 shows what the axis changes
        "resnet50": cli_main.ConvNetCliConfig(
            batch_size=TB, steps_per_epoch=10, lr=CN_LR, momentum=CN_MOM,
            weight_decay=CN_WD, label_smoothing=CN_LS, mesh_data=data,
            amp=False, workspace=ws),
        "dlrm": cli_main.DlrmCliConfig(
            batch_size=DLRM_B, steps_per_epoch=10,
            lr=float(DLRM_LR_STABLE), mesh_data=1 if model > 1 else data,
            mesh_model=model, workspace=ws),
    }


def _build_run(name: str, cfg):
    if name == "bert":
        return cli_main.build_bert_pretrain(cfg)
    if name == "dlrm":
        return cli_main.build_dlrm(cfg)
    return cli_main.build_convnet(name, cfg)


def _whole(run) -> dict[str, torch.Tensor]:
    """The parameters, a sharded table gathered whole (every rank calls)."""
    return {n: pmesh.gather_sharded(p).detach().float().clone()
            for n, p in run.state.model.named_parameters()}


def _norm(a: dict, b: dict) -> float:
    """||a - b|| over every tensor of ``b``, in float64."""
    return math.sqrt(sum(float((a[n].double() - t.double()).square().sum())
                         for n, t in b.items()))


def _mesh_child(which: str, names: list[str] | None = None) -> None:
    """A rank of 27a (``torchrun --nproc-per-node 1``, NCCL) or 27b (two
    ranks on the card over gloo): prints one ``MESH {...}`` line a command
    (``names``: these of the phase's commands only). 27a then waits for
    the file ``MESH_GO_FILE`` names (where it is set: the phase makes it
    when 27b has ended) and times its hooks, alone on the card, in a second
    line a command."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets
    torch.backends.cudnn.allow_tf32 = False
    world2 = which == "27b"
    if world2:  # the builder reads the config from this dict
        BERT_CONFIGS["large"] = dataclasses.replace(
            BERT_CONFIGS["large"], num_layers=MESH_BERT_LAYERS)
    work = Path(tempfile.mkdtemp(prefix="mesh_"))
    out: dict = {"rank": int(os.environ.get("RANK", 0))}
    kept = {}  # 27a's runs, timed after 27b
    for name in names or (("bert", "resnet50", "dlrm") if world2
                          else ("bert", "dlrm")):
        cfg = _mesh_cfgs(work, 2 if world2 and name != "dlrm" else 1,
                         2 if world2 and name == "dlrm" else 1)[name]
        cli_main._common_setup(cfg, name)  # the CLI's start-up
        m = pmesh.current_mesh()
        run = _build_run(name, cfg)
        first = _whole(run) if world2 else None  # every rank gathers
        _reset_counts()
        losses, ms = _mesh_steps(run, cfg)
        torch.cuda.synchronize()
        got = {"losses": losses, "ms": ms, "launched": _counts(),
               "backend": torch.distributed.get_backend(),
               "world": m.world, "shape": m.shape}
        opt = run.state.opt_state
        if name == "bert":
            got["opt_bytes"] = sum(t.nbytes for part in (opt.mu, opt.nu)
                                   for t in part.values())
        if name == "dlrm":
            got["table_rows"] = run.state.model.embedding_table.shape[0]
        if not world2:
            kept[name] = (run, cfg)
        else:
            params = _whole(run)
            if m.is_primary:  # the one-rank run of the same global batch
                pmesh.reset_mesh()
                ref = _build_run(name, cfg)
                got["ref_losses"], got["ref_ms"] = _mesh_steps(ref, cfg)
                want = _whole(ref)
                got["param_diff"] = _norm(params, want)
                got["param_move"] = _norm(first, want)
                if name == "resnet50":
                    bufs = dict(run.state.model.named_buffers())
                    stats = {n: b.float() for n, b in
                             ref.state.model.named_buffers()
                             if n.endswith(("running_mean", "running_var"))}
                    got["stats_diff"] = _norm(bufs, stats) / _norm(
                        {n: torch.zeros_like(b) for n, b in stats.items()},
                        stats)
                del ref, want
            del params, first
            torch.distributed.barrier()
        # one write a line: the ranks share the pipe
        sys.stdout.write("MESH " + json.dumps({**out, name: got}) + "\n")
        sys.stdout.flush()
        del run
        torch.cuda.empty_cache()
    go, deadline = os.environ.get("MESH_GO_FILE"), time.monotonic() + 900
    while kept and go and not os.path.exists(go):
        check(time.monotonic() < deadline, "27a: 27b never ended")
        time.sleep(0.1)
    for name, (run, cfg) in kept.items():
        # the hooks' cost at world 1: the same state, the same steps in
        # turns with the 1 x 1 x 1 mesh of a run without torchrun
        turns = {"ms": [], "ms_no_mesh": []}
        for _ in range(3):
            pmesh.reset_mesh()
            turns["ms_no_mesh"] += _mesh_steps(run, cfg, MESH_TURN_STEPS)[1][1:]
            pmesh.build_mesh(pmesh.MeshSpec(cfg.mesh_data, cfg.mesh_model))
            turns["ms"] += _mesh_steps(run, cfg, MESH_TURN_STEPS)[1][1:]
        sys.stdout.write("MESH " + json.dumps({**out, f"{name}_turns": turns})
                         + "\n")
        sys.stdout.flush()
    kept.clear()
    shutil.rmtree(work, ignore_errors=True)
    torch.distributed.destroy_process_group()


def _torchrun(which: str, nproc: int, **env) -> subprocess.Popen:
    """Start ``python -m torch.distributed.run`` of this script's
    ``--mesh`` mode (read it with ``_ranks``)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), str(ROOT / "chip_smoke.py"),
           "--mesh", which]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **env},
                            start_new_session=True)  # killed as a group


def _ranks(which: str, proc: subprocess.Popen, nproc: int,
           timeout: int) -> list[dict]:
    """A ``_torchrun``'s ranks' ``MESH`` lines, merged per rank (raises
    at ``timeout``)."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        print(out[-6000:], err[-6000:], flush=True)
        raise AssertionError(f"{which}: torchrun exited {proc.returncode}")
    ranks: dict[int, dict] = {}
    for line in out.splitlines():
        if line.startswith("MESH "):
            got = json.loads(line[5:])
            ranks.setdefault(got["rank"], {}).update(got)
    check(sorted(ranks) == list(range(nproc)), f"{which}: ranks {sorted(ranks)}")
    return [ranks[r] for r in range(nproc)]


def _median_ms(ms: list[float]) -> float:
    return statistics.median(ms[1:])  # the first step warms up


def phase_mesh() -> tuple[float, dict[str, int]]:
    """27: the data and model mesh axes on the one card. K1/K2 at a data
    rank's batch offset; 27a ``torchrun --nproc-per-node 1`` (NCCL at world
    1) runs ``bert-pretrain --mesh-data 1 --zero`` (BERT-Large, B=64 S=128,
    phase 10's losses) and ``dlrm --mesh-model 1`` (26 x 100,000 x 128,
    B=65,536), each step on CUDA events beside the same steps with no mesh;
    27b two ranks on the card over gloo run ``bert-pretrain --mesh-data 2
    --zero`` (6 of BERT-Large's 24 layers), ``resnet50 --mesh-data 2``
    (B=64 global) and ``dlrm
    --mesh-model 2``, each against the one-rank run of the same global
    batch. Returns the offset kernels' worst error and the launches of the
    mesh runs (27a's, 27b's rank 0)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    err = _offset_kernels()
    launched = dict.fromkeys(_counts(), 0)
    # 27a's first steps (its checks) run beside 27b; its timed turns (the
    # world-1 hooks against no mesh) wait until 27b has ended, so that they
    # share the card and the host with nothing
    go = Path(tempfile.mkdtemp(prefix="mesh_go_")) / "go"
    procs = (_torchrun("27a", 1, MESH_GO_FILE=str(go)),
             _torchrun("27b", 2, DLX_DIST_BACKEND="gloo"))
    reader = concurrent.futures.ThreadPoolExecutor(1)
    try:
        a_ranks = reader.submit(_ranks, "27a", procs[0], 1, 900)
        b = _ranks("27b", procs[1], 2, 600)
        go.touch()
        a = a_ranks.result()[0]
    finally:  # neither launcher nor its ranks outlive the phase
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        reader.shutdown()
        shutil.rmtree(go.parent, ignore_errors=True)
    for name in ("bert", "dlrm"):
        check(a[name]["backend"] == "nccl" and a[name]["world"] == 1,
              f"27a {name}: {a[name]['backend']} at world {a[name]['world']}")
        for k, v in a[name]["launched"].items():
            launched[k] += v
    want = TREE_LOSSES["tree"][:MESH_STEPS]
    check(all(abs(x - y) <= TOL_MESH_WORLD1 * abs(y)
              for x, y in zip(a["bert"]["losses"], want)),
          f"27a bert-pretrain --zero at world 1: {a['bert']['losses']} vs "
          f"phase 10's {want}")
    check(a["bert"]["launched"]["flash_fwd"] == LAYERS * MESH_STEPS
          and a["bert"]["launched"]["flash_bwd_dkv"] == LAYERS * MESH_STEPS
          and a["dlrm"]["launched"]["gather_rows"] == MESH_STEPS,
          f"27a launches {a['bert']['launched']}, {a['dlrm']['launched']}")
    say("27a NCCL at world 1", "torchrun --nproc-per-node 1, its first 3 "
        "steps beside 27b, its timed turns alone after 27b: "
        + "; ".join(
            f"{name} losses " + " ".join(f"{x:.4f}" for x in a[name]["losses"])
            + f", step {statistics.median(a[name + '_turns']['ms']):.2f} ms "
            f"on CUDA events (median of 6: 3 turns of 3 steps after the "
            f"first), {statistics.median(a[name + '_turns']['ms_no_mesh']):.2f}"
            " ms in turns with no mesh (a run without torchrun), same state"
            for name in ("bert", "dlrm"))
        + f"; bert-pretrain --zero equals phase 10's losses {want} within "
        f"{TOL_MESH_WORLD1}")
    lines = []
    for name in ("bert", "resnet50", "dlrm"):
        r0, r1 = b[0][name], b[1][name]
        check(r0["backend"] == "gloo" and r0["world"] == 2,
              f"27b {name}: {r0['backend']} at world {r0['world']}")
        check(r0["losses"] == r1["losses"],
              f"27b {name}: the ranks' losses differ {r0['losses']} "
              f"{r1['losses']}")
        check(all(abs(x - y) <= TOL_MESH["loss"] * abs(y)
                  for x, y in zip(r0["losses"], r0["ref_losses"])),
              f"27b {name}: losses {r0['losses']} vs one rank's "
              f"{r0['ref_losses']}")
        check(r0["param_diff"] <= TOL_MESH["param_of_move"] * r0["param_move"],
              f"27b {name}: parameters {r0['param_diff']:.3e} apart in norm, "
              f"the steps moved them {r0['param_move']:.3e}")
        for k, v in r0["launched"].items():
            launched[k] += v
        line = (f"{name} {r0['shape']}: losses "
                + " ".join(f"{x:.4f}" for x in r0["losses"]) + " vs one rank "
                + " ".join(f"{x:.4f}" for x in r0["ref_losses"])
                + f"; parameters {r0['param_diff']:.3e} apart in norm (the "
                f"steps moved them {r0['param_move']:.3e}); step "
                f"{_median_ms(r0['ms']):.1f} ms (one rank "
                f"{_median_ms(r0['ref_ms']):.1f} ms)")
        if name == "bert":
            line += (f"; optimizer state {r0['opt_bytes'] / 1e6:.1f} MB on "
                     f"rank 0, {r1['opt_bytes'] / 1e6:.1f} MB on rank 1")
        if name == "resnet50":
            check(r0["stats_diff"] <= TOL_MESH["stats"],
                  f"27b resnet50: BN running statistics {r0['stats_diff']}")
            line += f"; BN running statistics {r0['stats_diff']:.3e} apart"
        if name == "dlrm":
            check(r0["table_rows"] + r1["table_rows"] == DLRM_CFG.total_rows
                  and r0["table_rows"] == DLRM_CFG.total_rows // 2,
                  f"27b dlrm: table rows {r0['table_rows']}, "
                  f"{r1['table_rows']}")
            line += (f"; table rows {r0['table_rows']} on rank 0, "
                     f"{r1['table_rows']} on rank 1")
        lines.append(line)
    check(b[0]["bert"]["launched"]["flash_fwd"]
          == MESH_BERT_LAYERS * MESH_STEPS
          and b[0]["dlrm"]["launched"]["gather_rows"] == MESH_STEPS
          and b[0]["resnet50"]["launched"] == dict.fromkeys(_counts(), 0),
          f"27b launches {[b[0][n]['launched'] for n in b[0] if n != 'rank']}")
    drop = _dropout_draw_ms()
    say("27b two gloo ranks on the card", "beside 27a's first steps (its "
        "step times so): " + "; ".join(lines)
        + f"; K1/K2 at batch offset 32 against plain {err:.3e}; hidden "
        f"dropout's draw at a rank of 2 (the global batch's uniforms, the "
        f"rank's rows kept) {drop[0]:.4f} ms against {drop[1]:.4f} ms for "
        f"the rank's rows alone, {drop[2]} draws a step (CUDA events); "
        f"{time.perf_counter() - t0:.1f} s")
    return err, launched


# -- phase 28 ----------------------------------------------------------------

# 28a: one fp32 step of each family at a small width, B below, on the card
# (TF32 off, dropout 0, MoFlow's dequantisation noise the same draws on both
# sides, Transformer-XL's step on a second segment whose memory is live)
# against the same step on the CPU in float64 (on ``_HOST``): the loss to
# the first limit relative, each gradient to the second of its own largest
# entry (or FLOOR times the largest of all, where that is more) and to the
# third of the largest of all. Where the family trains in bf16 (ncf,
# nnunet, transformer-xl) the bf16 step is the control and must miss them.
BREADTH_PARITY = {
    "ncf": dict(cfg=dict(nb_users=2000, nb_items=1000, mf_dim=16,
                         mlp_layer_sizes=(64, 64, 32, 16), dropout=0.0), b=256),
    "tft": dict(cfg=dict(n_observed=2, n_known=2, hidden=32, n_heads=4,
                         encoder_len=48, horizon=12, dropout=0.0), b=16),
    "nnunet": dict(cfg=dict(spatial_rank=2, base_filters=8, depth=3,
                            max_filters=32), b=2, size=32),
    "transformer-xl": dict(cfg=dict(vocab_size=1000, d_model=64, n_heads=4,
                                    d_head=16, d_ff=128, n_layers=2,
                                    seg_len=32, mem_len=32, dropout=0.0), b=2),
    "moflow": dict(cfg={}, b=16),  # MoFlowConfig(): the command's QM9 width
}
# (loss relative; of a tensor's own largest entry, of the largest of all),
# about 10x above this phase's first readings on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md): loss 9.1e-8, 2.1e-8, 8.1e-9, 6.1e-8, 8.5e-8; own 1.60e-6,
# 5.98e-6, 3.04e-6, 5.99e-7, 3.59e-5 (MoFlow's BNs over 3 x 3 bond maps);
# all 8.4e-7, 6.3e-7, 3.9e-7, 4.5e-7, 9.3e-8 (ncf, tft, nnunet,
# transformer-xl, moflow). The bf16 controls read 1.25e-1 / 1.03e-1 (ncf),
# 4.97e-1 / 1.45e-1 (nnunet), 1.39e-1 / 6.26e-2 (transformer-xl)
TOL_BREADTH = {"ncf": (1e-6, 3e-5, 1e-5), "tft": (1e-6, 1e-4, 1e-5),
               "nnunet": (1e-6, 1e-4, 1e-5),
               "transformer-xl": (1e-6, 1e-5, 1e-5),
               "moflow": (1e-6, 1e-3, 1e-5)}
BREADTH_CONTROL = ("ncf", "nnunet", "transformer-xl")
# 28b: the five commands through the CLI's runners at full width, with the
# rates passed explicitly (the JAX runners' fallbacks; configs.yml's for
# tft), each step timed on CUDA events, two steps traced for the device's
# idle share: (batch size, arguments, what a sample is, samples a row)
BREADTH_CLI = {
    "ncf": (131072, ["--steps-per-epoch", "10", "--lr", "2.5e-3"],
            "samples", 1),
    "tft": (64, ["--config-file", str(ROOT / "configs.yml"), "--epochs",
                 "2", "--lr", "1e-3"], "windows", 1),
    "nnunet": (64, ["--steps-per-epoch", "5", "--epochs", "2", "--lr",
                    "1e-3"], "images", 1),
    "transformer-xl": (32, ["--steps-per-epoch", "5", "--epochs", "2",
                            "--lr", "2.5e-4"], "tokens", 192),
    "moflow": (512, ["--steps-per-epoch", "5", "--epochs", "2", "--lr",
                     "1e-3"], "molecules", 1),
}
BREADTH_TRACED = (3, 5)  # the steps [3, 5) of each run run under the profiler
BREADTH_KINDS = [
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|winograd|implicit", re.I)),
    ("GEMM", re.compile(r"gemm|nvjet|xmma|cutlass|cublas|sm90_", re.I)),
    ("LSTM", re.compile(r"lstm|rnn", re.I)),
    ("BN", re.compile(r"batch_norm|batchnorm", re.I)),
    ("softmax/CE", re.compile(r"softmax|nll_loss|cross_entropy", re.I)),
    ("reduction", re.compile(r"reduce", re.I)),
    ("index/scatter", re.compile(r"index|gather|scatter|embedding", re.I)),
    ("elementwise", re.compile(r"elementwise|CatArray|copy", re.I)),
]


def _breadth_kind(name: str) -> str:
    for kind, pat in BREADTH_KINDS:
        if pat.search(name):
            return kind
    return "other"


def _breadth_init(kind: str, dtype=torch.float32):
    """28a's task and model (on the CPU, from SEED) for one family."""
    p = BREADTH_PARITY[kind]
    gen = torch.Generator().manual_seed(SEED)
    if kind == "ncf":
        task = NcfTask(NcfConfig(**p["cfg"]), dtype)
    elif kind == "tft":
        task = TFTTask(TFTConfig(**p["cfg"]), dtype)
    elif kind == "nnunet":
        task = UNetTask(UNetConfig(**p["cfg"]), dtype)
    elif kind == "transformer-xl":
        task = TransformerXLTask(TransformerXLConfig(**p["cfg"]), dtype)
    else:
        task = MoFlowTask(MoFlowConfig(**p["cfg"]))
    model = task.init(gen, "cpu")
    if kind == "moflow":  # every ActNorm off the identity, BN statistics off 0/1
        with torch.no_grad():
            for n, t in model.state_dict().items():
                if n.endswith(("actnorm.scale", "running_var")):
                    t.copy_(1.0 + 0.2 * torch.rand(t.shape, generator=gen))
                elif n.endswith(("actnorm.loc", "running_mean")):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return task, model


def _breadth_batch(kind: str) -> list[dict]:
    """28a's batches (numpy, from SEED): two segments for Transformer-XL,
    the batch and MoFlow's noise for MoFlow, one batch otherwise."""
    p, rng = BREADTH_PARITY[kind], np.random.default_rng(SEED)
    b, c = p["b"], p["cfg"]
    if kind == "ncf":
        return [{"user": rng.integers(0, c["nb_users"], b).astype(np.int32),
                 "item": rng.integers(0, c["nb_items"], b).astype(np.int32),
                 "label": rng.integers(0, 2, b).astype(np.float32)}]
    if kind == "tft":
        enc, hor = c["encoder_len"], c["horizon"]
        return [{"observed": rng.normal(size=(b, enc, 2)).astype(np.float32),
                 "known": rng.normal(size=(b, enc + hor, 2)).astype(np.float32),
                 "target": rng.normal(size=(b, hor)).astype(np.float32)}]
    if kind == "nnunet":
        s = p["size"]
        return [{"image": rng.normal(size=(b, s, s, 1)).astype(np.float32),
                 "label": rng.integers(0, 3, (b, s, s)).astype(np.int32)}]
    if kind == "transformer-xl":
        toks = rng.integers(0, c["vocab_size"], (b, 2 * c["seg_len"] + 1))
        t = c["seg_len"]
        return [{"tokens": toks[:, i:i + t].astype(np.int32),
                 "targets": toks[:, i + 1:i + t + 1].astype(np.int32)}
                for i in (0, t)]
    cfg = MoFlowConfig(**c)
    n, e, a = cfg.n_node, cfg.n_bond_types, cfg.n_atom_types
    atoms = np.eye(a, dtype=np.float32)[rng.integers(0, a, (b, n))]
    bonds = np.triu(rng.integers(0, e, (b, n, n)), 1)
    adj = np.eye(e, dtype=np.float32)[bonds + bonds.transpose(0, 2, 1)]
    batch = {"atoms": atoms, "adj": adj.transpose(0, 3, 1, 2).copy()}
    noise = {k: rng.uniform(size=v.shape).astype(np.float32)
             for k, v in batch.items()}
    return [batch, noise]


def _breadth_grads(kind: str, model, batches: list[dict], device) -> dict:
    """The loss and every gradient of one step of ``model`` (moved to
    ``device``, in its own compute dtype; float inputs in its parameters'
    dtype), on the CPU."""
    model = model.to(device).train()
    pdt = next(model.parameters()).dtype

    def put(batch):
        return {k: torch.from_numpy(v).to(device, pdt if v.dtype.kind == "f"
                                          else None)
                for k, v in batch.items()}

    gen = torch.Generator().manual_seed(SEED)
    params = dict(model.named_parameters())
    if kind == "transformer-xl":
        t = TransformerXLTask(model.cfg, model.dtype)
        with torch.no_grad():
            _, (state, _) = t.loss_fn(model, {}, put(batches[0]), gen)
        loss, _ = t.loss_fn(model, state, put(batches[1]), gen)
    elif kind == "moflow":
        t = MoFlowTask(model.cfg)
        noise = put(batches[1])
        with mock.patch.object(t, "draws", lambda g, b: noise):
            loss, _ = t.loss_fn(model, t.model_state(model), put(batches[0]),
                                gen)
    else:
        t = {"ncf": NcfTask, "tft": TFTTask, "nnunet": UNetTask}[kind](
            model.cfg, model.dtype)
        loss, _ = t.loss_fn(model, {}, put(batches[0]), gen)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {"loss": float(loss.detach()),
            "grads": {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
                      for (n, p), g in zip(params.items(), grads)}}


def _breadth_references() -> dict:
    """28a's models and batches, and each family's float64 CPU step started
    on the host thread (``_HOST``) beside 28b."""
    refs = {}
    for kind in BREADTH_PARITY:
        _, init = _breadth_init(kind)
        batches = _breadth_batch(kind)
        refs[kind] = (init, batches, _HOST.submit(
            _breadth_grads, kind, _float64(copy.deepcopy(init)), batches,
            "cpu"))
    return refs


def phase_breadth_parity(refs: dict) -> None:
    """28a on each family's ``_breadth_references``: every family runs
    before the first failure is raised."""
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    failed, lines = [], []
    try:
        for kind, (init, batches, f64) in refs.items():
            gpu = _breadth_grads(kind, copy.deepcopy(init), batches, DEV)
            f64 = f64.result()
            loss_lim, *lim = TOL_BREADTH[kind]
            g_rel = _worst(gpu["grads"], f64["grads"])
            rel_loss = abs(gpu["loss"] - f64["loss"]) / abs(f64["loss"])
            line = (f"{kind} B={BREADTH_PARITY[kind]['b']}: loss "
                    f"{gpu['loss']:.7f} vs {f64['loss']:.7f} ({rel_loss:.2e}, "
                    f"limit {loss_lim:.0e}); worst gradients {_fmt(g_rel)} "
                    f"(limits {lim[0]:.0e}, {lim[1]:.0e})")
            ok = rel_loss <= loss_lim and _within(g_rel, lim)
            if kind in BREADTH_CONTROL:
                b16 = _breadth_grads(kind, _s2s_copy(init, torch.bfloat16),
                                     batches, DEV)
                w16 = _worst(b16["grads"], f64["grads"])
                line += (f"; bf16 control: loss {b16['loss']:.6f}, worst "
                         f"gradients {_fmt(w16)}")
                ok = ok and math.isfinite(b16["loss"]) and not _within(w16, lim)
            lines.append(line)
            if not ok:
                failed.append(line)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
    say("28 breadth", "parity, one fp32 step, card vs CPU float64: "
        + "; ".join(lines) + f" ({time.perf_counter() - t0:.1f} s)")
    check(not failed, "; ".join(failed))


def _clocked_cli(args: list[str]):
    """``cli(args)`` with every train step between two CUDA events and the
    steps ``BREADTH_TRACED`` under ``torch.profiler``: (what the runner
    returned, per-step event ms, the traced steps' device kernels)."""
    events, prof = [], torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    lo, hi = BREADTH_TRACED
    orig = cli_main.train_loop

    def loop(state, train_step, *a, **k):
        def step(state, batch):
            i = len(events)
            if i == lo:
                torch.cuda.synchronize()
                prof.start()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = train_step(state, batch)
            end.record()
            events.append((start, end))
            if i == hi - 1:
                torch.cuda.synchronize()
                prof.stop()
            return out
        return orig(state, step, *a, **k)

    with mock.patch.object(cli_main, "train_loop", loop):
        out = cli(args)
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    if len(events) < hi:  # a run shorter than the traced steps
        return out, ms, [], []
    return out, ms, profile_pretrain.device_kernels(prof.events()), \
        prof.events()


def phase_breadth() -> dict[str, int]:
    """28b and 28c: the five commands through the CLI's runners at full
    width, K1-K6 launching 0 times on each; returns those launches."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "breadth"
    total = dict.fromkeys(_counts(), 0)
    lines, profile = [], {}
    lo, hi = BREADTH_TRACED
    for name, (b, args, unit, per_row) in BREADTH_CLI.items():
        ws = work / name
        shutil.rmtree(ws, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # this path starts here
        t1 = time.perf_counter()
        out, ms, kernels, _ = _clocked_cli(
            [name, "--batch-size", str(b), *args, "--workspace", str(ws)])
        wall = time.perf_counter() - t1
        launched = _counts()
        check(launched == dict.fromkeys(launched, 0),
              f"{name}: K1-K6 launched {launched}")
        losses = [d["train.loss"] for d in _raport_data(
            ws / f"{name.replace('-', '_')}_raport.json") if "train.loss" in d]
        check(len(losses) == len(ms) >= hi + 2
              and all(map(math.isfinite, losses)), f"{name}: losses {losses}")
        head, tail = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        check(tail < head, f"{name}: losses do not fall: {losses}")
        timed = ms[1:lo] + ms[hi:]  # the first warms up; traced ones apart
        med = statistics.median(timed)
        busy = profile_pretrain._union_us(
            [(e.time_range.start, e.time_range.end) for e in kernels])
        by_kind: dict[str, float] = {}
        for e in kernels:
            k = _breadth_kind(e.name)
            by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end
                                                - e.time_range.start)
        busy_ms = busy / (hi - lo) / 1e3
        idle = 1.0 - busy_ms / med
        rate = b * per_row / med * 1e3
        extra = ""
        if name == "tft":
            metrics = out[2]
            check(metrics and all(map(math.isfinite, metrics.values())),
                  f"tft: test metrics {metrics}")
            extra = (f", test MAE {metrics['test.MAE']:.4f} P50 "
                     f"{metrics['test.P50']:.4f} P90 {metrics['test.P90']:.4f}")
        if name == "transformer-xl":
            state = out[0]
            check(int(state.model_state["mem_valid"]) == 192,
                  f"transformer-xl: mem_valid {state.model_state['mem_valid']}")
        profile[name] = {
            "batch": b, "steps": len(ms), "step_ms": ms, "median_ms": med,
            "rate": rate, "unit": unit, "device_busy_ms": busy_ms,
            "device_idle_share": idle, "launches_per_step": len(kernels)
            / (hi - lo), "kernel_ms_by_kind": {
                k: v / (hi - lo) / 1e3 for k, v in sorted(by_kind.items())},
            "losses": losses, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        lines.append(
            f"{name} B={b}: {len(ms)} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}{extra}; median step {med:.2f} ms (CUDA events), "
            f"{rate:,.0f} {unit}/s, device idle {idle:.1%} "
            f"({len(kernels) / (hi - lo):.0f} kernels a step; "
            + ", ".join(f"{k} {v / (hi - lo) / 1e3:.2f}"
                        for k, v in sorted(by_kind.items(),
                                           key=lambda kv: -kv[1]))
            + f" ms); peak {profile[name]['peak_gb']:.1f} GB; {wall:.1f} s "
            "for the run; launches 0")
        for k, v in launched.items():
            total[k] += v
        shutil.rmtree(ws, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase28.json").write_text(json.dumps(
        {"card": card(), **profile}, indent=1))
    say("28 breadth", f"commands on {card()}: " + "; ".join(lines)
        + f". K1-K6 launched 0 times on these paths "
        f"({time.perf_counter() - t0:.1f} s)")
    return total


# -- phase 29 ----------------------------------------------------------------

# 29a: one fp32 step of Mask R-CNN and of the SE(3)-Transformer at a small
# width on the card (TF32 off) against the same step on the CPU in float64
# (on ``_HOST``), the samplers on the same uniforms. Mask R-CNN's proposals
# are the float64 step's, fed to the card (a proposal is decoded through
# ``exp`` of the RPN's deltas, so fp32 moves its corners by 1e-3 px and the
# top-k and NMS may pick other boxes); its ROI and anchor samples follow
# from them on the same draws. The bf16 step is the control and must miss.
MRCNN_PARITY = dict(cfg=dict(backbone="resnet18", image_size=128,
                             num_classes=6, fpn_width=32, head_fc_dim=64,
                             rpn_pre_nms_top_n=200, rpn_post_nms_top_n=64,
                             rpn_batch_per_image=64, roi_batch_per_image=32),
                    b=2, g=4)
SE3_PARITY = dict(cfg=dict(num_layers=2, num_degrees=3, num_channels=8,
                           num_heads=2), b=4, n=12)
# (loss relative, each loss term too; of a tensor's own largest entry, of
# the largest of all). Readings on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md): Mask R-CNN 3.1e-7, 1.9e-5, 1.1e-6, SE(3) 1.4e-8, 8.6e-7,
# 2.3e-7; the bf16 controls 5.2e-1 / 1.7e-1 and 2.5e-1 / 4.1e-2. Mask
# R-CNN's own-entry limit leaves room for its mask head's ReLUs near their
# kink (the CPU's fp32 step reads 1.8e-3 there)
TOL_LAST = {"maskrcnn": (1e-5, 1e-2, 1e-4), "se3": (1e-6, 1e-5, 1e-5)}
# 29b: ``maskrcnn --config-file configs.yml`` (R50-FPN, 800 x 800, B=16, 81
# classes, bf16) on synthetic batches with masks, steps on CUDA events, two
# under the profiler; a short ``--data-backend coco`` run on a COCO tree of
# the JPEG fixtures with polygons, with box and mask mAP on its val split;
# ``se3-transformer`` at the CLI's config; one ``SE3RegressionTask(
# SE3Config())`` step at the reference's QM9 width (7 layers, degrees 0-3,
# 32 channels, 8 heads) on 29 atoms at the largest batch under about 60 GB
MRCNN_STEPS = 8
MRCNN_COCO = (8, 4, 4)  # train images, val images, batch
SE3_CLI_B = 256
SE3_FULL = (48, 29, 4)  # batch, atoms, steps


def _mrcnn_parity_init(dtype=torch.float32):
    """29a's Mask R-CNN task and model (on the CPU, from SEED), every BN
    redrawn as phase 19's."""
    task = MaskRCNNTask(MaskRCNNConfig(**MRCNN_PARITY["cfg"]), dtype)
    gen = torch.Generator().manual_seed(SEED)
    model = task.init(gen, "cpu")
    _redraw_bn(model, gen)
    return task, model


def _mrcnn_parity_batch():
    """29a's batch and sampler uniforms (numpy, from SEED)."""
    p, cfg = MRCNN_PARITY, MaskRCNNConfig(**MRCNN_PARITY["cfg"])
    batch = next(iter(SyntheticDetectionLoader(
        p["b"], cfg.image_size, cfg.num_classes - 1, max_gt=p["g"], steps=1,
        with_masks=True, mask_grid=32, seed=SEED)))
    rng = np.random.default_rng(SEED)
    a = sum(x.shape[0] for x in fpn_anchors(cfg))
    r = cfg.rpn_post_nms_top_n + p["g"]
    draws = {k: rng.uniform(size=(p["b"], n)).astype(np.float32)
             for k, n in (("rpn_pos", a), ("rpn_neg", a), ("roi_pos", r),
                          ("roi_neg", r))}
    return batch, draws


def _mrcnn_grads(model, batch: dict, draws: dict, device, pinned=None):
    """The loss terms and every gradient of one training step of ``model``
    (moved to ``device``, its images in its parameters' dtype) on
    ``draws``, on the proposals ``pinned`` where given; the proposals it
    ran on."""
    model = model.to(device).train()
    task = MaskRCNNTask(model.cfg, model.dtype)
    pdt = next(model.parameters()).dtype
    t = {k: torch.from_numpy(v).to(device, pdt if k == "image" else None)
         for k, v in batch.items()}
    u = {k: torch.from_numpy(v).to(device) for k, v in draws.items()}
    used = {}
    orig = task.proposals

    def proposals(logits, deltas):
        out = orig(logits, deltas) if pinned is None else \
            tuple(x.to(device) for x in pinned)
        used["proposals"] = tuple(x.cpu() for x in out)
        return out

    with mock.patch.object(task, "draws", lambda g, b: u), \
            mock.patch.object(task, "proposals", proposals):
        loss, (_, terms) = task.loss_fn(model, task.model_state(model), t,
                                        torch.Generator())
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": float(loss.detach()),
            "terms": {k: float(v) for k, v in terms.items()},
            "grads": {n: g.detach().cpu() for n, g in zip(params, grads)},
            "proposals": used["proposals"]}


def _se3_parity_batch() -> dict:
    p, rng = SE3_PARITY, np.random.default_rng(SEED)
    b, n = p["b"], p["n"]
    mask = np.ones((b, n), np.float32)
    mask[1, n - 3:] = 0.0  # padded atoms
    return {"positions": rng.normal(size=(b, n, 3)).astype(np.float32) * 2,
            "species": np.eye(6, dtype=np.float32)[rng.integers(0, 6, (b, n))],
            "mask": mask, "target": rng.normal(size=b).astype(np.float32)}


def _se3_grads(model, batch: dict, device) -> dict:
    model = model.to(device).train()
    pdt = next(model.parameters()).dtype
    t = {k: torch.from_numpy(v).to(device, pdt) for k, v in batch.items()}
    loss, _ = SE3RegressionTask(model.cfg).loss_fn(model, {}, t, None)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": float(loss.detach()),
            "grads": {n: g.detach().cpu() for n, g in zip(params, grads)}}


def _last_two_references() -> dict:
    """29a's models and batches, and their float64 CPU steps started on the
    host thread (``_HOST``) beside 29b."""
    _, mrcnn = _mrcnn_parity_init()
    batch, draws = _mrcnn_parity_batch()
    se3 = SE3RegressionTask(SE3Config(**SE3_PARITY["cfg"])).init(
        torch.Generator().manual_seed(SEED), "cpu")
    se3_batch = _se3_parity_batch()
    return {
        "maskrcnn": (mrcnn, (batch, draws), _HOST.submit(
            _mrcnn_grads, _float64(copy.deepcopy(mrcnn)), batch, draws,
            "cpu")),
        "se3": (se3, se3_batch, _HOST.submit(
            _se3_grads, _float64(copy.deepcopy(se3)), se3_batch, "cpu"))}


def phase_last_two_parity(refs: dict) -> None:
    """29a on ``_last_two_references``: both models run before the first
    failure is raised."""
    t0 = time.perf_counter()
    failed, lines = [], []
    for kind, (init, data, f64) in refs.items():
        f64 = f64.result()
        if kind == "maskrcnn":
            props = tuple(x.float() if x.is_floating_point() else x
                          for x in f64["proposals"])
            gpu = _mrcnn_grads(copy.deepcopy(init), *data, DEV, props)
            ctl = MaskRCNN(init.cfg, torch.bfloat16)
            ctl.load_state_dict(init.state_dict())
            b16 = _mrcnn_grads(ctl, *data, DEV, props)
            terms = max((abs(gpu["terms"][k] - v) / abs(v), k)
                        for k, v in f64["terms"].items())
            extra = f"; worst term {terms[1]} {terms[0]:.2e}"
            shape = (f"B={MRCNN_PARITY['b']} resnet18-FPN 128 x 128, the "
                     "float64 step's proposals fed to the card")
        else:
            gpu = _se3_grads(copy.deepcopy(init), data, DEV)
            b16 = _se3_grads(_float64(copy.deepcopy(init), torch.bfloat16),
                             data, DEV)
            terms, extra = (0.0, ""), ""
            shape = (f"B={SE3_PARITY['b']} N={SE3_PARITY['n']} (3 atoms "
                     "padded), 2 layers, degrees 0-2, 8 channels")
        loss_lim, *lim = TOL_LAST[kind]
        rel_loss = max(abs(gpu["loss"] - f64["loss"]) / abs(f64["loss"]),
                       terms[0])
        g_rel = _worst(gpu["grads"], f64["grads"])
        w16 = _worst(b16["grads"], f64["grads"])
        line = (f"{kind} {shape}: loss {gpu['loss']:.7f} vs {f64['loss']:.7f} "
                f"({rel_loss:.2e} with the terms, limit {loss_lim:.0e}"
                f"{extra}); worst gradients {_fmt(g_rel)} (limits "
                f"{lim[0]:.0e}, {lim[1]:.0e}); bf16 control: loss "
                f"{b16['loss']:.6f}, worst gradients {_fmt(w16)}")
        lines.append(line)
        if not (rel_loss <= loss_lim and _within(g_rel, lim)
                and math.isfinite(b16["loss"]) and not _within(w16, lim)):
            failed.append(line)
    say("29 Mask R-CNN and SE(3)", "parity, one fp32 step, card vs CPU "
        "float64: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    check(not failed, "; ".join(failed))


def _parts(events, spans) -> tuple[dict[str, float], dict[str, int]]:
    """Device kernel time (us) and launches by the span their launch ran
    in: a span of ``spans``, ``optimizer``, ``backward`` (launched by
    autograd's engine) or ``other``."""
    us: dict[str, float] = {}
    launches: dict[str, int] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        part, p = "other", e
        while p is not None:
            if p.name in spans or p.name == "optimizer":
                part = p.name
                break
            if p.name.startswith("autograd::engine"):
                part = "backward"
                break
            p = p.cpu_parent
        us[part] = us.get(part, 0.0) + sum(k.duration for k in e.kernels)
        launches[part] = launches.get(part, 0) + len(e.kernels)
    return us, launches


def _last_two_run(name: str, args: list[str], ws: Path, spans=()) -> dict:
    """One CLI run of 29b through ``_clocked_cli`` with the counts set to 0
    before it: its launches, losses, step times, idle share, kernels by
    kind and by span."""
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # this path starts here
    t0 = time.perf_counter()
    out, ms, kernels, events = _clocked_cli([name, *args, "--workspace",
                                             str(ws)])
    wall = time.perf_counter() - t0
    launched = _counts()
    data = _raport_data(next(ws.glob("*_raport.json")))
    losses = [d["train.loss"] for d in data if "train.loss" in d]
    lo, hi = BREADTH_TRACED
    res = {"launched": launched, "losses": losses, "step_ms": ms,
           "wall": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "val": [d for d in data if any(k.startswith("val.") for k in d)],
           "out": out}
    if len(ms) >= hi + 2:
        timed = ms[1:lo] + ms[hi:]
        med = statistics.median(timed)
        busy = profile_pretrain._union_us(
            [(e.time_range.start, e.time_range.end) for e in kernels]) \
            / (hi - lo) / 1e3
        by_kind: dict[str, float] = {}
        for e in kernels:
            k = _breadth_kind(e.name)
            by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end
                                                - e.time_range.start)
        res.update(median_ms=med, device_busy_ms=busy,
                   device_idle_share=1.0 - busy / med,
                   launches_per_step=len(kernels) / (hi - lo),
                   kernel_ms_by_kind={k: v / (hi - lo) / 1e3
                                      for k, v in sorted(by_kind.items())})
        if spans:  # the proposals' span holds the NMS loop's launches
            us, launches = _parts(events, spans)
            res["kernel_ms_by_part"] = {k: v / (hi - lo) / 1e3
                                        for k, v in sorted(us.items())}
            res["launches_by_part"] = {k: v / (hi - lo)
                                       for k, v in sorted(launches.items())}
    shutil.rmtree(ws, ignore_errors=True)
    return res


def _fmt_run(name: str, b: int, r: dict, unit: str) -> str:
    rate = b / r["median_ms"] * 1e3
    line = (f"{name} B={b}: {len(r['step_ms'])} steps, loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; median step "
            f"{r['median_ms']:.2f} ms (CUDA events), {rate:,.1f} {unit}/s, "
            f"device idle {r['device_idle_share']:.1%} "
            f"({r['launches_per_step']:.0f} kernels a step; "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                r["kernel_ms_by_kind"].items(), key=lambda kv: -kv[1]))
            + f" ms); peak {r['peak_gb']:.1f} GB; {r['wall']:.1f} s for the "
            "run")
    if "kernel_ms_by_part" in r:
        line += "; by part " + ", ".join(
            f"{k.removeprefix('maskrcnn.')} {v:.2f}" for k, v in sorted(
                r["kernel_ms_by_part"].items(), key=lambda kv: -kv[1])) \
            + " ms; launches a step by span " + ", ".join(
                f"{k.removeprefix('maskrcnn.')} {v:.0f}"
                for k, v in r["launches_by_part"].items())
    return line


def phase_last_two() -> dict[str, int]:
    """29b and 29c: ``maskrcnn`` (synthetic at full width, and a COCO run
    with box and mask mAP), ``se3-transformer`` and a full-width SE(3)
    step, K1-K6 launching 0 times on each; returns the launches (the card's
    data plane's resample kernel on the COCO run)."""
    t0 = time.perf_counter()
    work = ROOT / "workspace" / "chip_smoke" / "last_two"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total = dict.fromkeys(_counts(), 0)
    lines, profile = [], {"card": card()}
    lo, hi = BREADTH_TRACED
    cfg_file = str(ROOT / "configs.yml")

    def done(name, r, zero=True):
        launched = r["launched"]
        others = {k: v for k, v in launched.items()
                  if k != "resample_normalize" or zero}
        check(others == dict.fromkeys(others, 0),
              f"{name}: K1-K6 launched {launched}")
        check(r["losses"] and all(map(math.isfinite, r["losses"])),
              f"{name}: losses {r['losses']}")
        for k, v in launched.items():
            total[k] += v

    # Mask R-CNN at full width on synthetic batches with masks
    r = _last_two_run("maskrcnn", ["--config-file", cfg_file,
                                   "--steps-per-epoch", str(MRCNN_STEPS),
                                   "--epochs", "1"], work / "mrcnn", SPANS)
    done("maskrcnn", r)
    head, tail = statistics.mean(r["losses"][:3]), \
        statistics.mean(r["losses"][-3:])
    check(len(r["losses"]) == MRCNN_STEPS >= hi + 2 and tail < head,
          f"maskrcnn: losses {r['losses']}")
    lines.append(_fmt_run("maskrcnn (configs.yml: R50-FPN 800 x 800, 81 "
                          "classes, bf16)", 16, r, "images"))
    profile["maskrcnn"] = {k: v for k, v in r.items() if k != "out"}

    # Mask R-CNN on a COCO tree of the fixtures with polygons: box and mask AP
    n_train, n_val, b = MRCNN_COCO
    root = coco_tree(sorted(FIXTURES.glob("*.jpg")), work / "coco", n_train,
                     n_val, seed=SEED, polygons=True)
    r = _last_two_run("maskrcnn", ["--config-file", cfg_file,
                                   "--data-backend", "coco", "--data-dir",
                                   str(root), "--batch-size", str(b),
                                   "--epochs", "1"], work / "mrcnn_coco")
    done("maskrcnn on COCO", r, zero=False)
    val = r["out"][2]
    check(r["launched"]["resample_normalize"] > 0 and val and set(val) == {
        "val.bbox_mAP", "val.bbox_mAP50", "val.segm_mAP", "val.segm_mAP50"}
        and all(0.0 <= v <= 1.0 for v in val.values()),
        f"maskrcnn on COCO: val {val}, {r['launched']}")
    lines.append(
        f"maskrcnn --data-backend coco (800 x 800, B={b}, {n_train} train "
        f"and {n_val} val images, the fixtures' JPEGs with a diamond polygon "
        f"a box): loss " + " ".join(f"{x:.4f}" for x in r["losses"])
        + "; val " + ", ".join(f"{k} {v:.5f}" for k, v in val.items())
        + f"; resample_normalize launched {r['launched']['resample_normalize']}"
        f" times; {r['wall']:.1f} s")
    profile["maskrcnn_coco"] = {"losses": r["losses"], "val": val}

    # the SE(3)-Transformer through the CLI, then at the reference's width
    r = _last_two_run("se3-transformer", ["--batch-size", str(SE3_CLI_B),
                                          "--steps-per-epoch", "8", "--lr",
                                          "3e-3"], work / "se3")
    done("se3-transformer", r)
    lines.append(_fmt_run("se3-transformer (4 layers, degrees 0-2, 16 "
                          "channels, 12 atoms)", SE3_CLI_B, r, "molecules"))
    profile["se3-transformer"] = {k: v for k, v in r.items() if k != "out"}

    b, n, steps = SE3_FULL
    _reset_counts()  # this path starts here
    torch.cuda.reset_peak_memory_stats()
    task = SE3RegressionTask(SE3Config())
    model = task.init(torch.Generator().manual_seed(SEED), DEV)
    tx = adam(1e-3)
    state = create_train_state(model, tx, SEED)
    step = make_train_step(task.loss_fn, tx)
    rng = np.random.default_rng(SEED)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32) * 2
    d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1) \
        + np.eye(n) * 1e9
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in {
        "positions": pos, "species": np.eye(6, dtype=np.float32)[
            rng.integers(0, 6, (b, n))], "mask": np.ones((b, n), np.float32),
        "target": ((1.0 / np.maximum(d, 0.5)).sum(axis=(1, 2)) * 0.05
                   ).astype(np.float32)}.items()}
    ms, losses = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    launched = _counts()
    check(launched == dict.fromkeys(launched, 0) and all(
        map(math.isfinite, losses)), f"se3 full width: {launched}, {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    lines.append(
        f"SE3RegressionTask(SE3Config()) (7 layers, degrees 0-3, 32 channels,"
        f" 8 heads) B={b} N={n}: loss " + " ".join(f"{x:.4f}" for x in losses)
        + f"; steps {', '.join(f'{x:.1f}' for x in ms)} ms (CUDA events; "
        f"the first builds), peak {peak:.1f} GB")
    profile["se3_full"] = {"batch": b, "atoms": n, "step_ms": ms,
                           "losses": losses, "peak_gb": peak}
    del state, model, step, batch
    torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "phase29.json").write_text(json.dumps(profile, indent=1,
                                                     default=str))
    say("29 Mask R-CNN and SE(3)", f"on {card()}: " + "; ".join(lines)
        + f". K1-K6 launched 0 times on these paths "
        f"({time.perf_counter() - t0:.1f} s)")
    return total


# -- phase 30 ----------------------------------------------------------------

# Requests sent at once to each endpoint (3 to BART and Mask R-CNN, the
# slowest dispatches; ``tools/profile_serving.served_endpoints`` builds them)
SERVE_REQUESTS = 4
# A served answer against the endpoint's function on that request alone,
# padded with the batcher's zero rows to the bucket its dispatch ran at: the
# same shapes run the same kernels and every row's result is its own, so
# integers are equal and floats within this share of the largest entry
TOL_SERVE_DIRECT = 1e-6
# Where two best beams' tokens differ: their length-normalised scores by
# float64 teacher forcing on the CPU (``_rescore64``), relative
TOL_SERVE_RESCORE = 1e-4
# The reference QuartzNet's features of 16 kHz audio: 20 ms windows, 10 ms
# hops, a 512-point FFT, 64 mels
STREAM_MEL = MelConfig(sampling_rate=16000, n_fft=512, hop_length=160,
                       win_length=320, n_mels=64, fmax=8000.0)
STREAM_SAMPLES, STREAM_IDS, STREAM_CHUNKS = 4 * 16000, 3, 8
# ``tests/test_streaming_asr.py``'s Jasper and window (chunk, context), and
# its limit on the windowed against the full-utterance log-probabilities,
# absolute, where a window has its whole right context. The flush's last
# (chunk + context) / stride frames differ by design (the full forward's
# zero padding against a window's real frames past the end); the test's 0.5
# there is a reading on its own weights, so here the tail is read, not held
STREAM_EXACT_CFG = JasperConfig(n_mels=64, vocab_size=12, blocks=(
    JasperBlock(1, 32, 5, 0.0, residual=False, stride=2),
    JasperBlock(2, 32, 5, 0.0),
    JasperBlock(1, 48, 1, 0.0, residual=False)))
STREAM_EXACT_WINDOW = (16, 16)
TOL_STREAM_EXACT = 1e-4


def _row_key(inputs: dict) -> bytes:
    return b"".join(np.ascontiguousarray(inputs[k]).tobytes()
                    for k in sorted(inputs))


def _spy_buckets(ep) -> dict:
    """Wraps the batcher's model call to note the bucket each row ran at:
    {row key: bucket}."""
    seen: dict[bytes, int] = {}
    fn = ep.batcher.infer_fn

    def spy(batch):
        b = next(iter(batch.values())).shape[0]
        for i in range(b):
            seen[_row_key({k: v[i] for k, v in batch.items()})] = b
        return fn(batch)

    ep.batcher.infer_fn = spy
    return seen


def _direct(ep, req: dict, bucket: int) -> dict:
    """The endpoint's function on ``req`` alone, padded with the batcher's
    zero rows to ``bucket``: row 0 of each output, numpy."""
    batch = {k: np.concatenate([v[None], np.zeros((bucket - 1, *v.shape),
                                                   v.dtype)])
             for k, v in req.items()}
    return {k: v[0] for k, v in ep.batcher._run(batch).items()}


def _beams_tie(model, req: dict, got, want) -> bool:
    """Two best beams of one request score within TOL_SERVE_RESCORE of
    each other by float64 teacher forcing on the CPU."""
    model64 = _float64(copy.deepcopy(model).cpu())
    seqs = torch.from_numpy(np.stack([got, want]).astype(np.int64))[None]
    scores = _rescore64(model64, req["src"][None].astype(np.int64), seqs, 2,
                        model.cfg)[0]
    return float((scores[0] - scores[1]).abs()) <= TOL_SERVE_RESCORE * float(
        scores.abs().max())


def _serve_one(server, ep, reqs, binary, per_dispatch, model) -> tuple:
    """One endpoint's requests sent at once with the counts set to 0 just
    before; each answer against the direct call at its bucket. Returns
    (the line, the launches)."""
    seen = _spy_buckets(ep)
    ep.batcher.warmup(reqs[0])  # first launches before serving
    seen.clear()
    results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []

    def client(i):
        try:
            t = time.perf_counter()
            results[i] = http_infer(server.addr, ep.name, reqs[i],
                                    binary=binary)["outputs"]
            lat[i] = (time.perf_counter() - t) * 1e3
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    ep.batcher.stats(reset=True)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    _reset_counts()  # this endpoint's traffic starts here
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    launched = _counts()
    check(not any(t.is_alive() for t in threads), f"{ep.name}: hung")
    if errors:
        raise errors[0]
    stats = ep.batcher.stats()
    want = {**dict.fromkeys(launched, 0),
            **{k: v * stats["dispatches"] for k, v in per_dispatch.items()}}
    check(launched == want, f"{ep.name}: launched {launched}, want {want}")
    worst, ties = 0.0, 0
    for req, res in zip(reqs, results):
        direct = _direct(ep, req, seen[_row_key(req)])
        check(set(res) == set(direct) == set(ep.output_names),
              f"{ep.name}: outputs {sorted(res)}")
        for name, w in direct.items():
            got = np.asarray(res[name], w.dtype)
            check(got.shape == w.shape, f"{ep.name} {name}: {got.shape}")
            if w.dtype.kind not in "biu":
                top = max(float(np.abs(w).max()), 1e-30)
                worst = max(worst, float(np.abs(got - w).max()) / top)
            elif name == "tokens" and not np.array_equal(got, w):
                check(_beams_tie(model, req, got, w),
                      f"{ep.name}: best beams differ and do not tie")
                ties += 1
            else:
                check(np.array_equal(got, w), f"{ep.name}: {name} differs")
    check(worst <= TOL_SERVE_DIRECT, f"{ep.name}: served vs direct {worst}")
    counts = ", ".join(f"{k} {v}" for k, v in launched.items() if v)
    line = (f"{ep.name} ({len(reqs)} {'binary' if binary else 'JSON'}): "
            f"latency p50 {np.percentile(lat, 50):.1f} p99 "
            f"{np.percentile(lat, 99):.1f} ms, device_ms p50 "
            f"{stats['device_ms_p50']:.1f}, {stats['dispatches']} dispatches "
            f"(mean batch {stats['mean_batch']:.2f}), vs direct {worst:.1e}"
            + (f", {ties} tied beams" if ties else "")
            + f"; {counts or 'K1-K6 0'}")
    return line, launched


def _ncf_repository(ep, model, reqs) -> str:
    """The live NCF model through a checkpoint, ``strip_checkpoint`` and
    ``hub.load`` of the repository: its answers the live model's, bit for
    bit."""
    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager(f"{tmp}/ckpt").save(
            3, create_train_state(model, sgd(0.1), SEED))
        other = NcfTask(model.cfg, torch.float32).init(
            torch.Generator().manual_seed(SEED + 1), DEV)
        strip_checkpoint(f"{tmp}/ckpt", create_train_state(other, sgd(0.1),
                                                           SEED),
                         f"{tmp}/repo", "ncf", ep.input_spec)
        loaded = hub.load("ncf", pretrained=f"{tmp}/repo/ncf", device=DEV,
                          cfg=model.cfg, dtype=torch.float32)
    ep2 = speech_recipes.ncf_endpoint(NcfTask(model.cfg, torch.float32),
                                      loaded, name="ncf_repository")
    try:
        for req in reqs:
            a, b = _direct(ep, req, 1), _direct(ep2, req, 1)
            check(all(np.array_equal(a[k], b[k]) for k in a),
                  "ncf: the repository's answers differ from the live model's")
    finally:
        ep2.batcher.close()
    return (f"ncf through strip_checkpoint and hub.load of the repository: "
            f"{len(reqs)} answers equal to the live model's")


def _receptive_field(cfg) -> int:
    """Input frames one output frame of a Jasper/QuartzNet sees."""
    rf, step = 1, 1
    for blk in cfg.blocks:
        rf += blk.repeats * (blk.kernel - 1) * blk.dilation * step
        step *= blk.stride
    return rf


def _windowed(infer, mel: np.ndarray, chunk: int, context: int,
              stride: int) -> np.ndarray:
    """The log-probabilities the server's windows give (JAX's test's loop):
    each chunk evaluated with ``context`` frames each side, the kept bands
    concatenated."""
    emitted, bands, t = 0, [], mel.shape[0]
    while emitted < t:
        take = min(chunk, t - emitted)
        start = max(emitted - context, 0)
        ctx = emitted - start
        w = mel[start:min(emitted + take + context, t)]
        pad = 2 * context + chunk - w.shape[0]
        if pad > 0:
            w = np.pad(w, ((0, pad), (0, 0)))
        bands.append(infer(w[None])[0][ctx // stride:-(-(ctx + take)
                                                       // stride)])
        emitted += take
    return np.concatenate(bands)


def _stream_exact(audio: np.ndarray) -> str:
    """``tests/test_streaming_asr.py``'s first check on the card, with its
    small Jasper (stride 2, kernels of 5: a receptive field inside the
    context) at its chunk and context: the windowed log-probabilities equal
    the full utterance's where a window has its whole right context (the
    flush's last frames read), and the server's transcript is their greedy
    decode."""
    task = JasperTask(STREAM_EXACT_CFG, torch.float32)
    model = task.init(torch.Generator().manual_seed(SEED), DEV)
    chunk, context = STREAM_EXACT_WINDOW
    srv = speech_recipes.quartznet_streaming_server(
        task, model, chunk_frames=chunk, context_frames=context,
        mel_cfg=STREAM_MEL)
    s = srv.time_stride
    mel = mel_spectrogram(audio, STREAM_MEL).T
    full = srv.infer_fn(mel[None])[0]
    streamed = _windowed(srv.infer_fn, mel, chunk, context, s)
    exact = (mel.shape[0] - chunk - context) // s
    err = float(np.abs(streamed[:exact] - full[:exact]).max())
    tail = float(np.abs(streamed[exact:] - full[exact:]).max())
    check(streamed.shape == full.shape and err <= TOL_STREAM_EXACT
          and np.isfinite(tail), f"windowed vs full utterance: {err}")
    parts = np.array_split(audio, STREAM_CHUNKS)
    for i, part in enumerate(parts):
        r = srv.process_chunk(0, part, last=i == len(parts) - 1)
    check(r["transcript"] == greedy_ctc_decode(streamed[None])[0],
          "the server's transcript is not its windows' greedy decode")
    return (f"the test's Jasper (receptive field "
            f"{_receptive_field(task.cfg)} frames, chunk {chunk}, context "
            f"{context}) on stream 0: windowed vs full {err:.1e} over "
            f"{exact} frames, {tail:.1e} over the last {full.shape[0] - exact} "
            f"(limit {TOL_STREAM_EXACT:.0e}, the tail read), transcript "
            f"of {len(r['transcript'])} tokens the windows' greedy decode")


def _streaming() -> str:
    """30e: QuartzNet-15x5 behind ``quartznet_streaming_server`` at the
    recipe's chunk and context, 3 interleaved streams: partials prefixes of
    the final transcript, each stream equal to its run alone, K1-K6 0; its
    windowed log-probabilities against the full utterance's (read, not held:
    the receptive field is far wider than the context); then
    ``_stream_exact``."""
    task = JasperTask(QUARTZNET_15x5, torch.float32)
    model = task.init(torch.Generator().manual_seed(SEED), DEV)
    rng = np.random.default_rng(SEED + 31)
    audio = [rng.normal(size=STREAM_SAMPLES).astype(np.float32) * 0.1
             for _ in range(STREAM_IDS)]
    parts = np.array_split(np.arange(STREAM_SAMPLES), STREAM_CHUNKS)
    srv = speech_recipes.quartznet_streaming_server(task, model,
                                                    mel_cfg=STREAM_MEL)
    srv.infer_fn(np.zeros((1, 2 * srv.context_frames + srv.chunk_frames,
                           task.cfg.n_mels), np.float32))  # first launches
    prev, lat = [[] for _ in audio], []
    _reset_counts()  # the streams start here
    for i, part in enumerate(parts):
        for c, a in enumerate(audio):
            t = time.perf_counter()
            r = srv.process_chunk(c, a[part], last=i == len(parts) - 1)
            lat.append((time.perf_counter() - t) * 1e3)
            check(r["transcript"][:len(prev[c])] == prev[c],
                  f"stream {c}: a partial is no prefix of the next")
            prev[c] = r["transcript"]
    launched = _counts()
    check(launched == dict.fromkeys(launched, 0),
          f"streaming launched {launched}")
    check(srv.active_streams == 0, "streams left open")
    alone = speech_recipes.quartznet_streaming_server(task, model,
                                                      mel_cfg=STREAM_MEL)
    for c, a in enumerate(audio):
        for i, part in enumerate(parts):
            r = alone.process_chunk(c, a[part], last=i == len(parts) - 1)
        check(r["transcript"] == prev[c], f"stream {c} differs from its run "
              "alone")
    mel = mel_spectrogram(audio[0], STREAM_MEL).T
    full = srv.infer_fn(mel[None])[0]
    off = float(np.abs(_windowed(srv.infer_fn, mel, srv.chunk_frames,
                                 srv.context_frames, srv.time_stride)
                       - full).max())
    return (f"quartznet_streaming_server (QuartzNet-15x5, chunk "
            f"{srv.chunk_frames}, context {srv.context_frames}), "
            f"{STREAM_IDS} interleaved 4 s 16 kHz streams in {STREAM_CHUNKS} "
            f"chunks: chunk latency p50 {np.percentile(lat, 50):.1f} p99 "
            f"{np.percentile(lat, 99):.1f} ms, transcripts of "
            f"{[len(p) for p in prev]} tokens, partials prefixes, each stream "
            f"its run alone, K1-K6 0; its windows vs the full utterance "
            f"{off:.2f} (receptive field {_receptive_field(task.cfg)} frames "
            f"against {mel.shape[0]}); " + _stream_exact(audio[0]))


def phase_serving_all() -> dict[str, int]:
    """30: the nine recipes on the card; returns the launches of the
    endpoints' traffic."""
    t0 = time.perf_counter()
    models = profile_serving.served_endpoints(DEV, SEED, SERVE_REQUESTS)
    server = InferenceServer("127.0.0.1", 0)
    for ep, *_ in models:
        server.register(ep)
    server.start()
    lines, total = [], dict.fromkeys(_counts(), 0)
    try:
        for ep, reqs, binary, per_dispatch, model in models:
            line, launched = _serve_one(server, ep, reqs, binary,
                                        per_dispatch, model)
            lines.append(line)
            for k, v in launched.items():
                total[k] += v
            if ep.name == "ncf":
                lines.append(_ncf_repository(ep, model, reqs))
    finally:
        server.stop()
    del models
    torch.cuda.empty_cache()
    lines.append(_streaming())
    say("30 serving", f"on {card()}, fp32, TF32 off: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.1f} s)")
    return total


# -- phase 31 ----------------------------------------------------------------

SEQ_STEPS = 3
SEQ_B = 8  # bert-pretrain --phase2's batch here: S=512, 76 predictions
# 31a: the ring run (two gloo ranks, --mesh-sequence 2) against the one-rank
# --attention-impl flash run (K1/K2) of the same seed and batches on rank 0,
# and against the one-rank ring run (--mesh-sequence 1: one block) on rank
# 1, bf16: each loss relative to the one rank's, and ||p(ring) - p(one)||
# over ||p(one) - p(before)||, as 27b reads its runs. The ring's blocks are
# fp32 where K1 rounds P to bf16, and the third step at lr 0.006 jumps (to
# about 15), so the flash run's limits are loose; the one-rank ring differs
# only in how the online softmax splits the keys, but a bf16 model rounds
# any difference to a bf16 step. Limits between the sound readings and those
# of planted faults (scripts/ring_fault_check.py, NVIDIA H100 80GB HBM3, 700
# W; deterministic, equal in three runs): sound loss 5.8e-4 / 3.2e-4 (flash /
# one-rank ring), parameters 6.4% / 6.4% of their move; the ring's dropout on
# local positions 1.6e-3 / 1.7e-3, 14.7% / 14.6%; a rank-seeded generator
# 2.2e-3 / 4.6e-2, 52% / 92% (and the ranks' parameters differ)
TOL_SEQ = {"loss": 1e-3, "param_of_move": 0.1,
           "ring_loss": 8e-4, "ring_param_of_move": 0.1}
RING_SHAPE = (8, 16, 512, 64)  # B, H, S, D: BERT-Large's attention at S=512
# 31b, fp32, TF32 off, against mha_reference on one rank: the output's
# largest difference, each gradient's over its largest entry
TOL_RING = (1e-5, 1e-4)
# a stage's layers, the microbatches, their rows and length
PIPE_LAYERS, PIPE_M, PIPE_B, PIPE_S = 12, 4, 4, 512
# 31c, fp32, TF32 off: the pipe's output and its stage's gradients against
# the stages run one after another on the rank, each over its largest entry
# (the gradients sum the microbatches in another order)
TOL_PIPE = (1e-6, 1e-5)
# 31d: Switch-Base-8's expert layer (Fedus et al. 2021, google/switch-base-8)
MOE_WIDTH = dict(d_model=768, d_ff=3072, num_experts=8, capacity_factor=1.25)
MOE_B, MOE_T, MOE_REF_T = 8, 512, 128
# fp32, TF32 off, each over the largest entry: the layer against
# moe_reference at T=128 and against itself in float64 on the CPU at T=512;
# 4 experts a rank against all 8 on one, forward and gradients
TOL_MOE = {"reference": 1e-5, "float64": 1e-5, "world": 1e-5}


def _digest(model) -> str:
    """A hash of the parameters' bytes: two ranks' models equal bit for
    bit have the same."""
    h = hashlib.blake2b()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over ``b``'s largest entry."""
    return max_err(a, b) / max(float(b.double().abs().max()), 1e-30)


def _seq_cli(work: Path) -> dict:
    """31a: ``bert-pretrain --phase2 --attention-impl ring --mesh-data 1
    --mesh-sequence 2`` through the CLI's start-up and builder, SEQ_STEPS
    steps on CUDA events; then, side by side, rank 0 the one-rank
    ``--attention-impl flash`` run of the same seed and batches and rank 1
    the one-rank ring run."""
    cfg = cli_main.BertCliConfig(
        bert_model="large", phase2=True, attention_impl="ring", mesh_data=1,
        mesh_sequence=2, batch_size=SEQ_B, steps_per_epoch=10,
        lr=float(PRETRAIN_LR), workspace=str(work), device=DEV)
    cli_main._common_setup(cfg, "bert_pretrain")
    m = pmesh.current_mesh()
    run = cli_main.build_bert_pretrain(cfg)
    first = _whole(run)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the ring's training path starts here
    losses, ms = _mesh_steps(run, cfg, SEQ_STEPS)
    torch.cuda.synchronize()
    got = {"losses": losses, "ms": ms, "launched": _counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "shape": m.shape, "backend": torch.distributed.get_backend(),
           "digest": _digest(run.state.model)}
    # the one-rank runs of the same seed and batches, one a rank, side by
    # side: rank 0 the flash path (K1/K2), rank 1 the ring on one block
    params = _whole(run)
    del run
    torch.cuda.empty_cache()
    pmesh.reset_mesh()
    ref_cfg = dataclasses.replace(
        cfg, attention_impl="flash" if m.is_primary else "ring",
        mesh_sequence=1)
    ref = cli_main.build_bert_pretrain(ref_cfg)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    got["ref_losses"], got["ref_ms"] = _mesh_steps(ref, ref_cfg, SEQ_STEPS)
    torch.cuda.synchronize()
    got["ref_launched"] = _counts()
    got["ref_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    want = _whole(ref)
    got["param_diff"] = _norm(params, want)
    got["param_move"] = _norm(first, want)
    del ref, want, params, first
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return got


def _seq_ring_op() -> dict:
    """31b: ``ring_attention`` on the sequence line at BERT-Large's shape,
    fp32, a key mask, contiguous and causal zigzag, with and without
    dropout; rank 0 holds each against ``mha_reference`` (forward, and the
    gradients of ``sum(out * g)``)."""
    m = pmesh.build_mesh(pmesh.MeshSpec(data=1, sequence=2))
    gen = torch.Generator().manual_seed(SEED + 31)
    b, h, s, d = RING_SHAPE
    q, k, v, g = (torch.randn(RING_SHAPE, generator=gen).to(DEV)
                  for _ in range(4))
    lengths = torch.randint(s // 2, s + 1, (b,), generator=gen)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(DEV)
    cases = {"contiguous": {}, "contiguous dropout 0.1": dict(
                 dropout_rate=0.1, dropout_seed=-31),
             "zigzag causal": dict(causal=True, zigzag=True),
             "zigzag causal dropout 0.1": dict(causal=True, zigzag=True,
                                               dropout_rate=0.1,
                                               dropout_seed=-31)}
    got = {}
    for name, kw in cases.items():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_attention(qq, kk, vv, mask, **kw)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = _counts()
        if m.is_primary:
            rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
            kw_ref = {key: val for key, val in kw.items() if key != "zigzag"}
            ref = fa.mha_reference(rq, rk, rv, mask, **kw_ref)[0]
            (ref * g).sum().backward()
            got[name] = {"fwd": max_err(out, ref), "ms": ms,
                         "launched": launched,
                         "bwd": max(_rel_max(a.grad, r.grad) for a, r in
                                    ((qq, rq), (kk, rk), (vv, rv)))}
            del ref, rq, rk, rv
        del out, qq, kk, vv
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return got


class _Trunk(torch.nn.Module):
    """PIPE_LAYERS BERT-Large layers (plain attention, no dropout) on one
    key mask: a pipeline stage."""

    def __init__(self, key_mask: torch.Tensor):
        super().__init__()
        cfg = dataclasses.replace(BERT_CONFIGS["large"], attention_impl="xla")
        self.layer = torch.nn.ModuleList(
            BertLayer(cfg, torch.float32) for _ in range(PIPE_LAYERS))
        self.key_mask = key_mask

    def forward(self, x):
        for layer in self.layer:
            x = layer(x, self.key_mask)
        return x


def _seq_pipeline() -> dict:
    """31c: ``pipeline_apply`` over the model axis, 2 stages of PIPE_LAYERS
    BERT-Large layers, PIPE_M microbatches of PIPE_B x PIPE_S, fp32, remat off
    and on: the output and this rank's stage's gradients of ``sum(y * g)``
    against the stages run one after another (microbatch by microbatch),
    the peak memory of each."""
    m = pmesh.build_mesh(pmesh.MeshSpec(data=1, model=2))
    st = m.index(pmesh.MODEL_AXIS)
    gen = torch.Generator().manual_seed(SEED + 32)
    hidden = BERT_CONFIGS["large"].hidden_size
    mask = torch.ones(PIPE_B, PIPE_S, dtype=torch.int32)
    mask[:, PIPE_S * 7 // 8:] = 0  # padding
    trunks = []
    dgen = torch.Generator(device=DEV).manual_seed(SEED + 32)
    for _ in range(2):  # drawn on the card: the host draws 300M normals slowly
        trunk = _Trunk(mask.to(DEV)).to(DEV)
        init_bert_weights_(trunk, dgen, BERT_CONFIGS["large"].initializer_range)
        trunks.append(trunk)
    stacked = stack_stage_params([dict(t.named_parameters()) for t in trunks])
    x = torch.randn(PIPE_M, PIPE_B, PIPE_S, hidden, generator=gen).to(DEV)
    g = torch.randn(x.shape, generator=gen).to(DEV)
    got: dict = {"stage": st}
    outs = {}
    for remat in (False, True):
        key = "remat" if remat else "plain"
        got[key] = {"ms": [], "launched": dict.fromkeys(_counts(), 0)}
        for _ in range(2):  # the first call pays for first uses (kernels, imports)
            params = {k: v.clone().requires_grad_() for k, v in stacked.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            y = pipeline_apply(trunks[0], params, x, remat=remat)
            (y * g).sum().backward()
            torch.cuda.synchronize()
            got[key]["ms"].append((time.perf_counter() - t0) * 1e3)
            got[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            for k, v in _counts().items():
                got[key]["launched"][k] += v
            outs[key] = (y.detach(), {k: p.grad[st] for k, p in params.items()})
            del params, y
            torch.cuda.empty_cache()
    seq = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    ys = []
    for mb in range(PIPE_M):  # the stages one after another
        h = x[mb]
        for s in range(2):
            h = torch.func.functional_call(
                trunks[0], {k: v[s] for k, v in seq.items()}, (h,))
        (h * g[mb]).sum().backward()
        ys.append(h.detach())
    want_y = torch.stack(ys)
    for key, (y, grads) in outs.items():
        got[key]["fwd"] = _rel_max(y, want_y)
        got[key]["bwd"] = max(_rel_max(grads[k], seq[k].grad[st])
                              for k in grads)
    del seq, ys, outs, trunks, stacked
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return got


def _moe_grads(layer, x) -> tuple:
    xg = x.clone().requires_grad_()
    y, aux = layer(xg)
    ((y ** 2).mean() + 0.01 * aux).backward()
    return y.detach(), float(aux.detach()), xg.grad, {
        n: p.grad for n, p in layer.named_parameters()}


def _seq_moe() -> dict:
    """31d: ``MoEFeedForward`` at Switch-Base-8's width, top-1 and top-2,
    B=MOE_B T=MOE_T, fp32: the whole layer on one rank (rank r holds the
    top-(r+1) layer against ``moe_reference`` at T=MOE_REF_T and against
    itself in float64 on the CPU), then 4 experts a rank on the model axis
    against it, forward and the gradients of ``mean(y^2) + 0.01 aux``."""
    rank = pmesh.current_mesh().rank
    gen = torch.Generator().manual_seed(SEED + 33)
    x = torch.randn(MOE_B, MOE_T, MOE_WIDTH["d_model"], generator=gen)
    xd = x.to(DEV)
    got = {}
    for k in (1, 2):
        cfg = MoEConfig(**MOE_WIDTH, router_top_k=k)
        pmesh.reset_mesh()
        whole = MoEFeedForward(cfg, generator=torch.Generator().manual_seed(
            SEED + 34)).to(DEV)
        r: dict = {"capacity": moe_capacity(cfg, MOE_T)}
        if rank == k - 1:
            with torch.no_grad():
                y = whole(xd)[0]
                short = xd[:, :MOE_REF_T]
                r["reference"] = _rel_max(whole(short)[0], moe_reference(
                    dict(whole.named_parameters()), short, cfg))
                layer64 = copy.deepcopy(whole).to("cpu", torch.float64)
                y64 = layer64(x.double())[0]
                r["float64"] = _rel_max(y.cpu().double(), y64)
                del layer64, y64, y
        _reset_counts()
        y1, aux1, dx1, g1 = _moe_grads(whole, xd)
        m = pmesh.build_mesh(pmesh.MeshSpec(data=1, model=2))
        part = MoEFeedForward(cfg, generator=torch.Generator().manual_seed(
            SEED + 34)).to(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y2, aux2, dx2, g2 = _moe_grads(part, xd)
        torch.cuda.synchronize()
        r["ms"] = (time.perf_counter() - t0) * 1e3
        r["launched"] = _counts()
        r["experts"] = part.wi.shape[0]
        r["world"] = max(
            _rel_max(y2, y1), abs(aux2 - aux1) / abs(aux1), _rel_max(dx2, dx1),
            _rel_max(g2["router.weight"], g1["router.weight"]),
            *(_rel_max(g2[n], g1[n][part.lo:part.hi]) for n in ("wi", "wo")))
        got[f"top{k}"] = r
        del whole, part, g1, g2
        torch.distributed.barrier(m.groups[pmesh.MODEL_AXIS])
    torch.cuda.empty_cache()
    return got


def _seq_child(names: list[str] | None = None) -> None:
    """A rank of phase 31 (two ranks on the card over gloo, this script
    under ``torchrun --nproc-per-node 2``): prints one ``MESH {...}`` line a
    part (``names``: these of a, b, c, d only)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets
    torch.backends.cudnn.allow_tf32 = False
    # the first torch.utils.checkpoint and the first autograd.grad with a
    # cotangent import torch's compiler stack (torch._dynamo, DTensor,
    # sympy), about 10 s a process on the card's host: on a thread of its
    # own while 31a trains
    threading.Thread(target=lambda: [importlib.import_module(m) for m in (
        "torch._dynamo", "torch.distributed.tensor")], daemon=True).start()
    work = Path(tempfile.mkdtemp(prefix="seq_"))
    out = {"rank": int(os.environ.get("RANK", 0))}
    parts = {"a": lambda: _seq_cli(work), "b": _seq_ring_op,
             "c": _seq_pipeline, "d": _seq_moe}
    for name in names or list(parts):
        t0 = time.perf_counter()
        got = parts[name]()
        got["seconds"] = time.perf_counter() - t0
        sys.stdout.write("MESH " + json.dumps({**out, name: got}) + "\n")
        sys.stdout.flush()
    shutil.rmtree(work, ignore_errors=True)
    torch.distributed.destroy_process_group()


def phase_sequence() -> None:
    """31: the sequence axis, GPipe and MoE over two gloo ranks on the card
    (one ``torchrun --nproc-per-node 2`` of this script's ``--mesh 31``):
    31a ``bert-pretrain --phase2 --attention-impl ring --mesh-sequence 2``
    against the one-rank flash run, 31b the ring op against
    ``mha_reference``, 31c ``pipeline_apply`` against the stages in turn,
    31d the expert-parallel ``MoEFeedForward`` against the whole layer. No
    K1-K6 launch on any of their paths."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # four host threads a rank (torchrun's default is one): the ranks draw
    # BERT-Large's weights on the host and run 31d's float64 layer there
    proc = _torchrun("31", 2, DLX_DIST_BACKEND="gloo", OMP_NUM_THREADS="4")
    try:
        r0, r1 = _ranks("31", proc, 2, 900)
    finally:  # neither the launcher nor its ranks outlive the phase
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    none = dict.fromkeys(_counts(), 0)
    fails: list[str] = []  # every reading is printed before a check fails

    def want(ok: bool, what: str) -> None:
        if not ok:
            fails.append(what)

    a = r0["a"]
    want(a["backend"] == "gloo" and a["shape"] == {"data": 1, "model": 1,
                                                   "sequence": 2},
         f"31a: {a['backend']} on {a['shape']}")
    want(r0["a"]["losses"] == r1["a"]["losses"]
         and r0["a"]["digest"] == r1["a"]["digest"],
         f"31a: the sequence ranks differ: losses {r0['a']['losses']} "
         f"{r1['a']['losses']}, parameters {r0['a']['digest'][:16]} "
         f"{r1['a']['digest'][:16]}")
    want(a["launched"] == none and r1["a"]["launched"] == none,
         f"31a: the ring run launched {a['launched']}")
    want(a["ref_launched"]["flash_fwd"] == LAYERS * SEQ_STEPS
         and r1["a"]["ref_launched"] == none,
         f"31a: the one-rank runs launched {a['ref_launched']}, "
         f"{r1['a']['ref_launched']}")
    (loss, of_move), (ring_loss, ring_of_move) = (
        (max(abs(x - y) / abs(y) for x, y in zip(r["losses"], r["ref_losses"])),
         r["param_diff"] / r["param_move"]) for r in (a, r1["a"]))
    want(loss <= TOL_SEQ["loss"] and of_move <= TOL_SEQ["param_of_move"],
         f"31a: losses {a['losses']} vs flash {a['ref_losses']} ({loss:.3e}),"
         f" parameters {of_move:.3e} of their move")
    want(ring_loss <= TOL_SEQ["ring_loss"]
         and ring_of_move <= TOL_SEQ["ring_param_of_move"],
         f"31a: losses {a['losses']} vs the one-rank ring's "
         f"{r1['a']['ref_losses']} ({ring_loss:.3e}), parameters "
         f"{ring_of_move:.3e} of their move")
    lines = [
        f"31a bert-pretrain --phase2 --attention-impl ring --mesh-data 1 "
        f"--mesh-sequence 2 (BERT-Large, B={SEQ_B} S=512, bf16, dropout 0.1, "
        f"lr {PRETRAIN_LR}): losses " + " ".join(f"{x:.4f}" for x in a["losses"])
        + " vs one-rank flash " + " ".join(f"{x:.4f}" for x in a["ref_losses"])
        + f" ({loss:.3e} relative, within {TOL_SEQ['loss']}); parameters "
        f"{of_move:.3e} of their move apart (within "
        f"{TOL_SEQ['param_of_move']}); against the one-rank ring "
        + " ".join(f"{x:.4f}" for x in r1["a"]["ref_losses"])
        + f" {ring_loss:.3e} and {ring_of_move:.3e} (within "
        f"{TOL_SEQ['ring_loss']}, {TOL_SEQ['ring_param_of_move']}); the two "
        "ranks' parameters equal bit for bit; step "
        f"{_median_ms(a['ms']):.1f} ms on CUDA events (one-rank flash "
        f"{_median_ms(a['ref_ms']):.1f} ms, one-rank ring "
        f"{_median_ms(r1['a']['ref_ms']):.1f} ms, beside each other); peak "
        f"{a['peak_gb']:.2f} GB on rank 0, {r1['a']['peak_gb']:.2f} GB on "
        f"rank 1 (one-rank flash {a['ref_peak_gb']:.2f} GB, ring "
        f"{r1['a']['ref_peak_gb']:.2f} GB); K1-K6 0 launches "
        f"({a['seconds']:.1f} s)"]
    parts = []
    for name, c in r0["b"].items():
        if name == "seconds":
            continue
        want(c["fwd"] <= TOL_RING[0] and c["bwd"] <= TOL_RING[1]
             and c["launched"] == none,
             f"31b {name}: forward {c['fwd']:.3e}, gradients {c['bwd']:.3e}"
             f", launches {c['launched']}")
        parts.append(f"{name} {c['fwd']:.2e} / {c['bwd']:.2e} "
                     f"({c['ms']:.1f} ms)")
    lines.append(f"31b ring_attention fp32 B, H, S, D = {RING_SHAPE} masked, "
                 "forward / gradients against mha_reference on rank 0 (limits "
                 f"{TOL_RING}), fwd+bwd ms on the host clock: "
                 + ", ".join(parts) + f" ({r0['b']['seconds']:.1f} s)")
    parts = []
    for r in (r0, r1):
        c = r["c"]
        for key in ("plain", "remat"):
            want(c[key]["fwd"] <= TOL_PIPE[0] and c[key]["bwd"] <= TOL_PIPE[1]
                 and c[key]["launched"] == none,
                 f"31c stage {c['stage']} {key}: forward {c[key]['fwd']:.3e},"
                 f" gradients {c[key]['bwd']:.3e}, {c[key]['launched']}")
        parts.append(f"stage {c['stage']}: forward {c['plain']['fwd']:.2e} / "
                     f"{c['remat']['fwd']:.2e}, gradients "
                     f"{c['plain']['bwd']:.2e} / {c['remat']['bwd']:.2e}, "
                     f"fwd+bwd {c['plain']['ms'][1]:.0f} / "
                     f"{c['remat']['ms'][1]:.0f} ms (first calls "
                     f"{c['plain']['ms'][0]:.0f} / {c['remat']['ms'][0]:.0f}),"
                     f" peak {c['plain']['peak_gb']:.2f} / "
                     f"{c['remat']['peak_gb']:.2f} GB")
    lines.append(f"31c pipeline_apply 2 stages x {PIPE_LAYERS} BERT-Large "
                 f"layers, M={PIPE_M} of B={PIPE_B} S={PIPE_S}, fp32, without / "
                 "with remat, against the stages in turn (limits "
                 f"{TOL_PIPE}): " + "; ".join(parts)
                 + f" ({r0['c']['seconds']:.1f} s)")
    parts = []
    for k in (1, 2):
        own = (r0, r1)[k - 1]["d"][f"top{k}"]
        for r in (r0, r1):
            c = r["d"][f"top{k}"]
            want(c["world"] <= TOL_MOE["world"] and c["experts"] == 4
                 and c["launched"] == none,
                 f"31d top-{k}: world 2 {c['world']:.3e}, "
                 f"{c['experts']} experts, {c['launched']}")
        want(own["reference"] <= TOL_MOE["reference"]
             and own["float64"] <= TOL_MOE["float64"],
             f"31d top-{k}: reference {own['reference']:.3e}, float64 "
             f"{own['float64']:.3e}")
        parts.append(f"top-{k} (capacity {own['capacity']}): moe_reference "
                     f"{own['reference']:.2e}, float64 {own['float64']:.2e}, "
                     f"world 2 {max(r['d'][f'top{k}']['world'] for r in (r0, r1)):.2e}"
                     f", fwd+bwd {r0['d'][f'top{k}']['ms']:.1f} ms")
    lines.append(f"31d MoEFeedForward {MOE_WIDTH}, B={MOE_B} T={MOE_T} fp32, "
                 "4 experts a rank (limits " + str(TOL_MOE) + "): "
                 + "; ".join(parts) + f" ({r0['d']['seconds']:.1f} s)")
    say("31 sequence, pipeline, MoE", f"two gloo ranks on {card()}: "
        + "; ".join(lines) + f"; {time.perf_counter() - t0:.1f} s")
    check(not fails, "31: " + "; ".join(fails))

# -- phase 32 ----------------------------------------------------------------

# 32: the seventeen commands PR 14 left on one rank, each through the CLI at
# --mesh-data 2 (two gloo ranks on the card), at the CLI's widths, a global
# batch of 4, fp32 with TF32 off, 2 steps, against the one-rank run of the
# same global batches (in the phase's own process, beside the ranks), as
# tests/test_torch_parallel_families.py holds them on the CPU. bart
# (summarize) and tft train on their data's batches, of which --prof takes
# the first two, then score the beam-decoded val split and the test split.
# The CLI's synthetic batches give every row as many targets (bart's
# summaries are 7 tokens each, transformer's and gnmt's rows have no pads),
# so "transformer-padded" runs `transformer` with its target rows cut to
# FAMILY_TARGETS tokens: rank 0 holds 117 targets, rank 1 28.
FAMILIES = ("tacotron2", "waveglow", "transformer", "bart", "gnmt",
            "fastpitch", "hifigan", "jasper", "wav2vec2", "ncf", "tft",
            "nnunet", "transformer-xl", "moflow", "se3-transformer",
            "efficientdet", "maskrcnn", "transformer-padded")
FAMILY_TARGETS = (64, 55, 20, 10)  # transformer-padded: BOS ... EOS a row
# Cut for time (PERF.md §4): transformer-xl at 4 of its 16 layers, waveglow
# at 8 of its 12 flows, wav2vec2 at 4 of its 12 layers, gnmt at 2 of its 4,
# tacotron2's synthetic mels at 200 of their 600 frames; and no run writes
# its checkpoint (phases 20-31 write and read them)
FAMILY_CUTS = {"transformer_xl_layers": 4, "waveglow_flows": 8,
               "wav2vec2_layers": 4, "gnmt_layers": 2, "tacotron2_frames": 200}
FAMILY_B, FAMILY_STEPS = 4, 2
FAMILY_FLAGS = {"bart": ["--prof", "2"], "tft": ["--prof", "2"]}
FAMILY_ATTENTION = ("transformer", "bart", "fastpitch", "wav2vec2",
                    "transformer-padded")
# Limits, between the sound readings and those of planted faults
# (scripts/mesh_fault_check.py 32): the first step's loss relative (the CPU
# test's); every step's loss relative; the first step's gradients after the
# data mean, their distance from the one-rank run's over its norm, all
# tensors together; the first step's BN running statistics, of max(1, the
# tensor's largest entry) (the CPU test's); a continuous eval metric
# relative (the CPU test's). The CPU test holds each gradient tensor to
# 1e-5 of its largest entry; on the card a one-rank fp32 step's gradients
# are themselves that far from float64 in their worst tensors (fp32 sums
# that cancel), so two runs whose sums split differently part there too,
# and the card is held on the norm of the whole gradient.
TOL_FAMILY = {"loss": 1e-5, "loss_steps": 2e-3, "grad": 1e-4, "stats": 1e-5,
              "metric": 1e-5}
# the commands whose sound gradients lie further apart (my chip runs 1-2,
# PR 19: transformer 8.1e-5, jasper 4.0e-3, nnunet 1.1e-3, transformer-xl
# 7.8e-4, maskrcnn 6.2e-4; their cuBLAS and cuDNN algorithms differ between
# B=2 and B=4, and Jasper's and Mask R-CNN's BN between flax's E[x^2] -
# E[x]^2 at world 2 and the two-pass native kernel at world 1), about 5x
TOL_FAMILY_GRAD = {"transformer": 5e-4, "transformer-padded": 5e-4,
                   "jasper": 2e-2, "nnunet": 5e-3, "transformer-xl": 5e-3,
                   "maskrcnn": 5e-3}


def _family_argv(name: str, work: Path) -> list[str]:
    return [name.removesuffix("-padded"), "--device", DEV.split(":")[0],
            "--amp", "false", "--batch-size", str(FAMILY_B),
            "--steps-per-epoch", str(FAMILY_STEPS), "--lr", "1e-3",
            "--workspace", str(work), *FAMILY_FLAGS.get(name, [])]


def _padded_transformer(cfg):
    """``cli.main.build_transformer`` with each row's targets cut to
    ``FAMILY_TARGETS`` tokens (BOS, then the source's, EOS, then pads)."""
    run = _REAL_BUILD_TRANSFORMER(cfg)
    batch = dict(run.loader[0])
    tgt = batch["tgt"].copy()
    pad, eos = run.task.cfg.pad_id, run.task.cfg.eos_id
    for i, n in enumerate(FAMILY_TARGETS):
        tgt[i, n - 1], tgt[i, n:] = eos, pad
    run.loader = [{**batch, "tgt": tgt}] * len(run.loader)
    return run


_REAL_BUILD_TRANSFORMER = cli_main.build_transformer


def _family_cuts(stack: contextlib.ExitStack) -> None:
    """``FAMILY_CUTS`` patched into the modules the CLI's builders import
    from when they run."""
    from deeplearningexamples_tpu_torch.data import tts_synthetic
    from deeplearningexamples_tpu_torch.models import (
        transformer_xl, tts, wav2vec2)
    from deeplearningexamples_tpu_torch.models.translation import gnmt

    cut = FAMILY_CUTS
    txl, wg, w2v = (transformer_xl.TransformerXLTask, tts.WaveGlowTask,
                    wav2vec2.Wav2Vec2Task)
    for module, name, new in (
            (gnmt, "GnmtTask", functools.partial(
                gnmt.GnmtTask, gnmt.GnmtConfig(num_layers=cut["gnmt_layers"]))),
            (transformer_xl, "TransformerXLTask", lambda dtype: txl(
                transformer_xl.TransformerXLConfig(
                    n_layers=cut["transformer_xl_layers"]), dtype)),
            (tts, "WaveGlowTask", lambda dtype: wg(
                tts.WaveGlowConfig(n_flows=cut["waveglow_flows"]), dtype)),
            (wav2vec2, "Wav2Vec2Task", lambda dtype: w2v(
                wav2vec2.Wav2Vec2Config(n_layers=cut["wav2vec2_layers"]),
                dtype)),
            (tts_synthetic, "SyntheticTacotronLoader", functools.partial(
                tts_synthetic.SyntheticTacotronLoader,
                max_mel_len=cut["tacotron2_frames"])),
            (CheckpointManager, "save", lambda *a, **k: None)):
        stack.enter_context(mock.patch.object(module, name, new))


def _family_run(argv: list[str], padded: bool = False) -> dict:
    """The CLI on ``argv``: each step's loss, the first step's gradients
    (after the data mean) and BN running statistics (Adam moves a parameter
    whose gradient is 0 but for rounding by the rate, either way: compared
    at the parameters every run starts from), the modules trained, and the
    eval metrics the run logs."""
    from deeplearningexamples_tpu_torch.models.tts import hifigan

    rec: dict = {"losses": [], "grads": None, "stats": {}, "metrics": {}}
    real_loop, real_grads = cli_main.train_loop, hifigan.HiFiGanTask.grads

    def stats(model) -> dict:
        return {n: b.detach().clone() for n, b in model.named_buffers()
                if ".running_" in n or n.startswith("running_")}

    def loop(state, train_step, *a, **kw):
        def step(state, batch):
            state, m = train_step(state, batch)
            rec["losses"].append(float(m["loss"]))
            if rec["grads"] is None:
                rec["grads"] = {n: p.grad.detach().clone() for n, p in
                                state.model.named_parameters()
                                if p.grad is not None}
                rec["stats"] = stats(state.model)
            return state, m
        return real_loop(state, step, *a, **kw)

    def gan_grads(model, loss):  # d_step's, then g_step's
        g = real_grads(model, loss)
        side = "disc" if len(rec.setdefault("gan", [])) % 2 == 0 else "gen"
        if len(rec["gan"]) < 2:
            rec["gan"].append({f"{side}.{n}": t.clone() for n, t in g.items()})
        return g

    with contextlib.ExitStack() as stack:
        _family_cuts(stack)
        for module, name, new in (
                (cli_main, "train_loop", loop),
                (hifigan.HiFiGanTask, "grads", staticmethod(gan_grads)),
                (cli_main, "build_transformer", _padded_transformer if padded
                 else _REAL_BUILD_TRANSFORMER)):
            stack.enter_context(mock.patch.object(module, name, new))
        out = cli(argv)
    if argv[0] == "hifigan":
        gen, disc, metrics = out
        d_grads, g_grads = rec.pop("gan")
        rec["grads"] = {**d_grads, **g_grads}
        rec["losses"] = [metrics["train.d_loss"], metrics["train.g_loss"]]
        rec["metrics"], rec["modules"] = metrics, (gen, disc)
        return rec
    rec["modules"] = (out[0].model,)
    rec["metrics"] = {"bart": out[1] if argv[0] == "bart" else {},
                      "tft": out[-1] if argv[0] == "tft" else {}}.get(
                          argv[0], {})
    return rec


def _one_rank_setup(cfg, name, accum_steps=None):
    """``cli.main._common_setup`` for a one-rank run: the 1 x 1 x 1 mesh
    (no collective, in a process group too) and no logger."""
    pmesh.reset_mesh()
    return cli_main.Logger(backends=[], enabled=False)


def _family_reference(name: str, work: Path) -> dict:
    """The one-rank run of ``name`` (the same seed, flags and global
    batches) and its launches; ``modules`` dropped."""
    with mock.patch.object(cli_main, "_common_setup", _one_rank_setup):
        _reset_counts()
        ref = _family_run(_family_argv(name, work / f"{name}_one"),
                          name.endswith("-padded"))
        ref["launched"] = _counts()
    del ref["modules"]
    return ref


def _await_reference(path: Path, timeout: float = 900.0) -> dict:
    """The reference the phase's process writes to ``path`` (whole, by a
    rename), on this rank's card; the file is removed once read."""
    deadline = time.monotonic() + timeout
    while not path.exists():
        check(time.monotonic() < deadline, f"32: no {path.name} after "
              f"{timeout} s")
        time.sleep(0.05)
    ref = torch.load(path, map_location=DEV, weights_only=False)
    path.unlink()
    return ref


def _grad_diff(got: dict, want: dict) -> tuple[float, float, str]:
    """(``got``'s distance from ``want`` over ``want``'s norm, all tensors
    together; the worst tensor's largest difference over max(its largest
    entry, a tenth of the largest of all), and its name)."""
    top = max(float(w.abs().max()) for w in want.values())
    diff = sum(float((got[n].double() - w.double()).square().sum())
               for n, w in want.items())
    norm = sum(float(w.double().square().sum()) for w in want.values())
    worst = max((max_err(got[n], w) / max(float(w.abs().max()), 0.1 * top), n)
                for n, w in want.items())
    return math.sqrt(diff / norm), *worst


def _family_child(names: list[str] | None = None) -> None:
    """A rank of phase 32 (two ranks on the card over gloo, this script
    under ``torchrun --nproc-per-node 2``): one ``MESH {...}`` line a
    command (``names``: these of ``FAMILIES`` only). Rank 0 holds each run
    against the one-rank run that the phase's process writes to the
    directory ``FAMILY_REFS`` names, or without it runs that itself after
    the data-axis run."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets
    torch.backends.cudnn.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="families_"))
    refs = os.environ.get("FAMILY_REFS")
    out: dict = {"rank": int(os.environ.get("RANK", 0))}
    for name in names or FAMILIES:
        t0 = time.perf_counter()
        argv = _family_argv(name, work / f"{name}_{out['rank']}")
        _reset_counts()  # the command's data-axis run starts here
        rec = _family_run([*argv, "--mesh-data", "2"],
                          name.endswith("-padded"))
        got = {"losses": rec["losses"], "launched": _counts(),
               "digest": hashlib.blake2b(b"".join(
                   bytes.fromhex(_digest(m)) for m in rec["modules"])
               ).hexdigest(),
               "metrics": rec["metrics"], "shape": pmesh.current_mesh().shape,
               "backend": torch.distributed.get_backend()}
        if pmesh.current_mesh().is_primary:
            grads, stats = rec["grads"], rec["stats"]
            del rec
            ref = (_await_reference(Path(refs) / f"{name}.pt") if refs
                   else _family_reference(name, work))
            got["ref_launched"] = ref["launched"]
            got["ref_losses"] = ref["losses"]
            got["ref_metrics"] = ref["metrics"]
            got["grad_err"] = _grad_diff(grads, ref["grads"])
            got["grad_keys"] = sorted(grads) == sorted(ref["grads"])
            got["stats_err"] = max(
                [(max_err(stats[n], w) / max(1.0, float(w.abs().max())), n)
                 for n, w in ref["stats"].items()] or [(0.0, "")])
            got["stats_keys"] = sorted(stats) == sorted(ref["stats"])
            del ref, grads, stats
        else:
            del rec
        torch.cuda.empty_cache()
        torch.distributed.barrier()
        got["seconds"] = time.perf_counter() - t0
        sys.stdout.write("MESH " + json.dumps({**out, name: got}) + "\n")
        sys.stdout.flush()
    shutil.rmtree(work, ignore_errors=True)
    torch.distributed.destroy_process_group()


def _fastpitch_offset() -> float:
    """K1 with FastPitch's attention dropout at a data rank's batch offset:
    rank 1's rows (2 of the global 4) at offset 2 take rows 2.. of the whole
    batch's launch bit for bit (the masks the one-rank run draws for them),
    and agree with the plain version at the offset. Returns that error."""
    fcfg = FastPitchConfig()
    q, k, v, mask = _attn_inputs(FAMILY_B, 32, fcfg.n_heads, fcfg.head_dim,
                                 torch.float32, "bshd")
    kw = dict(layout="bshd", dropout_rate=fcfg.dropatt, dropout_seed=12345)
    off = FAMILY_B // 2
    whole, whole_lse = fa.flash_attention_with_lse(q, k, v, mask, **kw)
    half = [t[off:].contiguous() for t in (q, k, v, mask)]
    out, lse = fa.flash_attention_with_lse(*half, dropout_batch_offset=off,
                                           **kw)
    check(torch.equal(out, whole[off:]) and torch.equal(lse, whole_lse[off:]),
          "32: FastPitch's K1 at batch offset 2 is not rows 2.. of the "
          "whole batch's")
    ref, _ = fa.mha_reference(*half, **kw, dropout_batch_offset=off)
    err = max_err(out, ref)
    check(err <= TOL[torch.float32][0],
          f"32: FastPitch's K1 at batch offset 2 against its plain version: "
          f"{err}")
    return err


def phase_families() -> tuple[float, dict[str, int]]:
    """32: ``--mesh-data 2`` for the seventeen commands PR 14 left on one
    rank: FastPitch's K1 dropout at a rank's batch offset; then one
    ``torchrun --nproc-per-node 2`` of this script's ``--mesh 32`` runs each
    command through the CLI while this process runs the one-rank run of the
    same global batches, which rank 0 holds it against. Returns the offset
    kernel's error against its plain version and rank 0's launches of the
    data-axis runs."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    err = _fastpitch_offset()
    # the one-rank runs here, beside the ranks' runs, each written for rank
    # 0 to read; the ranks draw each model's weights on 3 host threads each
    refs = Path(tempfile.mkdtemp(prefix="family_refs_"))
    proc = _torchrun("32", 2, DLX_DIST_BACKEND="gloo", OMP_NUM_THREADS="3",
                     FAMILY_REFS=str(refs))
    try:
        for name in FAMILIES:
            ref = _family_reference(name, refs)
            tmp = refs / f"{name}.tmp"
            torch.save({k: ({n: t.cpu() for n, t in v.items()}
                            if k in ("grads", "stats") else v)
                        for k, v in ref.items()}, tmp)
            os.replace(tmp, refs / f"{name}.pt")
            del ref
            torch.cuda.empty_cache()
        r0, r1 = _ranks("32", proc, 2, 900)
    finally:  # neither the launcher nor its ranks outlive the phase
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(refs, ignore_errors=True)
    none = dict.fromkeys(_counts(), 0)
    launched = dict(none)
    fails: list[str] = []  # every reading is printed before a check fails
    lines = []
    for name in FAMILIES:
        a, b = r0[name], r1[name]

        def want(ok: bool, what: str) -> None:
            if not ok:
                fails.append(f"{name}: {what}")

        want(a["backend"] == "gloo" and a["shape"] == {
            "data": 2, "model": 1, "sequence": 1}, f"{a['backend']} on "
             f"{a['shape']}")
        want(a["digest"] == b["digest"] and a["losses"] == b["losses"],
             "the ranks' parameters or losses differ")
        first, loss = (max(abs(x - y) / abs(y) for x, y in zip(
            a["losses"][:n], a["ref_losses"][:n])) for n in (1, FAMILY_STEPS))
        want(len(a["losses"]) == len(a["ref_losses"]) == FAMILY_STEPS
             and first <= TOL_FAMILY["loss"]
             and loss <= TOL_FAMILY["loss_steps"],
             f"losses {a['losses']} vs one rank's {a['ref_losses']}")
        grad, worst, gname = a["grad_err"]
        gtol = TOL_FAMILY_GRAD.get(name, TOL_FAMILY["grad"])
        want(a["grad_keys"] and grad <= gtol,
             f"gradients {grad:.3e} of their norm apart (limit {gtol})")
        stat, sname = a["stats_err"]
        want(a["stats_keys"] and stat <= TOL_FAMILY["stats"],
             f"BN statistics {sname} {stat:.3e}")
        metrics = sorted(a["ref_metrics"])
        want(sorted(a["metrics"]) == metrics and all(
            abs(a["metrics"][k] - a["ref_metrics"][k])
            <= TOL_FAMILY["metric"] * abs(a["ref_metrics"][k])
            for k in metrics), f"metrics {a['metrics']} vs one rank's "
             f"{a['ref_metrics']}")
        if name == "bart":
            want(a["metrics"] == a["ref_metrics"] and bool(metrics),
                 "ROUGE differs from the one-rank run's")
        if name in FAMILY_ATTENTION:  # K1/K2 at each rank's rows
            want(a["launched"] == a["ref_launched"] == b["launched"]
                 and a["launched"]["flash_fwd"] > 0
                 and a["launched"]["flash_bwd_dq"] > 0
                 and {**a["launched"], "flash_fwd": 0, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0} == none,
                 f"launches {a['launched']}, one rank's {a['ref_launched']}")
        else:
            want(a["launched"] == a["ref_launched"] == none,
                 f"launches {a['launched']}, one rank's {a['ref_launched']}")
        for k, v in a["launched"].items():
            launched[k] += v
        k1 = (f", K1 {a['launched']['flash_fwd']} K2 "
              f"{a['launched']['flash_bwd_dq']} + "
              f"{a['launched']['flash_bwd_dkv']}"
              if name in FAMILY_ATTENTION else "")
        shown = {k: round(v, 4) for k, v in a["metrics"].items()
                 if not k.startswith("train.")}
        lines.append(f"{name} losses {first:.2e} / {loss:.2e} gradients "
                     f"{grad:.2e} (worst tensor {worst:.2e}, {gname}) BN "
                     f"{stat:.2e}{k1}"
                     + (f" {shown}" if shown else "")
                     + f" ({a['seconds']:.1f} s)")
    say("32 the data axis of 17 commands", f"two gloo ranks on {card()}, "
        f"each command (and transformer with targets cut to "
        f"{FAMILY_TARGETS}) at --mesh-data 2, B={FAMILY_B} global, fp32, "
        f"{FAMILY_STEPS} steps, against the one-rank run on rank 0 (losses "
        "at the first step / every step; gradients: distance over norm; "
        f"limits {TOL_FAMILY}, {TOL_FAMILY_GRAD}), the ranks' parameters "
        "equal bit for bit: " + "; ".join(lines)
        + f"; FastPitch's K1 at batch offset 2: rows 2.. of the whole "
        f"batch's, {err:.3e} from plain; {time.perf_counter() - t0:.1f} s")
    check(not fails, "32: " + "; ".join(fails))
    return err, launched


# The float64 references of phases 23 and 25 run here, one at a time, while
# the card runs the phase's other work (torch's CPU ops release the GIL)
_HOST = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="float64")
PHASE_SECONDS: dict[str, float] = {}


class _phase:
    """Adds the seconds of the ``with`` block to the phase's entry of
    ``PHASE_SECONDS`` (printed before the kernels line)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        PHASE_SECONDS[self.name] = PHASE_SECONDS.get(self.name, 0.0) + (
            time.perf_counter() - self.t0)


def main() -> None:
    with _phase("1"):
        name = phase_device()
    # nvcc builds the kernels on the host's cores while the paths without a
    # kernel of the port (phases 19-22) run on the card; joined before phase 3
    t_build = time.perf_counter()
    build = concurrent.futures.ThreadPoolExecutor(1)
    built = build.submit(phase_build)
    launched: dict[str, int] = {}
    with _phase("19-20"):
        refs = _convnet_references()  # float64 on the host thread, beside 20
        conv = phase_convnets()  # counts set to 0 there
        phase_convnet_parity(refs)
    with _phase("21"):
        phase_ssd_parity()
        ssd = phase_ssd()  # counts set to 0 there
    with _phase("22"):
        refs = _tts_references()  # float64 on the host thread, beside 22c-d
        tts = phase_tts()  # counts set to 0 there
        phase_tts_parity(refs)
    with _phase("2 (wait)"):
        built.result()  # a failed build raises here
        build.shutdown()
    say("2 build", f"joined {time.perf_counter() - t_build:.1f} s after it "
        "started, phases 19-22 run meanwhile")
    with _phase("3-8, 11"):
        results = {"flash_fwd": phase_kernel()}
        fwd_err, bwd = phase_flash_bwd()
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], fwd_err)
        results.update(bwd)
        results.update(phase_flat_lamb())
        results["gather_rows"] = phase_gather()
        task, model = phase_slice()
        launched = dict.fromkeys(_counts(), 0)  # each kernel's main-path launches
        for part in (conv, ssd, tts):
            for k, v in part.items():
                launched[k] += v
        served = phase_serving(task, model)  # counts set to 0 there
        served += phase_predict(task, model)
        check(_counts() == {**dict.fromkeys(_counts(), 0),
                            "flash_fwd": served},
              "a launch count moved outside the serving path")
        check(served > 0, "the serving path never launched flash_fwd")
        launched["flash_fwd"] += served
        del task, model
    with _phase("9-10"):
        phase_train_parity()
        for k, v in phase_training().items():  # counts set to 0 there
            launched[k] += v
    with _phase("12-13"):
        phase_dlrm_parity()
        launched["gather_rows"] += phase_dlrm_training()  # counts set to 0 there
    with _phase("14-16"):
        results["quantize_activations"], launched["quantize_activations"] = \
            phase_quantize()  # counts set to 0 there
        fused_results, fused_launched = phase_fused_lamb()  # counts set to 0 there
        results.update(fused_results)
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            launched[k] += fused_launched[k]
        # K3 at 8K blocks is reported apart from K3 at 64K (phase 10's path)
        launched["flat_lamb_moments_8k"] = fused_launched["flat_lamb_moments"]
        launched["flat_lamb_apply_8k"] = fused_launched["flat_lamb_apply"]
        results["hot_gather"], launched["hot_gather"] = \
            phase_hot_gather()  # counts set to 0 there
    with _phase("17-18"):
        ft_fwd, ft_bwd = phase_finetune_parity()
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], ft_fwd)
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], ft_bwd)
        for k, v in phase_finetune().items():  # counts set to 0 there
            launched[k] += v
    with _phase("23"):
        s2s_fwd, s2s_bwd = phase_s2s_kernels()
        # the float64 references of 23a on the host thread, beside 23c-d
        refs = {kind: _s2s_reference(kind) for kind in S2S_PARITY}
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], s2s_fwd)
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], s2s_bwd)
        _reset_counts()  # the decoding path starts here
        launched["flash_fwd"] += phase_s2s_decode()["flash_fwd"]
        for k, v in phase_s2s().items():  # counts set to 0 there
            launched[k] += v
        phase_s2s_parity(refs)
    with _phase("24"):
        data_fwd, data_bwd, data_launched = phase_bert_data()
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], data_fwd)
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], data_bwd)
        for k, v in data_launched.items():
            launched[k] += v
    with _phase("25"):
        sp_fwd, sp_bwd, sp_launched = phase_speech_all()
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], sp_fwd)
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], sp_bwd)
        for k, v in sp_launched.items():
            launched[k] += v
    with _phase("26"):
        results["resample_normalize"], launched["resample_normalize"] = \
            phase_real_data()  # counts set to 0 there
    with _phase("27"):
        mesh_err, mesh_launched = phase_mesh()
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"],
                                            mesh_err)
        for k, v in mesh_launched.items():
            launched[k] += v
    with _phase("28"):
        refs = _breadth_references()  # float64 on the host thread, beside 28b
        for k, v in phase_breadth().items():  # counts set to 0 there
            launched[k] += v
        phase_breadth_parity(refs)
    with _phase("29"):
        refs = _last_two_references()  # float64 on the host thread, beside 29b
        for k, v in phase_last_two().items():  # counts set to 0 there
            launched[k] += v
        phase_last_two_parity(refs)
    with _phase("30"):
        for k, v in phase_serving_all().items():  # counts set to 0 there
            launched[k] += v
    with _phase("31"):
        phase_sequence()  # its paths launch no K1-K6 (checked there)
    with _phase("32"):
        fam_err, fam_launched = phase_families()
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], fam_err)
        for k, v in fam_launched.items():  # counts set to 0 in the ranks
            launched[k] += v
    say("phases", "seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; all {time.perf_counter() - T_START:.1f}")
    check(set(launched) == set(results), f"{sorted(launched)} vs {sorted(results)}")
    for k, v in launched.items():
        check(v > 0, f"the main path never launched {k}")
    sources = {  # (source in the port, the TPU kernel it replaces)
        "flash_fwd": ("csrc/flash_fwd.cu",
                      "deeplearningexamples_tpu/ops/flash_attention.py:686, "
                      ":215"),
        "flash_bwd_dq": ("csrc/flash_bwd.cu",
                         "deeplearningexamples_tpu/ops/flash_attention.py:896, "
                         ":975"),
        "flash_bwd_dkv": ("csrc/flash_bwd.cu",
                          "deeplearningexamples_tpu/ops/flash_attention.py:896, "
                          ":975"),
        "flat_lamb_moments": ("csrc/flat_lamb.cu",
                              "deeplearningexamples_tpu/core/flat.py:212"),
        "flat_lamb_apply": ("csrc/flat_lamb.cu",
                            "deeplearningexamples_tpu/core/flat.py:242"),
        "gather_rows": ("csrc/gather_rows.cu",
                        "deeplearningexamples_tpu/ops/embedding.py:118"),
        "quantize_activations": ("csrc/quantize.cu",
                                 "deeplearningexamples_tpu/ops/quantization.py:128"),
        "flat_lamb_moments_8k": ("csrc/flat_lamb.cu",
                                 "deeplearningexamples_tpu/ops/fused_lamb.py:142"),
        "flat_lamb_apply_8k": ("csrc/flat_lamb.cu",
                               "deeplearningexamples_tpu/ops/fused_lamb.py:177"),
        "hot_gather": ("csrc/gather_rows.cu", "perf/dlrm_hotrow.py:95"),
        # not a TPU kernel: the host data plane's fused resample, which the
        # card runs where its host has no libjpeg
        "resample_normalize": ("csrc/resample_normalize.cu",
                               "deeplearningexamples_tpu/native/dataplane.cc:106"),
    }
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"deeplearningexamples_tpu_torch/{sources[k][0]}",
        "replaces": sources[k][1],
        "launches": launched[k],
        **{f: results[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
    } for k in results]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if sys.argv[1:3] == ["--mesh", "31"]:  # a rank of phase 31, under torchrun
        _seq_child(sys.argv[3:])
    elif sys.argv[1:3] == ["--mesh", "32"]:  # a rank of phase 32
        _family_child(sys.argv[3:])
    elif sys.argv[1:2] == ["--mesh"]:  # a rank of phase 27, under torchrun
        _mesh_child(sys.argv[2], sys.argv[3:])
    else:
        main()
