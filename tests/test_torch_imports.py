"""The port and ``chip_smoke.py`` stand without JAX: a CUDA host need not
have jax, flax, optax, orbax or yaml, and no JAX package may be reached."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "flax", "optax", "orbax", "yaml", "PIL",
             "deeplearningexamples_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import deeplearningexamples_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("core.train", "core.flat", "core.loop", "core.checkpoint",
             "cli.main", "data.synthetic", "ops.lamb", "ops.dropout",
             "models.dlrm", "models.dlrm.model", "models.dlrm.task",
             "ops.embedding", "ops.dot_interaction", "core.metrics",
             "ops.quantization", "ops.fused_lamb", "tools.dlrm_hotrow",
             "tools.kernel_report", "models.bert.glue", "utils.torch_import",
             "core.losses", "models.convnets", "models.convnets.layers",
             "models.convnets.resnet", "models.convnets.efficientnet",
             "models.convnets.quant", "models.convnets.task",
             "tools.profile_convnet", "models.ssd", "models.ssd.boxes",
             "models.ssd.model", "models.ssd.task", "models.ssd.coco_eval",
             "models.ssd.evaluate", "data.ssd_synthetic", "models.tts",
             "models.tts.audio", "models.tts.text", "models.tts.layers",
             "models.tts.tacotron2", "models.tts.waveglow", "models.tts.task",
             "models.tts.inference", "data.tts_synthetic", "data.ljspeech",
             "tools.profile_tts", "models.translation",
             "models.translation.transformer",
             "models.translation.beam_search", "models.translation.gnmt",
             "models.bart", "data.summarization", "tools.profile_seq2seq",
             "data.bert_pretrain", "data.bert_prep", "data.criteo",
             "core.yaml_subset", "models.bert.distillation",
             "models.tts.fastpitch", "models.tts.hifigan", "models.asr",
             "models.wav2vec2", "serving.recipes", "native", "ops.resample",
             "ops.detection", "data.prefetch", "data.imagenet", "data.coco",
             "data.det_synthetic", "data.jpeg_trees",
             "models.convnets.gpunet", "models.efficientdet", "parallel",
             "parallel.dist", "parallel.mesh", "parallel.zero",
             "data.timeseries", "models.ncf", "models.tft", "models.unet",
             "models.transformer_xl", "models.moflow", "models.maskrcnn",
             "ops.se3", "models.se3_transformer", "hub", "serving.export",
             "serving.streaming_asr", "utils.checkpoint_tools",
             "utils.profiling", "ops.ring_attention", "ops.moe",
             "parallel.pipeline"):
    assert f"deeplearningexamples_tpu_torch.{name}" in names, name
# importing builds and loads nothing: the data plane and the kernels are
# built at first use
from deeplearningexamples_tpu_torch import native
from deeplearningexamples_tpu_torch.ops import _build
assert native._lib is None and not _build._libs
import chip_smoke
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # every module of the package: serving, the BERT and DLRM models and
    # tasks, the training harness (core/), the CLI (cli/), the data loaders
    # (data/), the profiling tools and the hot-row probe (tools/), and the
    # int8 quantization and fused LAMB ops, the GLUE task and the BERT
    # checkpoint reader, the ConvNets models, task and losses, and SSD300
    # (model, boxes, task, COCO mAP, evaluation, the synthetic loader), and
    # Tacotron2 + WaveGlow (frontends, layers, models, tasks, the pipeline,
    # the synthetic and LJSpeech loaders, the profiling tool), and the
    # encoder-decoder family (the Transformer NMT, beam search, BART, GNMT,
    # the summarization data path, the profiling tool), and BERT's corpus
    # loaders and distillation, the Criteo binary reader and the YAML reader,
    # and the speech families (FastPitch, HiFi-GAN, Jasper and QuartzNet,
    # wav2vec2, the serving recipes), and the real-data readers with their
    # data plane (the host's C++ plane and the card's nvJPEG path and
    # resample kernel), GPUNet and EfficientDet, and NCF, TFT with its
    # time-series reader, the U-Nets, Transformer-XL and MoFlow, and Mask
    # R-CNN and the SE(3)-Transformer with its equivariant basis, and the
    # hub, the model repository, streaming ASR and the checkpoint and
    # profiling tools
    assert int(res.stdout.strip()) >= 117


def test_chip_smoke_fails_without_a_card():
    """On a host without CUDA the script exits non-zero and prints no
    result line."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "torch.cuda.is_available() is false" in res.stderr
