"""Where one serving forward spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_serving [--endpoint
qa|bart|gnmt|tft|ncf|unet|transformer_xl|efficientdet|maskrcnn] [--out F]``:

- ``qa`` (the default): the BERT-Large QA model as serving runs it (bf16
  encoder, S=384, random weights from seed 0, padded batches) at B=8 and
  B=1, 20 forwards (``BertSquadTask.predict_fn``) on the host clock and 5
  traced;
- the others: the endpoint of ``serving/recipes.py`` as ``chip_smoke.py``
  phase 30 serves it (``served_endpoints``: fp32, full width, random weights
  from seed 0), its function (the model's work and the copy of its outputs
  to the host) on one request padded to B=1 and to the largest bucket up to
  4, 5 calls on the host clock and 2 traced.

Each call ends in ``synchronize()``; ``torch.profiler`` sums the traced
device kernel time by kind (``KINDS``: the flash forward K1, convolutions,
BN, GEMMs, LSTMs, sorts and softmax, gathers and scatters, elementwise
passes, the rest); the device idle share is the part of the unprofiled call
time that the traced kernels do not cover. A "step" in its output is one
call. It shares its measurement with ``profile_pretrain`` (``trace_steps``,
``run_main``): it needs a CUDA card and prints one JSON object per batch
size, with the card's name and power limit, and also writes them all to
``--out`` when given.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..models.bart import BartConfig, BartTask
from ..models.bert import BERT_CONFIGS, BertSquadTask
from ..models.efficientdet import EfficientDetConfig, EfficientDetTask
from ..models.maskrcnn import MaskRCNNConfig, MaskRCNNTask
from ..models.ncf import NcfConfig, NcfTask
from ..models.tft import TFTConfig, TFTTask
from ..models.translation import GnmtConfig, GnmtTask
from ..models.transformer_xl import TransformerXLConfig, TransformerXLTask
from ..models.unet import UNetConfig, UNetTask
from ..serving import recipes
from .profile_pretrain import run_main, trace_steps

SEQ = 384
BART_TARGETS = 64  # ``bart_endpoint``'s max_target_len
UNET_PATCH = 128  # the CLI's nnunet images
ENDPOINTS = ("qa", "bart", "gnmt", "tft", "ncf", "unet", "transformer_xl",
             "efficientdet", "maskrcnn")
KINDS = [
    ("K1 flash_fwd", re.compile(r"flash_fwd_(mma_)?kernel")),
    ("conv", re.compile(r"conv|fprop|dgrad|wgrad|implicit|cudnn", re.I)),
    ("BN", re.compile(r"batch_norm|\bbn_", re.I)),
    ("GEMM", re.compile(r"gemm|nvjet|xmma|cutlass|cublas|sm90_", re.I)),
    ("LSTM", re.compile(r"lstm|rnn", re.I)),
    ("sort, softmax", re.compile(r"sort|softmax|topk", re.I)),
    ("index/scatter", re.compile(r"index|gather|scatter|embedding", re.I)),
    ("elementwise", re.compile(r"elementwise|CatArray|copy", re.I)),
]


def _kind(name: str) -> str:
    for kind, pat in KINDS:
        if pat.search(name):
            return kind
    return "other"


def _bart(gen, rng, device, n):
    cfg = BartConfig()  # bart-large: sources of cfg.max_len = 1024
    model = BartTask(cfg, torch.float32).init(gen, device)
    reqs = []
    for k in rng.integers(cfg.max_len // 4, cfg.max_len + 1, 3):
        src = np.full(cfg.max_len, cfg.pad_id, np.int32)
        src[:k] = rng.integers(4, cfg.vocab_size, k)
        src[0], src[k - 1] = cfg.bos_id, cfg.eos_id
        reqs.append({"src": src})
    k1 = cfg.encoder_layers + cfg.decoder_layers * (BART_TARGETS - 1)
    return (recipes.bart_endpoint(model, cfg, max_target_len=BART_TARGETS),
            reqs, False, {"flash_fwd": k1}, model)


def _gnmt(gen, rng, device, n):
    task = GnmtTask(GnmtConfig(), torch.float32)  # the CLI's gnmt
    model = task.init(gen, device)
    reqs = []
    for k in rng.integers(8, 33, n):
        src = np.full(32, task.cfg.pad_id, np.int32)
        src[:k] = rng.integers(4, task.cfg.vocab_size, k)
        reqs.append({"src": src})
    return recipes.gnmt_endpoint(task, model), reqs, False, {}, model


def _tft(gen, rng, device, n):
    # the CLI's TFT (configs.yml's section sets its epochs, batch and rate)
    task = TFTTask(TFTConfig(n_observed=2, n_known=2, encoder_len=168,
                             horizon=24), torch.float32)
    model, c = task.init(gen, device), task.cfg
    reqs = [{"observed": rng.normal(size=(c.encoder_len, c.n_observed)
                                    ).astype(np.float32),
             "known": rng.normal(size=(c.encoder_len + c.horizon, c.n_known)
                                 ).astype(np.float32)} for _ in range(n)]
    return recipes.tft_endpoint(task, model), reqs, False, {}, model


def _ncf(gen, rng, device, n):
    task = NcfTask(NcfConfig(), torch.float32)  # ML-20M's users and items
    model = task.init(gen, device)
    reqs = [{"user": rng.integers(0, task.cfg.nb_users, 1).astype(np.int32),
             "items": rng.integers(0, task.cfg.nb_items, 100).astype(
                 np.int32)} for _ in range(n)]
    return recipes.ncf_endpoint(task, model), reqs, False, {}, model


def _unet(gen, rng, device, n):
    task = UNetTask(UNetConfig(spatial_rank=2), torch.float32)  # the CLI's
    model = task.init(gen, device)
    reqs = [{"image": rng.normal(size=(UNET_PATCH,) * 2 + (1,)).astype(
        np.float32)} for _ in range(n)]
    return (recipes.unet_endpoint(task, model, patch=UNET_PATCH), reqs, True,
            {}, model)


def _transformer_xl(gen, rng, device, n):
    task = TransformerXLTask(TransformerXLConfig(), torch.float32)  # WT103
    model = task.init(gen, device)
    reqs = [{"context": rng.integers(0, task.cfg.vocab_size,
                                     task.cfg.seg_len).astype(np.int32)}
            for _ in range(n)]
    return (recipes.transformer_xl_generate_endpoint(task, model), reqs,
            False, {}, model)


def _images(task, rng, k):
    s = task.cfg.image_size
    return [{"image": rng.normal(size=(s, s, 3)).astype(np.float32)}
            for _ in range(k)]


def _efficientdet(gen, rng, device, n):
    task = EfficientDetTask(EfficientDetConfig(), torch.float32)  # D0, 512
    model = task.init(gen, device)
    return (recipes.efficientdet_endpoint(task, model), _images(task, rng, n),
            True, {}, model)


def _maskrcnn(gen, rng, device, n):
    task = MaskRCNNTask(MaskRCNNConfig(), torch.float32)  # R50-FPN, 800
    model = task.init(gen, device)
    return (recipes.maskrcnn_endpoint(task, model), _images(task, rng, 3),
            True, {}, model)


# the batched endpoints as ``chip_smoke.py`` phase 30 serves them
SERVED = {"bart": _bart, "gnmt": _gnmt, "tft": _tft, "ncf": _ncf,
          "unet": _unet, "transformer_xl": _transformer_xl,
          "efficientdet": _efficientdet, "maskrcnn": _maskrcnn}


def served_endpoints(device, seed: int = 0, n: int = 4,
                     names=tuple(SERVED)) -> list[tuple]:
    """The endpoints of ``names``, fp32 at full width, each with weights
    from ``seed``: a list of (endpoint, ``n`` seeded requests (3 for BART and
    Mask R-CNN), whether they travel binary, the launches a dispatch must
    make, the model)."""
    return [SERVED[name](torch.Generator().manual_seed(seed),
                         np.random.default_rng((seed, list(SERVED).index(name))),
                         device, n) for name in names]


def _batch(rng, n: int) -> dict[str, torch.Tensor]:
    """n padded questions: lengths uniform in [S/3, S], segment B after the
    first third."""
    lengths = rng.integers(SEQ // 3, SEQ + 1, size=n)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1000, 30522, size=(n, SEQ)).astype(np.int32) * mask
    seg = ((np.arange(SEQ)[None, :] >= lengths[:, None] // 3) & (mask > 0))
    return {k: torch.from_numpy(v.astype(np.int32)).cuda() for k, v in
            (("input_ids", ids), ("attention_mask", mask),
             ("token_type_ids", seg))}


def profile(task, model, batch_size: int, steps: int = 20,
            traced: int = 5) -> dict:
    batch = _batch(np.random.default_rng(0), batch_size)
    return {"batch_size": batch_size,
            **trace_steps(lambda: task.predict_fn(model, batch), steps, traced,
                          warmup=3)}


def _endpoint_profiles(name: str):
    (ep, reqs, *_), = served_endpoints("cuda", names=(name,))
    try:
        for b in (1, max(b for b in ep.batcher.buckets if b <= 4)):
            batch = {k: np.stack([v] * b) for k, v in reqs[0].items()}
            yield {"endpoint": name, "batch_size": b,
                   **trace_steps(lambda: ep.batcher._run(batch), 5, 2,
                                 kind=_kind)}
    finally:
        ep.batcher.close()


def _profiles(name: str):
    if name != "qa":
        yield from _endpoint_profiles(name)
        return
    task = BertSquadTask(BERT_CONFIGS["large"], dtype=torch.bfloat16)
    model = task.init(torch.Generator().manual_seed(0), device="cuda")
    for b in (8, 1):
        yield profile(task, model, b)


def main() -> None:
    run_main(__doc__, _profiles, ENDPOINTS, flag="--endpoint")


if __name__ == "__main__":
    main()
