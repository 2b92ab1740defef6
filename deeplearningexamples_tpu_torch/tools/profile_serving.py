"""Where one BERT-Large question-answering forward spends the card's time.

``python -m deeplearningexamples_tpu_torch.tools.profile_serving [--out F]``
builds the QA model as serving runs it (BERT-Large, bf16 encoder, S=384,
random weights from seed 0, padded batches) and, at B=8 and at B=1:

- times 20 forwards (``BertSquadTask.predict_fn``) on the host clock, each
  ending in ``synchronize()``;
- traces 5 forwards with ``torch.profiler`` and sums device kernel time by
  kind (the flash forward K1, GEMMs, the rest); the device idle share is the
  part of the unprofiled forward time that the traced kernels do not cover.

A "step" in its output is one forward. It shares its measurement with
``profile_pretrain`` (``trace_steps``, ``run_main``): it needs a CUDA card
and prints one JSON object per batch size, with the card's name and power
limit, and also writes them all to ``--out`` when given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bert import BERT_CONFIGS, BertSquadTask
from .profile_pretrain import run_main, trace_steps

SEQ = 384


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


def _profiles():
    task = BertSquadTask(BERT_CONFIGS["large"], dtype=torch.bfloat16)
    model = task.init(torch.Generator().manual_seed(0), device="cuda")
    for b in (8, 1):
        yield profile(task, model, b)


def main() -> None:
    run_main(__doc__, _profiles)


if __name__ == "__main__":
    main()
