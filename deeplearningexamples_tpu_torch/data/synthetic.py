"""Copy of ``deeplearningexamples_tpu/data/synthetic.py`` (``_Synthetic`` and
``SyntheticBertLoader``), numpy only.

Each loader emits numpy batches shaped exactly like the real pipeline's
output, at zero host cost: one batch generated once, yielded repeatedly,
matching the reference, which builds a single random tensor and re-serves it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["SyntheticBertLoader"]


class _Synthetic:
    """len() == steps_per_epoch; iterating yields the cached batch."""

    def __init__(self, steps: int):
        self.steps = steps
        self._batch = None

    def _make(self) -> dict:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.steps

    def __iter__(self) -> Iterator[dict]:
        if self._batch is None:
            self._batch = self._make()
        for _ in range(self.steps):
            yield self._batch


class SyntheticBertLoader(_Synthetic):
    """MLM+NSP pretraining batches (ids/mask/type/labels/nsp)."""

    def __init__(
        self,
        batch_size: int,
        seq_len: int = 128,
        vocab_size: int = 30528,
        max_predictions: int = 20,
        steps: int = 100,
        seed: int = 0,
    ):
        super().__init__(steps)
        self.batch_size, self.seq_len = batch_size, seq_len
        self.vocab_size, self.max_predictions = vocab_size, max_predictions
        self.rng = np.random.default_rng(seed)

    def _make(self):
        b, s = self.batch_size, self.seq_len
        ids = self.rng.integers(1, self.vocab_size, size=(b, s), dtype=np.int32)
        mask = np.ones((b, s), np.int32)
        types = np.zeros((b, s), np.int32)
        mlm_labels = np.full((b, s), -1, np.int32)
        pos = self.rng.integers(0, s, size=(b, self.max_predictions))
        for i in range(b):
            mlm_labels[i, pos[i]] = self.rng.integers(1, self.vocab_size, self.max_predictions)
        nsp = self.rng.integers(0, 2, size=(b,), dtype=np.int32)
        return {
            "input_ids": ids,
            "attention_mask": mask,
            "token_type_ids": types,
            "mlm_labels": mlm_labels,
            "nsp_label": nsp,
        }
