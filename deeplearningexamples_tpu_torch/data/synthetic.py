"""Copy of ``deeplearningexamples_tpu/data/synthetic.py`` (``_Synthetic``,
``SyntheticImageLoader``, ``SyntheticBertLoader`` and
``SyntheticDlrmLoader``), numpy only.

Each loader emits numpy batches shaped exactly like the real pipeline's
output, at zero host cost: one batch generated once, yielded repeatedly,
matching the reference, which builds a single random tensor and re-serves it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["SyntheticBertLoader", "SyntheticDlrmLoader", "SyntheticImageLoader"]


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


class SyntheticImageLoader(_Synthetic):
    """Images NHWC float32 (pre-normalized) + int labels, JAX's draws in
    JAX's order: the images, then the labels (int32, or one-hot float32).

    NHWC is the layout the port's ConvNets take too: on the card a batch
    becomes ``x.permute(0, 3, 1, 2)``, an NCHW view whose memory is already
    ``channels_last``.
    """

    def __init__(
        self,
        batch_size: int,
        image_size: int = 224,
        num_classes: int = 1000,
        steps: int = 100,
        one_hot: bool = False,
        seed: int = 0,
    ):
        super().__init__(steps)
        self.batch_size, self.image_size = batch_size, image_size
        self.num_classes, self.one_hot = num_classes, one_hot
        self.rng = np.random.default_rng(seed)

    def _make(self):
        images = self.rng.normal(
            size=(self.batch_size, self.image_size, self.image_size, 3)
        ).astype(np.float32)
        labels = self.rng.integers(0, self.num_classes, size=(self.batch_size,))
        if self.one_hot:
            labels = np.eye(self.num_classes, dtype=np.float32)[labels]
        else:
            labels = labels.astype(np.int32)
        return {"image": images, "label": labels}


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


class SyntheticDlrmLoader(_Synthetic):
    """Criteo-like batches: 13 numeric + N categorical + click label.

    Mirrors ``SyntheticDataset`` (``dlrm/data/datasets.py:32``) driven by a
    feature-spec-style cardinality list. The same numpy calls in the same
    order as the JAX package's loader, so one seed draws the same batch.

    ``skew``: index distribution. ``"uniform"`` matches the reference's
    synthetic dataset (``torch.randint``); ``"zipf"`` draws from a power law
    with exponent ``zipf_a``, the access profile of real Criteo, whose IDs
    the reference's preprocessing remaps by descending frequency (rank 0
    hottest).
    """

    def __init__(
        self,
        batch_size: int,
        categorical_cardinalities: list[int],
        num_numerical: int = 13,
        steps: int = 100,
        seed: int = 0,
        skew: str = "uniform",
        zipf_a: float = 1.15,
    ):
        super().__init__(steps)
        self.batch_size = batch_size
        self.cards = list(categorical_cardinalities)
        self.num_numerical = num_numerical
        self.rng = np.random.default_rng(seed)
        if skew not in ("uniform", "zipf"):
            raise ValueError(f"unknown skew {skew!r}")
        self.skew = skew
        self.zipf_a = zipf_a

    def _draw_indices(self, card: int, n: int) -> np.ndarray:
        if self.skew == "uniform":
            return self.rng.integers(0, card, size=(n,))
        # Zipf over ranks 1..card, truncated: frequency-ranked IDs
        z = self.rng.zipf(self.zipf_a, size=(n,))
        return np.minimum(z - 1, card - 1)

    def _make(self):
        b = self.batch_size
        numerical = self.rng.normal(size=(b, self.num_numerical)).astype(np.float32)
        categorical = np.stack(
            [self._draw_indices(c, b) for c in self.cards], axis=1
        ).astype(np.int32)
        label = self.rng.integers(0, 2, size=(b,)).astype(np.float32)
        return {"numerical": numerical, "categorical": categorical, "label": label}
