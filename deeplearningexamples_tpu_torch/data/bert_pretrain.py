"""Copy of ``deeplearningexamples_tpu/data/bert_pretrain.py``, numpy only.

BERT pretraining data pipeline (LDDL-equivalent, host-side).

Covers the roles of the reference's offline toolchain + loader:
- ``create_pretraining_data.py`` (476 LoC): document sentences → sentence-
  pair instances with NSP labels and 15% MLM masking (80% [MASK] / 10%
  random / 10% keep)
- LDDL's runtime loader (``run_pretraining.py:557-570``): shuffled shards,
  sequence-length binning to cut pad waste, per-host sharding

Masking happens *online* per epoch (a fresh mask each pass) from a tokenized
corpus stored as numpy shards (one ragged list of token-id sentences per
document). The numpy RNG is drawn in the JAX package's order, so both
packages give the same batches bit for bit from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

__all__ = ["BertPretrainLoader", "BinnedBertPretrainLoader", "MaskingConfig",
           "create_masked_instance"]


@dataclass(frozen=True)
class MaskingConfig:
    vocab_size: int = 30522
    mask_token_id: int = 103  # [MASK]
    cls_token_id: int = 101
    sep_token_id: int = 102
    pad_token_id: int = 0
    masked_lm_prob: float = 0.15
    max_predictions_per_seq: int = 20
    special_ids: tuple[int, ...] = (0, 100, 101, 102, 103)


def create_masked_instance(
    tokens_a: np.ndarray,
    tokens_b: np.ndarray,
    seq_len: int,
    cfg: MaskingConfig,
    rng: np.random.Generator,
) -> dict:
    """[CLS] A [SEP] B [SEP] with 80/10/10 masking over non-special positions."""
    ids = np.full(seq_len, cfg.pad_token_id, np.int32)
    seg = np.zeros(seq_len, np.int32)
    la = min(len(tokens_a), seq_len - 3)
    lb = min(len(tokens_b), seq_len - 3 - la)
    pos = 0
    ids[pos] = cfg.cls_token_id; pos += 1
    ids[pos : pos + la] = tokens_a[:la]; pos += la
    ids[pos] = cfg.sep_token_id; pos += 1
    seg[pos : pos + lb + 1] = 1
    ids[pos : pos + lb] = tokens_b[:lb]; pos += lb
    ids[pos] = cfg.sep_token_id; pos += 1
    mask = np.zeros(seq_len, np.int32)
    mask[:pos] = 1

    candidates = np.where(
        (mask == 1) & ~np.isin(ids, cfg.special_ids)
    )[0]
    n_pred = min(
        cfg.max_predictions_per_seq,
        max(1, int(round(len(candidates) * cfg.masked_lm_prob))),
    )
    picked = rng.choice(candidates, size=min(n_pred, len(candidates)), replace=False)

    mlm_labels = np.full(seq_len, -1, np.int32)
    for p in picked:
        mlm_labels[p] = ids[p]
        r = rng.random()
        if r < 0.8:
            ids[p] = cfg.mask_token_id
        elif r < 0.9:
            ids[p] = rng.integers(0, cfg.vocab_size)
        # else: keep original
    return {
        "input_ids": ids,
        "attention_mask": mask,
        "token_type_ids": seg,
        "mlm_labels": mlm_labels,
    }


class BertPretrainLoader:
    """documents (list of lists of token-id arrays, one per sentence) →
    batches with NSP pairing and online masking.

    NSP sampling follows the reference: 50% actual-next segments, 50% random
    segments from another document.
    """

    def __init__(
        self,
        documents: Sequence[Sequence[np.ndarray]],
        batch_size: int,
        seq_len: int = 128,
        cfg: MaskingConfig | None = None,
        seed: int = 0,
        steps_per_epoch: int | None = None,
        shard: tuple[int, int] = (0, 1),
    ):
        self.docs = [d for d in documents if len(d) >= 1]
        if len(self.docs) < 2:
            raise ValueError("need >= 2 documents for NSP negatives")
        self.docs = self.docs[shard[0] :: shard[1]] or self.docs
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.cfg = cfg or MaskingConfig()
        self.seed = seed
        self.epoch = 0
        self._steps = steps_per_epoch or max(
            1, sum(len(d) for d in self.docs) // batch_size
        )

    def __len__(self):
        return self._steps

    def _sample_pair(self, rng) -> tuple[np.ndarray, np.ndarray, int]:
        half = (self.seq_len - 3) // 2
        di = rng.integers(0, len(self.docs))
        doc = self.docs[di]
        si = rng.integers(0, len(doc))
        a = np.concatenate([np.asarray(s) for s in doc[si : si + 3]])[:half]
        if rng.random() < 0.5 and si + 3 < len(doc):
            b = np.concatenate([np.asarray(s) for s in doc[si + 3 : si + 6]])
            nsp = 0  # is-next
        else:
            dj = (di + 1 + rng.integers(0, len(self.docs) - 1)) % len(self.docs)
            other = self.docs[dj]
            sj = rng.integers(0, len(other))
            b = np.concatenate([np.asarray(s) for s in other[sj : sj + 3]])
            nsp = 1  # not-next (reference label convention)
        return a, b[: self.seq_len - 3 - len(a)], nsp

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        for _ in range(self._steps):
            rows = []
            nsp = []
            for _ in range(self.batch_size):
                a, b, label = self._sample_pair(rng)
                rows.append(create_masked_instance(a, b, self.seq_len, self.cfg, rng))
                nsp.append(label)
            batch = {
                k: np.stack([r[k] for r in rows]) for k in rows[0]
            }
            batch["nsp_label"] = np.asarray(nsp, np.int32)
            yield batch


class BinnedBertPretrainLoader(BertPretrainLoader):
    """Sequence-length binning (the reference's LDDL binned data loader
    role, ``LanguageModeling/BERT/run.sub`` ``--num-buckets``): sampled
    pairs accumulate in per-length buckets (rounded up to a multiple of
    ``bin_multiple``) and a batch is emitted when its bucket fills, padded
    only to the bucket length instead of ``seq_len``.

    At most seq_len / bin_multiple distinct shapes reach the model (the
    LDDL paper's trade: up to ~2x less pad work on wiki-style length
    distributions)."""

    def __init__(self, *args, bin_multiple: int = 64, **kwargs):
        super().__init__(*args, **kwargs)
        self.bin_multiple = bin_multiple

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        m = self.bin_multiple
        buckets: dict[int, list] = {}
        emitted = 0
        while emitted < self._steps:
            a, b, label = self._sample_pair(rng)
            need = len(a) + len(b) + 3
            bucket = min(-(-need // m) * m, self.seq_len)
            pending = buckets.setdefault(bucket, [])
            pending.append((a, b, label))
            if len(pending) == self.batch_size:
                rows = [
                    create_masked_instance(pa, pb, bucket, self.cfg, rng)
                    for pa, pb, _ in pending
                ]
                batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
                batch["nsp_label"] = np.asarray(
                    [l for _, _, l in pending], np.int32
                )
                buckets[bucket] = []
                emitted += 1
                yield batch
