"""Copy of ``deeplearningexamples_tpu/data/summarization.py``: the BART
fine-tune recipe's data side and ROUGE.

The reference BART recipe's data and evaluation layer
(``PyTorch/LanguageModeling/BART``: ``utils/data_utils.py`` over
CNN-DailyMail ``{split}.source`` / ``{split}.target`` line files,
``utils/calculate_rouge.py``), numpy and the standard library only, as in
the JAX package: tokenisation through a tokenizer that has ``tokenize`` and
``convert_tokens_to_ids`` (the port's WordPiece ``BertTokenizer``), batches
of padded ``src`` and BOS ... EOS ``tgt`` ids, and ROUGE-1/2/L F1 from
their definitions (n-gram overlap and LCS).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Iterator

import numpy as np

__all__ = ["SummarizationDataset", "rouge_n", "rouge_l", "rouge_scores",
           "write_synthetic_summarization"]


class SummarizationDataset:
    """Paired line files: ``{split}.source`` / ``{split}.target``
    (the reference's CNN-DM layout). Tokenizes with a framework tokenizer
    exposing ``tokenize`` + ``convert_tokens_to_ids``."""

    def __init__(self, data_dir: str, split: str, tokenizer, batch_size: int,
                 *, max_source_len: int = 512, max_target_len: int = 128,
                 bos_id: int = 0, pad_id: int = 1, eos_id: int = 2,
                 shuffle: bool | None = None, seed: int = 0):
        self.tok = tokenizer
        self.batch_size = batch_size
        self.max_source_len = max_source_len
        self.max_target_len = max_target_len
        self.bos_id, self.pad_id, self.eos_id = bos_id, pad_id, eos_id
        self.shuffle = shuffle if shuffle is not None else split == "train"
        self.seed = seed
        with open(os.path.join(data_dir, f"{split}.source")) as f:
            self.sources = [line.rstrip("\n") for line in f]
        with open(os.path.join(data_dir, f"{split}.target")) as f:
            self.targets = [line.rstrip("\n") for line in f]
        assert len(self.sources) == len(self.targets)

    def _ids(self, text: str, limit: int) -> list[int]:
        return self.tok.convert_tokens_to_ids(self.tok.tokenize(text))[:limit]

    def __len__(self) -> int:
        return len(self.sources) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.sources))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        bs = self.batch_size
        for i in range(len(self)):
            idx = order[i * bs:(i + 1) * bs]
            src = np.full((bs, self.max_source_len), self.pad_id, np.int32)
            tgt = np.full((bs, self.max_target_len + 2), self.pad_id, np.int32)
            for j, k in enumerate(idx):
                s = self._ids(self.sources[k], self.max_source_len)
                src[j, :len(s)] = s
                t = self._ids(self.targets[k], self.max_target_len)
                tgt[j, 0] = self.bos_id
                tgt[j, 1:1 + len(t)] = t
                tgt[j, 1 + len(t)] = self.eos_id
            yield {"src": src, "tgt": tgt, "indices": idx.astype(np.int32)}


def _ngrams(tokens: list, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(hyp: list, ref: list, n: int) -> float:
    """ROUGE-N F1 on token lists."""
    h, r = _ngrams(hyp, n), _ngrams(ref, n)
    overlap = sum((h & r).values())
    if not h or not r or overlap == 0:
        return 0.0
    p = overlap / sum(h.values())
    rc = overlap / sum(r.values())
    return 2 * p * rc / (p + rc)


def rouge_l(hyp: list, ref: list) -> float:
    """ROUGE-L F1 via LCS length (O(|h|*|r|) DP)."""
    if not hyp or not ref:
        return 0.0
    m, n = len(hyp), len(ref)
    dp = np.zeros((m + 1, n + 1), np.int32)
    for i in range(m):
        for j in range(n):
            dp[i + 1, j + 1] = dp[i, j] + 1 if hyp[i] == ref[j] \
                else max(dp[i, j + 1], dp[i + 1, j])
    lcs = int(dp[m, n])
    if lcs == 0:
        return 0.0
    p, rc = lcs / m, lcs / n
    return 2 * p * rc / (p + rc)


def rouge_scores(hyps: list[list], refs: list[list]) -> dict:
    """Corpus-average ROUGE-1/2/L F1 (reference ``calculate_rouge``)."""
    assert len(hyps) == len(refs)
    r1 = np.mean([rouge_n(h, r, 1) for h, r in zip(hyps, refs)])
    r2 = np.mean([rouge_n(h, r, 2) for h, r in zip(hyps, refs)])
    rl = np.mean([rouge_l(h, r) for h, r in zip(hyps, refs)])
    return {"rouge1": float(r1), "rouge2": float(r2), "rougeL": float(rl)}


def write_synthetic_summarization(data_dir: str, n: int = 64,
                                  seed: int = 0) -> None:
    """Tiny fixture in the CNN-DM line-file layout: the 'summary' is the
    lead sentence of the 'article' (a real, learnable summarization
    signal — lead bias — in miniature)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = ["market", "report", "growth", "city", "water", "energy",
             "health", "team", "science", "model", "data", "update"]
    for split, count in [("train", n), ("val", max(n // 4, 4))]:
        with open(os.path.join(data_dir, f"{split}.source"), "w") as fs, \
                open(os.path.join(data_dir, f"{split}.target"), "w") as ft:
            for _ in range(count):
                lead = " ".join(rng.choice(words, 6))
                body = " . ".join(
                    " ".join(rng.choice(words, 8)) for _ in range(3)
                )
                fs.write(f"{lead} . {body}\n")
                ft.write(f"{lead}\n")
