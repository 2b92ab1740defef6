"""GLUE fine-tuning: TSV readers, pair features, MCC and the task.

Port of ``deeplearningexamples_tpu/models/bert/glue.py`` (the reference's
``run_glue.py``): ``read_tsv``, ``convert_pair_features`` and
``matthews_corrcoef`` are the JAX package's numpy code, and ``GlueTask`` the
fine-tune task over ``BertForSequenceClassification``.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...data.tokenization import BertTokenizer
from .modeling import BertConfig, BertForSequenceClassification
from .task import init_bert_weights_

__all__ = ["GlueTask", "convert_pair_features", "matthews_corrcoef", "read_tsv"]


def read_tsv(path: str, text_a_col: int, text_b_col: int | None,
             label_col: int, skip_header: bool = True,
             label_map: dict | None = None) -> list[tuple[str, str | None, int]]:
    rows = []
    with open(path, encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t", quotechar=None)
        for i, parts in enumerate(reader):
            if skip_header and i == 0:
                continue
            label = parts[label_col]
            label = label_map[label] if label_map else int(label)
            rows.append(
                (parts[text_a_col],
                 parts[text_b_col] if text_b_col is not None else None,
                 label)
            )
    return rows


def convert_pair_features(
    rows, tokenizer: BertTokenizer, max_seq_length: int = 128
) -> dict[str, np.ndarray]:
    ids_l, mask_l, seg_l, y = [], [], [], []
    for a, b, label in rows:
        ta = tokenizer.tokenize(a)
        tb = tokenizer.tokenize(b) if b else []
        # truncate pair to fit (reference _truncate_seq_pair: pop longest)
        budget = max_seq_length - (3 if tb else 2)
        while len(ta) + len(tb) > budget:
            (ta if len(ta) > len(tb) else tb).pop()
        tokens = ["[CLS]"] + ta + ["[SEP]"]
        seg = [0] * len(tokens)
        if tb:
            tokens += tb + ["[SEP]"]
            seg += [1] * (len(tb) + 1)
        ids = tokenizer.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        pad = max_seq_length - len(ids)
        ids_l.append(ids + [0] * pad)
        mask_l.append(mask + [0] * pad)
        seg_l.append(seg + [0] * pad)
        y.append(label)
    return {
        "input_ids": np.asarray(ids_l, np.int32),
        "attention_mask": np.asarray(mask_l, np.int32),
        "token_type_ids": np.asarray(seg_l, np.int32),
        "label": np.asarray(y, np.int32),
    }


def matthews_corrcoef(preds: np.ndarray, labels: np.ndarray) -> float:
    """MCC for CoLA (reference uses sklearn; closed form here)."""
    tp = float(((preds == 1) & (labels == 1)).sum())
    tn = float(((preds == 0) & (labels == 0)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return (tp * tn - fp * fn) / denom if denom else 0.0


def classification_loss(model, model_state, batch: dict,
                        generator: torch.Generator):
    """``(loss, (model_state, {}))``: the mean cross-entropy of the model's
    fp32 logits against ``batch["label"]``, with dropout drawn from
    ``generator`` (GLUE's loss, and SWAG's over the choices)."""
    logits = model(batch["input_ids"], batch["attention_mask"],
                   batch["token_type_ids"], generator=generator)
    return F.cross_entropy(logits, batch["label"].long()), (model_state, {})


@dataclass
class GlueTask:
    cfg: BertConfig
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> BertForSequenceClassification:
        """A model with fresh fp32 weights drawn on the CPU from
        ``generator`` (the JAX initialisers), placed on ``device`` in
        training mode."""
        model = BertForSequenceClassification(self.cfg, self.num_labels,
                                              self.dtype)
        init_bert_weights_(model, generator, self.cfg.initializer_range)
        return model.to(device).train()

    loss_fn = staticmethod(classification_loss)

    @torch.no_grad()
    def metric_fn(self, model: BertForSequenceClassification, model_state,
                  batch: dict):
        """Accuracy without dropout."""
        logits = model(batch["input_ids"], batch["attention_mask"],
                       batch["token_type_ids"])
        return {"accuracy": (logits.argmax(-1) == batch["label"]).float().mean()}
