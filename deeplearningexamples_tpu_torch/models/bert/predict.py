"""SQuAD prediction: features -> batched inference -> answer texts.

Port of ``deeplearningexamples_tpu/models/bert/predict.py``: ``jax.jit``
becomes ``torch.inference_mode`` (in ``BertSquadTask.predict_fn``); the last
batch is padded to ``batch_size`` by repeating its last feature, as the JAX
version pads to its compiled shape. ``read_squad_references``,
``aggregate_predictions`` and ``write_predictions`` are the JAX package's
numpy code.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np
import torch

from ...data.squad import SquadFeature
from .squad_eval import decode_span

__all__ = ["predict_squad", "aggregate_predictions", "read_squad_references",
           "write_predictions"]


def read_squad_references(dev_json_path: str) -> dict[str, list[str]]:
    """{qid: [gold answer texts]} from a SQuAD v1.1/v2 dev json (an
    unanswerable question's list is ``[""]``)."""
    with open(dev_json_path, encoding="utf-8") as f:
        data = json.load(f)["data"]
    refs: dict[str, list[str]] = {}
    for article in data:
        for para in article["paragraphs"]:
            for qa in para["qas"]:
                refs[qa["id"]] = [a["text"] for a in qa["answers"]] or [""]
    return refs


def aggregate_predictions(
    features: Sequence[SquadFeature],
    start_logits: np.ndarray,  # (len(features), S)
    end_logits: np.ndarray,
    n_best: int = 20,
    max_answer_length: int = 30,
    version_2_with_negative: bool = False,
    null_score_diff_threshold: float = 0.0,
) -> tuple[dict[str, str], dict[str, float]]:
    """Per-question best answer across doc-stride features, plus null odds.

    v2 semantics follow the reference (``run_squad.py:430-478``): the null
    score of a feature is ``start[0] + end[0]`` (the [CLS] position), the
    question's null score is the MIN over its features, and the prediction
    is empty iff ``score_null - best_span_score > null_score_diff_threshold``.
    Returns (predictions, null_odds); null_odds is empty for v1.
    """
    best: dict[str, tuple[float, str]] = {}
    null_score: dict[str, float] = {}
    for j, f in enumerate(features):
        sl = np.asarray(start_logits[j], np.float32)
        el = np.asarray(end_logits[j], np.float32)
        if version_2_with_negative:
            score_null = float(sl[0] + el[0])
            null_score[f.qid] = min(
                null_score.get(f.qid, np.inf), score_null
            )
        valid = np.zeros(sl.shape[0], bool)
        for pos in f.token_to_orig:
            # reference get_valid_prelim_predictions: start must be a
            # max-context doc token of this feature
            valid[pos] = f.token_is_max_context.get(pos, False)
        s, e, score = decode_span(
            sl, el, valid, n_best=n_best, max_answer_length=max_answer_length,
        )
        if s not in f.token_to_orig or e not in f.token_to_orig:
            continue
        text = " ".join(f.doc_tokens[f.token_to_orig[s] : f.token_to_orig[e] + 1])
        if f.qid not in best or score > best[f.qid][0]:
            best[f.qid] = (score, text)

    predictions: dict[str, str] = {}
    null_odds: dict[str, float] = {}
    for qid, (span_score, text) in best.items():
        if version_2_with_negative:
            diff = null_score[qid] - span_score
            null_odds[qid] = diff
            predictions[qid] = "" if diff > null_score_diff_threshold else text
        else:
            predictions[qid] = text
    if version_2_with_negative:
        # questions whose every feature failed span decoding are null
        for qid, ns in null_score.items():
            if qid not in predictions:
                predictions[qid] = ""
                null_odds[qid] = ns
    return predictions, null_odds


def predict_squad(
    task,
    model,
    features: Sequence[SquadFeature],
    batch_size: int = 32,
    n_best: int = 20,
    max_answer_length: int = 30,
    version_2_with_negative: bool = False,
    null_score_diff_threshold: float = 0.0,
    return_null_odds: bool = False,
    device: torch.device | str | None = None,
):
    """Best answer text per question across its doc-stride features, from a
    serving model or a training model (in its training dtype), without
    dropout. ``device`` defaults to the device of the model's parameters."""
    if device is None:
        device = next(model.parameters()).device
    all_start, all_end = [], []
    for i in range(0, len(features), batch_size):
        chunk = list(features[i : i + batch_size])
        real = len(chunk)
        while len(chunk) < batch_size:  # pad to a fixed batch shape
            chunk.append(chunk[-1])
        batch = {
            name: torch.from_numpy(
                np.stack([getattr(f, name) for f in chunk])).to(device)
            for name in ("input_ids", "attention_mask", "token_type_ids")
        }
        start_logits, end_logits = task.predict_fn(model, batch)
        all_start.append(start_logits.float().cpu().numpy()[:real])
        all_end.append(end_logits.float().cpu().numpy()[:real])
    predictions, null_odds = aggregate_predictions(
        features,
        np.concatenate(all_start) if all_start else np.zeros((0, 1)),
        np.concatenate(all_end) if all_end else np.zeros((0, 1)),
        n_best=n_best, max_answer_length=max_answer_length,
        version_2_with_negative=version_2_with_negative,
        null_score_diff_threshold=null_score_diff_threshold,
    )
    if return_null_odds:
        return predictions, null_odds
    return predictions


def write_predictions(predictions: dict[str, str], path: str) -> None:
    """The reference's ``predictions.json`` artifact (``run_squad.py:1102``)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(predictions, f, indent=2, ensure_ascii=False)
