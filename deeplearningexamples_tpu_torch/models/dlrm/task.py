"""DLRM training task: BCE loss, dual optimizer, AUC evaluation.

Port of ``deeplearningexamples_tpu/models/dlrm/task.py``. The reference
harness (``dlrm/scripts/main.py:387-731``) trains with BCE-with-logits, one
SGD for the embedding table and another for the MLPs (:456-482), and
evaluates AUC over the whole eval set (``dist_evaluate`` :733).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ...core.metrics import roc_auc
from ...core.optimizers import adam, partition, sgd
from ...ops.lamb import Transform
from .model import Dlrm, DlrmConfig

__all__ = ["DlrmTask", "make_dlrm_optimizer"]


def make_dlrm_optimizer(
    mlp_lr: float | Callable[[int], float] = 24.0,
    embedding_lr: float | Callable[[int], float] = 24.0,
    use_adam_for_mlp: bool = False,
) -> Transform:
    """Dual optimizer: plain SGD for ``embedding_table``, plain SGD (or Adam)
    for everything else, as JAX's ``optax.multi_transform`` partition."""
    mlp_tx = adam(mlp_lr) if use_adam_for_mlp else sgd(mlp_lr)
    return partition(
        {"mlp": mlp_tx, "emb": sgd(embedding_lr)},
        lambda name: "emb" if name.split(".")[-1] == "embedding_table" else "mlp")


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy`` per example, fp32."""
    return F.binary_cross_entropy_with_logits(logits.float(), labels.float(),
                                              reduction="none")


@dataclass
class DlrmTask:
    cfg: DlrmConfig
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Dlrm:
        """A model with fresh weights drawn on the CPU from ``generator``
        (the JAX initialisers), then placed on ``device``."""
        model = Dlrm(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device)

    def loss_fn(self, model: Dlrm, model_state, batch: dict,
                generator: torch.Generator | None = None):
        """``(mean BCE, (model_state, {}))``; ``batch`` holds tensors on the
        model's device. The model draws no random numbers."""
        logits = model(batch["numerical"], batch["categorical"])
        return _bce(logits, batch["label"]).mean(), (model_state, {})

    @torch.no_grad()
    def metric_fn(self, model: Dlrm, model_state, batch: dict) -> dict:
        logits = model(batch["numerical"], batch["categorical"])
        return {"auc": roc_auc(logits, batch["label"]),
                "val_loss": _bce(logits, batch["label"]).mean()}

    @torch.no_grad()
    def eval_collect_fn(self, model: Dlrm, model_state, batch: dict) -> dict:
        """Per-batch raw outputs for one reduction over the eval set (the
        reference's ``dist_evaluate`` gathers all scores before one AUC; a
        mean of per-batch AUCs is biased)."""
        logits = model(batch["numerical"], batch["categorical"])
        return {"score": logits.float(), "label": batch["label"].float(),
                "bce": _bce(logits, batch["label"])}

    @staticmethod
    def eval_reduce(flat: dict) -> dict:
        """Full-eval-set AUC + loss from concatenated per-batch outputs (numpy
        copy of JAX's ``DlrmTask.eval_reduce``)."""
        scores, labels = flat["score"], flat["label"]
        order = np.argsort(-scores, kind="stable")
        y = labels[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1.0 - y)
        tpr = np.concatenate([[0.0], tps / max(tps[-1], 1.0)])
        fpr = np.concatenate([[0.0], fps / max(fps[-1], 1.0)])
        # np.trapezoid's sum, written out: numpy before 2.0 lacks the name
        return {
            "auc": float(np.add.reduce(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0)),
            "val_loss": float(np.mean(flat["bce"])),
        }
