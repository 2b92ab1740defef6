"""Device-side evaluation metrics.

Port of ``deeplearningexamples_tpu/core/metrics.py``: ``roc_auc``, the sort +
trapezoid ROC-AUC of the reference's GPU AUC (``dlrm/scripts/utils.py:289-320``:
sort by score, cumulative TPR/FPR, trapz), on the scores' device.
"""

from __future__ import annotations

import torch

__all__ = ["roc_auc"]


def roc_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """AUC-ROC of binary ``labels`` (0/1 float) under ``scores`` (higher =
    positive), a 0-d fp32 tensor. Tied scores keep their input order, as
    ``jnp.argsort`` (stable) leaves them, which decides how ties fall."""
    order = torch.argsort(-scores, stable=True)
    y = labels[order].float()
    tps = torch.cumsum(y, 0)
    fps = torch.cumsum(1.0 - y, 0)
    tpr = tps / torch.clamp(tps[-1], min=1.0)
    fpr = fps / torch.clamp(fps[-1], min=1.0)
    zero = tpr.new_zeros(1)
    tpr = torch.cat([zero, tpr])
    fpr = torch.cat([zero, fpr])
    return 0.5 * ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])).sum()
