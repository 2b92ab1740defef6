"""Classification losses, mixup, top-k accuracy and the CTC loss.

Port of ``deeplearningexamples_tpu/core/losses.py`` (reference
``image_classification/smoothing.py:18``, ``mixup.py:17-48``,
``utils.py:101-114``). Every loss is taken on fp32 logits and is a mean over
the batch.

- ``smoothed_cross_entropy`` puts ``1 - s`` on the target and ``s / (C - 1)``
  on each other class, as the reference's ``LabelSmoothing``.
  ``F.cross_entropy(label_smoothing=s)`` spreads ``s / C`` over every class,
  the target included, which is another loss.
- ``mixup`` draws its one Beta(alpha, alpha) lambda per batch on the host
  from the step's generator. JAX's ``jax.random.beta`` bits cannot be
  matched, so parity holds at a given lambda.
- ``ctc_loss`` has ``optax.ctc_loss``'s meaning (per-sequence negative
  log-likelihood, paddings 1 = pad, blank 0, log-softmax taken of the
  logits first) through ``F.ctc_loss``. On a label sequence that no
  alignment of the valid frames can emit, optax gives a large finite loss
  (its ``log_epsilon`` is -1e5) and this one ``inf``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import global_flip

__all__ = ["ctc_loss", "cross_entropy", "mixup", "smoothed_cross_entropy",
           "top_k_accuracy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE. Integer labels (B,) or soft labels (B, C)."""
    logits = logits.float()
    if labels.dim() == logits.dim():
        return -(labels * F.log_softmax(logits, -1)).sum(-1).mean()
    return F.cross_entropy(logits, labels.long())


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE: ``1 - smoothing`` on the target, ``smoothing /
    (C - 1)`` on every other class. Integer or soft labels; soft labels (the
    mixup path) are smoothed the same way."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), -1)
    soft = labels if labels.dim() == logits.dim() else \
        F.one_hot(labels.long(), num_classes).float()
    off = smoothing / (num_classes - 1)
    soft = soft * (1.0 - smoothing - off) + off
    return -(soft * logp).sum(-1).mean()


def mixup(generator: torch.Generator, alpha: float, images: torch.Tensor,
          one_hot_labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch mixup: each sample mixed with the reversed batch, ``lam * x +
    (1 - lam) * x[::-1]``, labels alike. ``lam`` is one Beta(alpha, alpha)
    draw per batch, made on the host from a seed that ``generator`` (a CPU
    generator) gives."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    lam32 = np.float32(np.random.default_rng(seed).beta(alpha, alpha))
    a, b = float(lam32), float(np.float32(1.0) - lam32)
    # the global batch reversed, under a data axis too (as JAX's x[::-1])
    images = a * images + b * global_flip(images)
    labels = a * one_hot_labels + b * global_flip(one_hot_labels)
    return images, labels


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   ks=(1, 5)) -> dict[str, torch.Tensor]:
    """``{"top1": ..., "top5": ...}``: the share of rows whose label is among
    the k largest logits (ties broken as JAX's reversed stable argsort).
    Integer labels, or one-hot labels read by their argmax."""
    if labels.dim() == 2:
        labels = labels.argmax(-1)
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels.long()[:, None]).any(-1)
        out[f"top{k}"] = hit.float().mean()
    return out


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-sequence CTC loss (B,) of logits (B, T, C), fp32 or float64, as
    ``optax.ctc_loss``: the paddings (B, T) and (B, L) are 1 at the pads,
    which trail the valid steps. The log-softmax is taken here, so
    log-probabilities may be passed again (their gradient is unchanged)."""
    logp = F.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
    in_len = (1.0 - logit_paddings.float()).sum(1).round().long()
    tgt_len = (1.0 - label_paddings.float()).sum(1).round().long()
    return F.ctc_loss(logp.transpose(0, 1), labels.long(), in_len, tgt_len,
                      blank=blank_id, reduction="none")
