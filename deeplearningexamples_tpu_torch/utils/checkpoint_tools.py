"""Checkpoint tools: a training checkpoint to a model repository, and one
image classified.

Port of ``deeplearningexamples_tpu/utils/checkpoint_tools.py`` (the
reference's per-recipe ``checkpoint2model.py`` and ``classify.py``):

- ``strip_checkpoint``: restore a ``TrainState`` checkpoint through
  ``core/checkpoint.CheckpointManager.restore``, keep the EMA parameters
  when asked and present (else the parameters) and the model state (the BN
  statistics), drop the optimizer state and the generator, and write a
  model repository (``serving/export.py``) of the model's whole
  ``state_dict``, which loads strictly;
- ``classify_image``: one JPEG through the port's data plane (the host's
  C++ plane for a CPU model, nvJPEG and the resample kernel for a CUDA one),
  JAX's centre crop (``image_size / 256`` of each side), softmax and top-k
  order.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["strip_checkpoint", "classify_image"]


def strip_checkpoint(
    checkpoint_dir: str,
    state_template: Any,
    out_repo: str,
    name: str,
    input_spec: dict,
    use_ema: bool = False,
    step: int | None = None,
    metadata: dict | None = None,
) -> str:
    """Restore the checkpoint at ``step`` (default the latest) into
    ``state_template`` (a ``TrainState`` of the same model and optimizer)
    and write ``<out_repo>/<name>/`` with ``metadata`` ``{"step", "ema",
    ...}``; returns the repository's path."""
    from ..core.checkpoint import CheckpointManager
    from ..serving.export import save_model_repository

    state = CheckpointManager(checkpoint_dir).restore(state_template, step=step)
    ema = use_ema and state.ema_params is not None
    params = state.ema_params if ema else state.params
    if isinstance(params, torch.Tensor):
        raise ValueError("the checkpoint holds a flat buffer (--flat-lamb); "
                         "restore it into the model's parameters first")
    weights = dict(state.model.state_dict())  # the restored parameters
    weights.update(params)
    # the BN statistics; a model state that is no weight (Transformer-XL's
    # memories) stays behind
    weights.update({k: v for k, v in (state.model_state or {}).items()
                    if k in weights})
    return save_model_repository(
        out_repo, name, weights, input_spec=input_spec,
        metadata={"step": int(state.step), "ema": bool(use_ema),
                  **(metadata or {})},
    )


def classify_image(
    model: torch.nn.Module,
    jpeg_path: str,
    labels: Sequence[str] | None = None,
    image_size: int = 224,
    top_k: int = 5,
) -> list[tuple[str, float]]:
    """The ``top_k`` (label, probability) pairs of one image, best first,
    from an eval-mode forward of ``model`` (NCHW fp32 logits) on its
    device."""
    from ..native import DataPlane

    dev = next(model.parameters()).device
    plane = DataPlane(1, device=dev.type)
    with open(jpeg_path, "rb") as f:
        data = f.read()
    frac = image_size / 256.0
    crops = np.asarray([[(1 - frac) / 2, (1 - frac) / 2, frac, frac]],
                       np.float32)
    img = plane.decode_batch([data], crops, np.zeros(1, np.int32), image_size)
    img = torch.as_tensor(img).to(dev)
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = model(img.permute(0, 3, 1, 2))
    finally:
        model.train(training)
    probs = torch.softmax(logits.float(), -1)[0].cpu().numpy()
    idx = np.argsort(probs)[-top_k:][::-1]
    return [(labels[i] if labels else str(i), float(probs[i])) for i in idx]
