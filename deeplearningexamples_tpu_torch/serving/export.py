"""Model repository export and load: a directory per model that a server
process registers an endpoint from without importing training code.

Port of ``deeplearningexamples_tpu/serving/export.py`` (the role of the
reference's ``triton/deployment_toolkit``)::

    <repo>/<name>/config.json   # inputs/outputs spec, batch buckets, precision
    <repo>/<name>/weights.pt    # the model's state_dict, written by torch.save

``config.json`` has JAX's keys (``name``, ``inputs``, ``outputs``,
``batch_buckets``, ``precision``, ``metadata``). The weights are the port's
own format: a flat ``state_dict`` (name -> tensor, the reference's names),
read back with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

__all__ = ["save_model_repository", "load_model_repository"]

WEIGHTS = "weights.pt"


def save_model_repository(
    repo_dir: str,
    name: str,
    state_dict: Mapping[str, torch.Tensor],
    input_spec: Mapping[str, tuple],  # name -> (shape-without-batch, dtype str)
    output_names: tuple = (),
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32),
    precision: str = "bf16",
    metadata: Mapping[str, Any] | None = None,
) -> str:
    """Write ``<repo_dir>/<name>/`` and return its path; the tensors are
    saved as CPU copies."""
    model_dir = os.path.join(os.path.abspath(repo_dir), name)
    os.makedirs(model_dir, exist_ok=True)
    config = {
        "name": name,
        "inputs": {k: {"shape": list(s), "dtype": d}
                   for k, (s, d) in input_spec.items()},
        "outputs": list(output_names),
        "batch_buckets": list(batch_buckets),
        "precision": precision,
        "metadata": dict(metadata or {}),
    }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    weights = {k: v.detach().cpu().clone() for k, v in state_dict.items()}
    path = os.path.join(model_dir, WEIGHTS)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(weights, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return model_dir


def load_model_repository(repo_dir: str, name: str,
                          model: torch.nn.Module | None = None):
    """Returns ``(state_dict, config)``, the tensors on the CPU. Given
    ``model``, also loads the weights into it, strictly (every entry of its
    ``state_dict`` and no other), on its own device."""
    model_dir = os.path.join(os.path.abspath(repo_dir), name)
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    state_dict = torch.load(os.path.join(model_dir, WEIGHTS),
                            map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(state_dict, strict=True)
    return state_dict, config
