"""DLRM dot-based feature interaction.

Port of ``deeplearningexamples_tpu/ops/dot_interaction.py``. JAX computes it
in ``jnp`` outside any Pallas kernel, so the port does it in plain PyTorch::

    input:  bottom-MLP output x0 (B, D) + embeddings (B, F-1, D)
    G     = X X^T  for X = concat([x0, emb])  (B, F, F)
    out   = concat([x0, tril(G, k=-1) flattened, zero-pad], -1)

with the pad sizing the output to ``D + F(F-1)/2 + pad`` (27 features at
D=128 give 480). As JAX's ``preferred_element_type=jnp.float32``, the batched
product is taken in fp32 and its lower triangle cast back to x0's dtype.
``dot_interaction_reference`` is the numpy oracle, a copy of JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dot_interaction", "dot_interaction_reference",
           "interaction_output_dim"]


def interaction_output_dim(num_features: int, embed_dim: int,
                           pad_to_multiple: int = 8) -> int:
    raw = embed_dim + num_features * (num_features - 1) // 2
    return ((raw + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple


def dot_interaction(bottom_out: torch.Tensor, embeddings: torch.Tensor,
                    pad_to_multiple: int = 8) -> torch.Tensor:
    """bottom_out (B, D), embeddings (B, F-1, D) -> (B, out_dim) in
    bottom_out's dtype."""
    b, d = bottom_out.shape
    x = torch.cat([bottom_out[:, None, :], embeddings.to(bottom_out.dtype)], 1)
    f = x.shape[1]
    x32 = x.float()
    g = torch.bmm(x32, x32.transpose(1, 2))  # (B, F, F)
    rows, cols = np.tril_indices(f, k=-1)
    flat_idx = torch.as_tensor(rows * f + cols, device=x.device)
    tril = g.reshape(b, f * f).index_select(1, flat_idx).to(bottom_out.dtype)
    pad = interaction_output_dim(f, d, pad_to_multiple) - d - tril.shape[1]
    parts = [bottom_out, tril]
    if pad:
        parts.append(bottom_out.new_zeros((b, pad)))
    return torch.cat(parts, 1)


def dot_interaction_reference(bottom_out, embeddings, pad_to_multiple: int = 8):
    """Numpy oracle with the identical layout."""
    b, d = bottom_out.shape
    x = np.concatenate([bottom_out[:, None, :], embeddings], axis=1)
    f = x.shape[1]
    g = np.einsum("bfd,bgd->bfg", x.astype(np.float64), x.astype(np.float64))
    rows, cols = np.tril_indices(f, k=-1)
    tril = g[:, rows, cols]
    out_dim = interaction_output_dim(f, d, pad_to_multiple)
    out = np.zeros((b, out_dim), np.float64)
    out[:, :d] = bottom_out
    out[:, d : d + tril.shape[1]] = tril
    return out
