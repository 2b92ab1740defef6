"""The layout of a flat, block-padded parameter buffer.

Port of ``FlatLayout`` from ``deeplearningexamples_tpu/ops/fused_lamb.py``.
The JAX module's own ``fused_lamb`` entry point (which packs a tree into a
buffer on every step) is not ported yet; its math is the flat LAMB of
``core/flat.py``, whose kernels live in ``csrc/flat_lamb.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["FlatLayout"]


class FlatLayout(NamedTuple):
    names: tuple  # leaf names, in buffer order (the JAX layout's treedef)
    shapes: tuple
    starts: np.ndarray  # padded start offset per leaf
    sizes: np.ndarray  # true size per leaf
    total: int  # padded total
    seg_ids: np.ndarray  # (total // block,) leaf index per block
    n_leaves: int
