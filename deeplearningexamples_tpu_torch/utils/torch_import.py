"""Load a BERT encoder from a torch checkpoint with NVIDIA/HF names.

Port of ``load_bert_encoder`` and ``convert_bert`` in
``deeplearningexamples_tpu/utils/torch_import.py`` for the torch checkpoint
path. The port's modules carry the NVIDIA/HF names, so no renaming is needed:
the file's tensors are read (a plain ``state_dict``, or one under ``"model"``
or ``"state_dict"``), ``module.`` and ``bert.`` prefixes are stripped, the
word table is padded with zero rows to ``padded_vocab``, and only the encoder
(embeddings, layers, pooler) is loaded: a head keeps its own weights.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["load_bert_encoder"]

_WORD = "embeddings.word_embeddings.weight"


def load_bert_encoder(bert: nn.Module, path: str) -> None:
    """Copy the encoder weights of the torch file at ``path`` into ``bert``
    (a ``BertModel``) in place, in its parameters' dtype."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    sd = {k.removeprefix("module.").removeprefix("bert."): v
          for k, v in obj.items() if isinstance(v, torch.Tensor)}
    want = bert.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} encoder tensors, e.g. "
                       f"{missing[:3]}")
    word = sd[_WORD]
    rows = want[_WORD].shape[0]
    if word.shape[0] > rows or word.shape[1:] != want[_WORD].shape[1:]:
        raise ValueError(f"{path}: word table {tuple(word.shape)} does not fit "
                         f"{tuple(want[_WORD].shape)}")
    padded = torch.zeros((rows, word.shape[1]), dtype=word.dtype)
    padded[: word.shape[0]] = word
    bert.load_state_dict({**{k: sd[k] for k in want}, _WORD: padded},
                         strict=True)
