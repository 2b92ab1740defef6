"""Carry the JAX package's parameter trees into the port (numpy only).

The JAX package keeps flax parameter trees; the port keeps the NVIDIA/HF
``state_dict`` names. This is the inverse of the JAX package's
``utils/torch_import.convert_bert`` (which maps HF names onto the JAX tree),
extended to the QA head and the pretraining heads. The word table keeps its
``padded_vocab`` rows, and the MLM decoder, tied to it, has no entry of its
own. The mapping is structural, so it carries any tree of that shape across:
parameters, or the gradients ``jax.grad`` returns for them.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = [
    "bert_pretrain_jax_order",
    "bert_pretrain_state_dict_from_jax",
    "bert_qa_state_dict_from_jax",
]

# (JAX path, port name, transpose): flax Dense kernels are (in, out), torch
# Linear weights (out, in)
Entry = tuple[tuple[str, ...], str, bool]


def _dense(path: tuple[str, ...], name: str) -> list[Entry]:
    return [(path + ("bias",), f"{name}.bias", False),
            (path + ("kernel",), f"{name}.weight", True)]


def _layer_norm(path: tuple[str, ...], name: str) -> list[Entry]:
    return [(path + ("bias",), f"{name}.bias", False),
            (path + ("scale",), f"{name}.weight", False)]


def _encoder_entries(num_layers: int) -> list[Entry]:
    out: list[Entry] = []
    emb = ("bert", "embeddings")
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out.append((emb + (name, "embedding"), f"bert.embeddings.{name}.weight",
                    False))
    out += _layer_norm(emb + ("LayerNorm",), "bert.embeddings.LayerNorm")
    for i in range(num_layers):
        src, dst = ("bert", f"layer_{i}"), f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            out += _dense(src + ("attention", n), f"{dst}.attention.self.{n}")
        out += _dense(src + ("attention", "output"),
                      f"{dst}.attention.output.dense")
        out += _layer_norm(src + ("attention_ln",),
                           f"{dst}.attention.output.LayerNorm")
        out += _dense(src + ("intermediate",), f"{dst}.intermediate.dense")
        out += _dense(src + ("ffn_output",), f"{dst}.output.dense")
        out += _layer_norm(src + ("output_ln",), f"{dst}.output.LayerNorm")
    out += _dense(("bert", "pooler"), "bert.pooler.dense")
    return out


def _pretrain_entries(num_layers: int) -> list[Entry]:
    return (_encoder_entries(num_layers)
            + _dense(("mlm_transform",), "cls.predictions.transform.dense")
            + _layer_norm(("mlm_ln",), "cls.predictions.transform.LayerNorm")
            + [(("mlm_bias",), "cls.predictions.bias", False)]
            + _dense(("nsp",), "cls.seq_relationship"))


def _num_layers(tree: Mapping[str, Any]) -> int:
    return sum(1 for k in tree["bert"] if k.startswith("layer_"))


def _convert(tree: Mapping[str, Any], entries: list[Entry]) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    for path, name, transpose in entries:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        leaf = np.asarray(leaf)
        sd[name] = np.ascontiguousarray(leaf.T) if transpose else leaf
    return sd


def bert_qa_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``BertForQuestionAnswering`` params (``{"bert": ..., "qa_outputs":
    ...}``, leaves as arrays) -> the port's ``state_dict`` as numpy arrays."""
    return _convert(params, _encoder_entries(_num_layers(params))
                    + _dense(("qa_outputs",), "qa_outputs"))


def bert_pretrain_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``BertForPreTraining`` params, or their gradients (``{"bert",
    "mlm_transform", "mlm_ln", "mlm_bias", "nsp"}``) -> the port's
    ``BertForPreTraining`` ``state_dict`` names, as numpy arrays."""
    return _convert(tree, _pretrain_entries(_num_layers(tree)))


def bert_pretrain_jax_order(num_layers: int) -> list[str]:
    """The port's ``BertForPreTraining`` parameter names in the order
    ``jax.tree_util.tree_leaves`` visits the JAX tree (keys sorted at every
    level), so a flat buffer laid out in this order matches the JAX
    package's ``_make_layout_blocked`` offset for offset."""
    return [name for _, name, _ in sorted(_pretrain_entries(num_layers))]
