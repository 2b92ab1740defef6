"""Carry the JAX package's parameter trees into the port (numpy only).

The JAX package keeps flax parameter trees; the port keeps the NVIDIA/HF
``state_dict`` names. This is the inverse of the JAX package's
``utils/torch_import.convert_bert`` (which maps HF names onto the JAX tree),
extended to the QA head, the pretraining heads and the classifier of the
GLUE and SWAG heads, of a bare ``BertModel`` tree (a distillation teacher)
and of a distillation student with its ``distill_proj``, of DLRM's tree into the port's ``Dlrm`` names, and of
``convert_resnet50`` and ``convert_efficientnet`` for the ConvNets and of
``convert_ssd300`` for SSD300 (their ``batch_stats`` too), and of
``convert_tacotron2`` and ``convert_waveglow`` for Tacotron2 and WaveGlow,
and of ``convert_nmt_transformer``, ``convert_bart`` and ``convert_gnmt`` for
the encoder-decoder models, and of ``convert_fastpitch``,
``convert_hifigan_generator``, ``convert_wav2vec2`` and ``convert_jasper``
for the speech models (with HiFi-GAN's discriminators, wav2vec2's CTC model
and QuartzNet's separable blocks, which no JAX converter covers), and of
``convert_ncf``, ``convert_tft``, ``convert_brats_unet3d``,
``convert_transformer_xl`` and ``convert_moflow`` (its ``batch_stats``
too), with nnU-Net's ``DynUNet``, which no JAX converter covers, and of
``convert_maskrcnn_heads`` for Mask R-CNN (its ResNet backbone through the
ConvNets' names) and of the SE(3)-Transformer, which no JAX converter
covers, and of ``MoEFeedForward`` and the stacked stage trees of
``parallel/pipeline.py``. The word table keeps its ``padded_vocab`` rows, and the MLM decoder, tied to it, has no entry of its own. The mapping is
structural, so it carries any tree of that shape across:
parameters, or the gradients ``jax.grad`` returns for them.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = [
    "bart_state_dict_from_jax",
    "bert_classifier_state_dict_from_jax",
    "brats_unet3d_state_dict_from_jax",
    "bert_model_state_dict_from_jax",
    "bert_pretrain_jax_order",
    "bert_pretrain_state_dict_from_jax",
    "bert_qa_state_dict_from_jax",
    "distill_student_state_dict_from_jax",
    "dlrm_state_dict_from_jax",
    "dynunet_state_dict_from_jax",
    "efficientdet_state_dict_from_jax",
    "efficientnet_state_dict_from_jax",
    "fastpitch_state_dict_from_jax",
    "gnmt_state_dict_from_jax",
    "gpunet_state_dict_from_jax",
    "hifigan_discriminators_state_dict_from_jax",
    "hifigan_generator_state_dict_from_jax",
    "jasper_state_dict_from_jax",
    "maskrcnn_state_dict_from_jax",
    "moe_state_dict_from_jax",
    "moflow_state_dict_from_jax",
    "ncf_state_dict_from_jax",
    "resnet_state_dict_from_jax",
    "se3_state_dict_from_jax",
    "stacked_stages_from_jax",
    "ssd300_state_dict_from_jax",
    "tacotron2_state_dict_from_jax",
    "tft_state_dict_from_jax",
    "transformer_state_dict_from_jax",
    "transformer_xl_state_dict_from_jax",
    "waveglow_state_dict_from_jax",
    "wav2vec2_state_dict_from_jax",
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


def bert_classifier_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``BertForSequenceClassification`` or ``BertForMultipleChoice``
    params, or their gradients (``{"bert": ..., "classifier": ...}``) -> the
    port's ``state_dict`` of the same head, as numpy arrays."""
    return _convert(tree, _encoder_entries(_num_layers(tree))
                    + _dense(("classifier",), "classifier"))


def bert_pretrain_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``BertForPreTraining`` params, or their gradients (``{"bert",
    "mlm_transform", "mlm_ln", "mlm_bias", "nsp"}``) -> the port's
    ``BertForPreTraining`` ``state_dict`` names, as numpy arrays."""
    return _convert(tree, _pretrain_entries(_num_layers(tree)))


def bert_model_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A bare JAX ``BertModel`` tree (``{"embeddings", "layer_i", "pooler"}``,
    e.g. a distillation teacher), or its gradients -> the port's
    ``BertModel`` ``state_dict`` names, as numpy arrays."""
    wrapped = {"bert": tree}
    return {name[len("bert."):]: v for name, v in _convert(
        wrapped, _encoder_entries(_num_layers(wrapped))).items()}


def distill_student_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``DistillationTask`` student params (a bare ``BertModel`` tree
    plus ``distill_proj`` when the widths differ), or their gradients -> the
    port's ``DistillationStudent`` names (``bert.*``, ``distill_proj`` kept
    (student width, teacher width), as JAX applies it)."""
    body = {k: v for k, v in tree.items() if k != "distill_proj"}
    sd = {f"bert.{k}": v for k, v in bert_model_state_dict_from_jax(body).items()}
    if "distill_proj" in tree:
        sd["distill_proj"] = np.asarray(tree["distill_proj"])
    return sd


def bert_pretrain_jax_order(num_layers: int) -> list[str]:
    """The port's ``BertForPreTraining`` parameter names in the order
    ``jax.tree_util.tree_leaves`` visits the JAX tree (keys sorted at every
    level), so a flat buffer laid out in this order matches the JAX
    package's ``_make_layout_blocked`` offset for offset."""
    return [name for _, name, _ in sorted(_pretrain_entries(num_layers))]


def dlrm_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``Dlrm`` params, or their gradients (``{"embedding_table",
    "bottom_mlp_{i}", "top_mlp_{i}"}``) -> the port's ``Dlrm`` ``state_dict``
    (``embedding_table``, ``bottom_mlp.{i}.weight/bias``, ``top_mlp.{i}...``),
    as numpy arrays, each Dense kernel transposed."""
    entries: list[Entry] = [(("embedding_table",), "embedding_table", False)]
    for key in sorted(k for k in tree if k != "embedding_table"):
        stack, _, i = key.rpartition("_")
        entries += _dense((key,), f"{stack}.{i}")
    return _convert(tree, entries)


# flax leaf -> the port's buffer or parameter name under the same module
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _leaf(value: Any) -> np.ndarray:
    """Conv kernels HWIO -> OIHW (a grouped kernel's I is in / groups), dense
    kernels (in, out) -> (out, in); anything else as it is."""
    x = np.asarray(value)
    if x.ndim == 4:
        return np.ascontiguousarray(x.transpose(3, 2, 0, 1))
    if x.ndim == 2:
        return np.ascontiguousarray(x.T)
    return x


def _walk(tree: Mapping[str, Any], rename, prefix: str,
          sd: dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, rename, f"{prefix}{rename(key)}.", sd)
        else:
            sd[f"{prefix}{_LEAF[key]}"] = _leaf(value)


def _convnet(params, batch_stats, rename) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    _walk(params, rename, "", sd)
    if batch_stats is not None:
        _walk(batch_stats, rename, "", sd)
    return sd


def _resnet_name(key: str) -> str:
    if key.startswith("layer"):  # layer{i}_{j} -> layer{i}.{j}
        return key.replace("_", ".")
    return {"downsample_conv": "downsample.0",
            "downsample_bn": "downsample.1"}.get(key, key)


_EFFNET_NAMES = {
    "stem_conv": "stem.conv", "stem_bn": "stem.bn",
    "expand_conv": "expand.conv", "expand_bn": "expand.bn",
    "depthwise_conv": "depsep.conv", "depthwise_bn": "depsep.bn",
    "project_conv": "proj.conv", "project_bn": "proj.bn",
    "head_conv": "features.conv", "head_bn": "features.bn",
    "fc": "classifier.fc",
}


def _effnet_name(key: str) -> str:
    if key.startswith("stage"):  # stage{s}_{j} -> layers.{s}.block{j}
        s, j = key[len("stage"):].split("_")
        return f"layers.{s}.block{j}"
    return _EFFNET_NAMES.get(key, key)


def resnet_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] | None = None
                               ) -> dict[str, np.ndarray]:
    """JAX ``ResNet`` params (any arch of ``ARCHS``), or their gradients,
    and optionally its ``batch_stats`` -> the port's ``ResNet``
    ``state_dict`` (the reference's names), as numpy arrays."""
    return _convnet(params, batch_stats, _resnet_name)


def efficientnet_state_dict_from_jax(params: Mapping[str, Any],
                                     batch_stats: Mapping[str, Any] | None = None
                                     ) -> dict[str, np.ndarray]:
    """JAX ``EfficientNet`` params, or their gradients, and optionally its
    ``batch_stats`` -> the port's ``EfficientNet`` ``state_dict`` (the
    reference's names), as numpy arrays."""
    return _convnet(params, batch_stats, _effnet_name)



def _gpunet_name(key: str) -> str:
    if key[0] == "l" and key[1].isdigit():  # l{i}_{part} -> layers.{i}.{part}
        i, part = key[1:].split("_", 1)
        return f"layers.{i}.{part}"
    return {"stem_conv": "stem.conv", "stem_bn": "stem.bn",
            "head_conv": "head.conv", "head_bn": "head.bn",
            "reduce": "squeeze"}.get(key, key)


def gpunet_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] | None = None
                               ) -> dict[str, np.ndarray]:
    """JAX ``GPUNet`` params (any arch of ``GPUNET_ARCHS``), or their
    gradients, and optionally its ``batch_stats`` -> the port's ``GPUNet``
    ``state_dict``, as numpy arrays."""
    return _convnet(params, batch_stats, _gpunet_name)


def efficientdet_state_dict_from_jax(params: Mapping[str, Any],
                                     batch_stats: Mapping[str, Any] | None = None
                                     ) -> dict[str, np.ndarray]:
    """JAX ``EfficientDet`` params, or their gradients, and optionally its
    ``batch_stats`` -> the port's ``EfficientDet`` ``state_dict``: the
    backbone under ``backbone.`` with EfficientNet's names, the rest under
    JAX's names (the BiFPN's fusion weights ``node{n}_weights`` as they
    are)."""
    sd: dict[str, np.ndarray] = {}
    for tree in (params, batch_stats or {}):
        for key, value in tree.items():
            if key == "backbone":
                _walk(value, _effnet_name, "backbone.", sd)
                continue
            for sub, leaf in value.items():
                if isinstance(leaf, Mapping):
                    _walk({sub: leaf}, lambda k: k, f"{key}.", sd)
                else:  # a BiFPN layer's fusion weights
                    sd[f"{key}.{sub}"] = np.asarray(leaf)
    return sd


# anchors per location of SSD300's six feature maps (``models/ssd/model.py``)
_SSD_ANCHORS = (4, 6, 6, 6, 4, 4)
_SSD_EXTRA = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}


def _ssd_module(path: tuple[str, ...]) -> str:
    """A module's path in JAX's SSD300 tree -> the reference's name: the
    backbone's ``conv1``, ``bn1`` and ``layer{l}_{j}`` are
    ``feature_extractor.feature_extractor.{0, 1, l + 3}`` (a block's own
    names as in ResNet), ``extra{i}_{conv1,bn1,conv2,bn2}`` are
    ``additional_blocks.{i}.{0,1,3,4}``, ``loc{i}`` and ``conf{i}`` are
    ``loc.{i}`` and ``conf.{i}``."""
    top, rest = path[0], path[1:]
    if top == "backbone":
        fe, stage = "feature_extractor.feature_extractor", rest[0]
        if stage in ("conv1", "bn1"):
            return f"{fe}.{_SSD_EXTRA[stage]}"
        layer, j = stage[len("layer"):].split("_")
        return ".".join([fe, str(int(layer) + 3), j,
                         *map(_resnet_name, rest[1:])])
    if top.startswith("extra"):
        i, part = top[len("extra"):].split("_", 1)
        return f"additional_blocks.{i}.{_SSD_EXTRA[part]}"
    head = top.rstrip("0123456789")
    return f"{head}.{top[len(head):]}"


def _ssd_walk(tree: Mapping[str, Any], path: tuple[str, ...],
              sd: dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _ssd_walk(value, path + (key,), sd)
        else:
            sd[f"{_ssd_module(path)}.{_LEAF[key]}"] = _leaf(value)


def ssd300_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] | None = None
                               ) -> dict[str, np.ndarray]:
    """JAX ``SSD300`` params, or their gradients, and optionally its
    ``batch_stats`` -> the port's ``SSD300`` ``state_dict`` (the reference's
    names), as numpy arrays. JAX's head kernels hold coordinate (or class)
    ``k`` of anchor ``a`` in output channel ``a * K + k``, the reference's
    in ``k * A + a``: each head's channels are permuted back, the inverse of
    ``convert_ssd300``'s permutation."""
    sd: dict[str, np.ndarray] = {}
    _ssd_walk(params, (), sd)
    if batch_stats is not None:
        _ssd_walk(batch_stats, (), sd)
    for head in ("loc", "conf"):
        for i, na in enumerate(_SSD_ANCHORS):
            w = sd[f"{head}.{i}.weight"]
            k = w.shape[0] // na
            perm = np.array([a * k + c for c in range(k) for a in range(na)])
            sd[f"{head}.{i}.weight"] = np.ascontiguousarray(w[perm])
            sd[f"{head}.{i}.bias"] = sd[f"{head}.{i}.bias"][perm]
    return sd


def _t(x: Any) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).T)


def _conv1d(kernel: Any) -> np.ndarray:
    """flax 1-D kernel (k, in, out) -> torch Conv1d (out, in, k)."""
    return np.ascontiguousarray(np.asarray(kernel).transpose(2, 1, 0))


def _lstm_cell(tree: Mapping[str, Any], dst: str, suffix: str = "") -> dict:
    """flax ``OptimizedLSTMCell`` (``ii/if/ig/io`` kernels, ``hi/hf/hg/ho``
    kernels and biases) -> the port's ``LSTMCell`` / ``BiLSTM``: gate rows
    ``[i, f, g, o]``, flax's bias in ``bias_hh``, ``bias_ih`` zeros."""
    gates = "ifgo"
    b = np.concatenate([np.asarray(tree[f"h{g}"]["bias"]) for g in gates])
    return {
        f"{dst}.weight_ih{suffix}": np.concatenate(
            [_t(tree[f"i{g}"]["kernel"]) for g in gates]),
        f"{dst}.weight_hh{suffix}": np.concatenate(
            [_t(tree[f"h{g}"]["kernel"]) for g in gates]),
        f"{dst}.bias_hh{suffix}": b,
        f"{dst}.bias_ih{suffix}": np.zeros_like(b),
    }


def _conv_bn(params, stats, i: int, dst: str) -> dict:
    """flax ``conv{i}`` and ``bn{i}`` -> ``{dst}.{i}.0.conv`` and
    ``{dst}.{i}.1``."""
    sd = {f"{dst}.{i}.0.conv.weight": _conv1d(params[f"conv{i}"]["kernel"]),
          f"{dst}.{i}.0.conv.bias": np.asarray(params[f"conv{i}"]["bias"]),
          f"{dst}.{i}.1.weight": np.asarray(params[f"bn{i}"]["scale"]),
          f"{dst}.{i}.1.bias": np.asarray(params[f"bn{i}"]["bias"])}
    if stats is not None:
        sd[f"{dst}.{i}.1.running_mean"] = np.asarray(stats[f"bn{i}"]["mean"])
        sd[f"{dst}.{i}.1.running_var"] = np.asarray(stats[f"bn{i}"]["var"])
    return sd


def tacotron2_state_dict_from_jax(params: Mapping[str, Any],
                                  batch_stats: Mapping[str, Any] | None = None
                                  ) -> dict[str, np.ndarray]:
    """JAX ``Tacotron2`` params, or their gradients, and optionally its
    ``batch_stats`` -> the port's ``Tacotron2`` ``state_dict`` (the
    reference's names), as numpy arrays: the inverse of
    ``convert_tacotron2``. The encoder's forward and backward LSTM cells
    (flax's ``OptimizedLSTMCell_0`` and ``_1``) become ``encoder.lstm``'s
    ``_l0`` and ``_l0_reverse``; ``memory_layer`` moves under
    ``decoder.attention_layer``."""
    enc, cell, post = params["encoder"], params["cell"], params["postnet"]
    stats = batch_stats or {"encoder": None, "postnet": None}
    sd = {"embedding.weight": np.asarray(enc["embedding"]["embedding"])}
    for i in range(sum(k.startswith("conv") for k in enc)):
        sd.update(_conv_bn(enc, stats["encoder"], i, "encoder.convolutions"))
    sd.update(_lstm_cell(enc["OptimizedLSTMCell_0"], "encoder.lstm", "_l0"))
    sd.update(_lstm_cell(enc["OptimizedLSTMCell_1"], "encoder.lstm",
                         "_l0_reverse"))
    att = "decoder.attention_layer"
    dense = {f"{att}.memory_layer": params["memory_layer"],
             "decoder.prenet.layers.0": cell["prenet"]["fc0"],
             "decoder.prenet.layers.1": cell["prenet"]["fc1"],
             f"{att}.location_layer.location_dense": cell["location_dense"],
             f"{att}.query_layer": cell["query_layer"],
             f"{att}.v": cell["v"],
             "decoder.linear_projection": cell["linear_projection"],
             "decoder.gate_layer": cell["gate_layer"]}
    for dst, tree in dense.items():
        sd[f"{dst}.linear_layer.weight"] = _t(tree["kernel"])
        if "bias" in tree:
            sd[f"{dst}.linear_layer.bias"] = np.asarray(tree["bias"])
    sd[f"{att}.location_layer.location_conv.conv.weight"] = _conv1d(
        cell["location_conv"]["kernel"])
    sd.update(_lstm_cell(cell["attention_rnn"], "decoder.attention_rnn"))
    sd.update(_lstm_cell(cell["decoder_rnn"], "decoder.decoder_rnn"))
    for i in range(sum(k.startswith("conv") for k in post)):
        sd.update(_conv_bn(post, stats["postnet"], i, "postnet.convolutions"))
    return sd


def waveglow_state_dict_from_jax(params: Mapping[str, Any]
                                 ) -> dict[str, np.ndarray]:
    """JAX ``WaveGlow`` params, or their gradients -> the port's
    ``WaveGlow`` ``state_dict`` (the reference's names), as numpy arrays:
    the inverse of ``convert_waveglow``. Three re-layouts: the
    ``upsample`` kernel reversed in time into ``ConvTranspose1d``'s (in,
    out, k); each WN's one ``cond_layer`` split into ``cond_layers.{i}``,
    its input channels from JAX's group-major ``g * n_mel + m`` to the
    reference's mel-major ``m * n_group + g``; ``end``'s outputs from JAX's
    ``(log_s, b)`` to the reference's ``(b, log_s)``. The mel and group
    counts are read from the shapes."""
    up = np.asarray(params["upsample"]["kernel"])  # (k, in, out)
    sd = {"upsample.weight": np.ascontiguousarray(up[::-1].transpose(1, 2, 0)),
          "upsample.bias": np.asarray(params["upsample"]["bias"])}
    n_mel = up.shape[1]
    flows = sorted((int(k[len("wn_"):]) for k in params if k.startswith("wn_")))
    for k in flows:
        w = np.asarray(params[f"conv1x1_{k}"]["weight"])
        sd[f"convinv.{k}.conv.weight"] = _t(w)[..., None]
        wn, dst = params[f"wn_{k}"], f"WN.{k}"
        n_layers = sum(n.startswith("in_layer") for n in wn)
        for name, src in [("start", "start"),
                          *((f"in_layers.{i}", f"in_layer{i}")
                            for i in range(n_layers)),
                          *((f"res_skip_layers.{i}", f"res_skip{i}")
                            for i in range(n_layers))]:
            sd[f"{dst}.{name}.weight"] = _conv1d(wn[src]["kernel"])
            sd[f"{dst}.{name}.bias"] = np.asarray(wn[src]["bias"])
        cond = np.asarray(wn["cond_layer"]["kernel"])[0]  # (in, out)
        cond_b = np.asarray(wn["cond_layer"]["bias"])
        n_group = cond.shape[0] // n_mel
        perm = np.array([g * n_mel + m for m in range(n_mel)
                         for g in range(n_group)])
        width = cond.shape[1] // n_layers
        for i in range(n_layers):
            cols = slice(i * width, (i + 1) * width)
            sd[f"{dst}.cond_layers.{i}.weight"] = _t(cond[perm, cols])[..., None]
            sd[f"{dst}.cond_layers.{i}.bias"] = cond_b[cols]
        end = np.asarray(wn["end"]["kernel"])[0]  # (in, 2 * n_half)
        half = end.shape[1] // 2
        swap = np.concatenate([np.arange(half, 2 * half), np.arange(half)])
        sd[f"{dst}.end.weight"] = _t(end[:, swap])[..., None]
        sd[f"{dst}.end.bias"] = np.asarray(wn["end"]["bias"])[swap]
    return sd


def _seq2seq_layers(tree: Mapping[str, Any], side: str, dst: str,
                    attn, ln) -> dict:
    """The ``{side}_{i}`` blocks of the JAX ``Transformer`` or ``BartModel``
    (``self_attn``, ``cross_attn``, ``ln1``, ``ln_cross``, ``ff1``, ``ff2``,
    ``ln2``) -> ``{dst}.{i}.*`` under the reference's names; ``attn`` and
    ``ln`` map one attention and one LayerNorm."""
    sd: dict = {}
    n = sum(1 for k in tree if k.startswith(f"{side}_")
            and k[len(side) + 1:].isdigit())
    for i in range(n):
        src, out = tree[f"{side}_{i}"], f"{dst}.{i}"
        sd.update(attn(src["self_attn"], f"{out}.self_attn"))
        lns = {"ln1": "self_attn_layer_norm", "ln2": "final_layer_norm"}
        if "cross_attn" in src:
            sd.update(attn(src["cross_attn"], f"{out}.encoder_attn"))
            lns["ln_cross"] = "encoder_attn_layer_norm"
        for k, name in lns.items():
            sd.update(ln(src[k], f"{out}.{name}"))
        for k, name in (("ff1", "fc1"), ("ff2", "fc2")):
            sd[f"{out}.{name}.weight"] = _t(src[k]["kernel"])
            sd[f"{out}.{name}.bias"] = np.asarray(src[k]["bias"])
    return sd


def _ln(tree: Mapping[str, Any], dst: str) -> dict:
    return {f"{dst}.weight": np.asarray(tree["scale"]),
            f"{dst}.bias": np.asarray(tree["bias"])}


def transformer_state_dict_from_jax(tree: Mapping[str, Any]
                                    ) -> dict[str, np.ndarray]:
    """JAX ``Transformer`` (NMT) params, or their gradients -> the port's
    ``Transformer`` ``state_dict`` (fairseq's names), as numpy arrays: the
    inverse of ``convert_nmt_transformer``. fairseq applies
    ``in_proj_weight_{q,k,v}`` as ``x @ W``, so those kernels copy over
    untransposed; an encoder layer's LayerNorms are ``maybe_ln1.ln`` and
    ``maybe_ln2.ln``, a decoder layer's ``{name}.ln``."""

    def attn(t, dst):
        sd = {f"{dst}.in_proj_weight_{k}": np.asarray(t[k]["kernel"])
              for k in "qkv"}
        sd[f"{dst}.out_proj.weight"] = _t(t["out"]["kernel"])
        return sd

    def ln(t, dst):
        prefix, _, name = dst.rpartition(".")
        if prefix.startswith("encoder."):
            name = {"self_attn_layer_norm": "maybe_ln1",
                    "final_layer_norm": "maybe_ln2"}[name]
        return _ln(t, f"{prefix}.{name}.ln")

    sd = {"encoder.embed_tokens.weight": np.asarray(tree["embed"]["embedding"])}
    sd.update(_seq2seq_layers(tree, "enc", "encoder.layers", attn, ln))
    sd.update(_seq2seq_layers(tree, "dec", "decoder.layers", attn, ln))
    return sd


def bart_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``BartModel`` params, or their gradients -> the port's
    ``BartModel`` ``state_dict`` (HF's names under ``model.``), as numpy
    arrays: the inverse of ``convert_bart``."""

    def attn(t, dst):
        sd = {}
        for k in ("q", "k", "v", "out"):
            sd[f"{dst}.{k}_proj.weight"] = _t(t[k]["kernel"])
            sd[f"{dst}.{k}_proj.bias"] = np.asarray(t[k]["bias"])
        return sd

    sd = {"model.shared.weight": np.asarray(tree["embed"]["embedding"])}
    for side, short in (("encoder", "enc"), ("decoder", "dec")):
        sd[f"model.{side}.embed_positions.weight"] = np.asarray(
            tree[f"{short}_pos"]["embedding"])
        sd.update(_ln(tree[f"{short}_emb_ln"],
                      f"model.{side}.layernorm_embedding"))
        sd.update(_seq2seq_layers(tree, short, f"model.{side}.layers", attn,
                                  _ln))
    return sd


def gnmt_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``Gnmt`` params, or their gradients -> the port's ``Gnmt``
    ``state_dict`` (the reference's names), as numpy arrays: the inverse of
    ``convert_gnmt``. Each ``nn.RNN``'s cell becomes one direction of an
    ``nn.LSTM``-named layer (``_l0``; the bidirectional layer 0's backward
    cell ``_l0_reverse``); the attention's scalar ``g`` becomes the
    reference's 1-element ``normalize_scalar``."""
    n = 1 + sum(1 for k in tree if k.startswith("enc_") and k[4:].isdigit())
    sd = {"encoder.embedder.weight": np.asarray(tree["embed"]["embedding"])}
    sd.update(_lstm_cell(tree["enc_fwd"]["cell"], "encoder.rnn_layers.0", "_l0"))
    sd.update(_lstm_cell(tree["enc_bwd"]["cell"], "encoder.rnn_layers.0",
                         "_l0_reverse"))
    sd.update(_lstm_cell(tree["dec_l0"]["cell"], "decoder.att_rnn.rnn", "_l0"))
    for i in range(1, n):
        sd.update(_lstm_cell(tree[f"enc_{i}"]["cell"],
                             f"encoder.rnn_layers.{i}", "_l0"))
        sd.update(_lstm_cell(tree[f"dec_{i}"]["cell"],
                             f"decoder.rnn_layers.{i - 1}", "_l0"))
    att, dst = tree["attn"], "decoder.att_rnn.attn"
    sd[f"{dst}.linear_q.weight"] = _t(att["q"]["kernel"])
    sd[f"{dst}.linear_k.weight"] = _t(att["k"]["kernel"])
    sd[f"{dst}.linear_att"] = np.asarray(att["v"])
    sd[f"{dst}.normalize_scalar"] = np.asarray(att["g"]).reshape(1)
    sd[f"{dst}.normalize_bias"] = np.asarray(att["bias"])
    cls = tree["classifier"]
    sd["decoder.classifier.classifier.weight"] = _t(cls["kernel"])
    sd["decoder.classifier.classifier.bias"] = np.asarray(cls["bias"])
    return sd


def _dense_sd(tree: Mapping[str, Any], dst: str) -> dict:
    """A flax ``Dense`` (kernel, optional bias) -> ``{dst}.weight`` (out,
    in) and ``{dst}.bias``."""
    sd = {f"{dst}.weight": _t(tree["kernel"])}
    if "bias" in tree:
        sd[f"{dst}.bias"] = np.asarray(tree["bias"])
    return sd


def _conv1d_sd(tree: Mapping[str, Any], dst: str) -> dict:
    """A flax 1-D ``Conv`` -> ``{dst}.weight`` (out, in / groups, k) and
    ``{dst}.bias``."""
    sd = {f"{dst}.weight": _conv1d(tree["kernel"])}
    if "bias" in tree:
        sd[f"{dst}.bias"] = np.asarray(tree["bias"])
    return sd


def fastpitch_state_dict_from_jax(tree: Mapping[str, Any]
                                  ) -> dict[str, np.ndarray]:
    """JAX ``FastPitch`` params, or their gradients -> the port's
    ``FastPitch`` ``state_dict`` (the reference's names), as numpy arrays:
    the inverse of ``convert_fastpitch``."""
    sd = {"encoder.word_emb.weight": np.asarray(tree["embed"]["embedding"])}
    for key, src in tree.items():
        side, _, i = key.partition("_")
        if side in ("enc", "dec") and i.isdigit():
            dst = f"{'encoder' if side == 'enc' else 'decoder'}.layers.{i}"
            sd.update(_dense_sd(src["qkv"], f"{dst}.dec_attn.qkv_net"))
            sd.update(_dense_sd(src["o_net"], f"{dst}.dec_attn.o_net"))
            sd.update(_ln(src["ln1"], f"{dst}.dec_attn.layer_norm"))
            sd.update(_conv1d_sd(src["conv1"], f"{dst}.pos_ff.CoreNet.0"))
            sd.update(_conv1d_sd(src["conv2"], f"{dst}.pos_ff.CoreNet.2"))
            sd.update(_ln(src["ln2"], f"{dst}.pos_ff.layer_norm"))
        elif key.endswith("_predictor"):
            sd.update(_dense_sd(src["fc"], f"{key}.fc"))
            for name, sub in src.items():
                if name.startswith("conv"):
                    sd.update(_conv1d_sd(sub, f"{key}.layers.{name[4:]}.conv"))
                elif name.startswith("ln"):
                    sd.update(_ln(sub, f"{key}.layers.{name[2:]}.norm"))
    for key, dst in (("pitch_embed", "pitch_emb"), ("energy_embed", "energy_emb")):
        if key in tree:
            sd.update(_conv1d_sd(tree[key], dst))
    sd.update(_dense_sd(tree["mel_proj"], "proj"))
    return sd


def hifigan_generator_state_dict_from_jax(tree: Mapping[str, Any]
                                          ) -> dict[str, np.ndarray]:
    """JAX ``HiFiGanGenerator`` params, or their gradients -> the port's
    generator ``state_dict``: the inverse of ``convert_hifigan_generator``.
    An upsampling kernel (k, in, out) becomes ``ConvTranspose1d``'s (in,
    out, k) reversed in time."""
    sd = {**_conv1d_sd(tree["pre"], "conv_pre"),
          **_conv1d_sd(tree["post"], "conv_post")}
    for key, src in tree.items():
        if key.startswith("up_"):
            k = np.asarray(src["kernel"])[::-1]
            sd[f"ups.{key[3:]}.weight"] = np.ascontiguousarray(
                k.transpose(1, 2, 0))
            sd[f"ups.{key[3:]}.bias"] = np.asarray(src["bias"])
        elif key.startswith("mrf_"):
            _, i, j = key.split("_")
            for name, conv in src.items():  # c1_{m}, c2_{m}
                c, m = name.split("_")
                sd.update(_conv1d_sd(
                    conv, f"resblocks.{i}.{j}.convs{c[1]}.{m}"))
    return sd


def hifigan_discriminators_state_dict_from_jax(tree: Mapping[str, Any]
                                               ) -> dict[str, np.ndarray]:
    """JAX ``HiFiGanDiscriminators`` params, or their gradients -> the
    port's ``state_dict`` (the reference's ``mpd.discriminators.{k}`` and
    ``msd.discriminators.{k}``, ``convs.{i}`` and ``conv_post``). The period
    discriminators are taken in ascending period, as the configuration
    lists them."""

    def disc(src, dst, conv):
        sd = {}
        for name, sub in src.items():
            out = f"{dst}.conv_post" if name == "out" else f"{dst}.convs.{name[1:]}"
            sd[f"{out}.weight"] = conv(sub["kernel"])
            sd[f"{out}.bias"] = np.asarray(sub["bias"])
        return sd

    def conv2d(k):  # (kh, kw, in, out) -> (out, in, kh, kw)
        return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))

    sd: dict[str, np.ndarray] = {}
    periods = sorted((int(k[4:]) for k in tree if k.startswith("mpd_")))
    for n, p in enumerate(periods):
        sd.update(disc(tree[f"mpd_{p}"], f"mpd.discriminators.{n}", conv2d))
    scales = sorted(int(k[4:]) for k in tree if k.startswith("msd_"))
    for i in scales:
        sd.update(disc(tree[f"msd_{i}"], f"msd.discriminators.{i}", _conv1d))
    return sd


def wav2vec2_state_dict_from_jax(tree: Mapping[str, Any]
                                 ) -> dict[str, np.ndarray]:
    """JAX ``Wav2Vec2`` params, or their gradients -> the port's
    ``Wav2Vec2`` ``state_dict`` (the reference's names): the inverse of
    ``convert_wav2vec2``. A ``Wav2Vec2ForCTC`` tree (``w2v`` and ``head``)
    gives ``w2v.*`` and ``head.*``. The fused qkv splits into
    ``q_proj``, ``k_proj`` and ``v_proj``."""
    if "w2v" in tree:
        sd = {f"w2v.{k}": v for k, v in
              wav2vec2_state_dict_from_jax(tree["w2v"]).items()}
        sd.update(_dense_sd(tree["head"], "head"))
        return sd
    sd: dict[str, np.ndarray] = {}
    for name, sub in tree["encoder"].items():
        dst = "feature_extractor.conv_layers"
        if name.startswith("conv"):
            sd[f"{dst}.{name[4:]}.0.weight"] = _conv1d(sub["kernel"])
        elif name == "gn0":
            sd.update(_ln(sub, f"{dst}.0.2"))
        else:  # ln{i}
            sd.update(_ln(sub, f"{dst}.{name[2:]}.2.1"))
    sd.update(_ln(tree["feat_ln"], "layer_norm"))
    sd.update(_dense_sd(tree["feat_proj"], "post_extract_proj"))
    sd["mask_emb"] = np.asarray(tree["mask_embedding"])
    sd.update(_conv1d_sd(tree["pos_conv"], "encoder.pos_conv.0"))
    sd.update(_ln(tree["encoder_ln"], "encoder.layer_norm"))
    for key in ("final_proj", "project_q"):
        if key in tree:
            sd.update(_dense_sd(tree[key], key))
    if "quantizer" in tree:
        sd.update(_dense_sd(tree["quantizer"]["proj"], "quantizer.weight_proj"))
        cv = np.asarray(tree["quantizer"]["codevectors"])
        sd["quantizer.vars"] = cv.reshape(1, -1, cv.shape[-1])
    for key, src in tree.items():
        if not key.startswith("block_"):
            continue
        dst = f"encoder.layers.{key[6:]}"
        w = np.asarray(src["qkv"]["kernel"])
        b = np.asarray(src["qkv"]["bias"])
        d = w.shape[1] // 3
        for n, name in enumerate("qkv"):
            sd[f"{dst}.self_attn.{name}_proj.weight"] = _t(w[:, n * d:(n + 1) * d])
            sd[f"{dst}.self_attn.{name}_proj.bias"] = b[n * d:(n + 1) * d].copy()
        sd.update(_dense_sd(src["attn_out"], f"{dst}.self_attn.out_proj"))
        sd.update(_ln(src["ln1"], f"{dst}.self_attn_layer_norm"))
        sd.update(_ln(src["ln2"], f"{dst}.final_layer_norm"))
        sd.update(_dense_sd(src["ff1"], f"{dst}.fc1"))
        sd.update(_dense_sd(src["ff2"], f"{dst}.fc2"))
    return sd


def jasper_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] | None = None
                               ) -> dict[str, np.ndarray]:
    """JAX ``Jasper`` params (or their gradients) and ``batch_stats`` -> the
    port's ``Jasper`` ``state_dict`` (the reference's names): the inverse of
    ``convert_jasper``, and of its separable layout for QuartzNet (``dw``,
    ``pw`` and ``bn`` at ``conv.{5r}`` .. ``conv.{5r + 2}``)."""

    def bn(p, s, dst):
        sd = {f"{dst}.weight": np.asarray(p["scale"]),
              f"{dst}.bias": np.asarray(p["bias"])}
        if s is not None:
            sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
            sd[f"{dst}.running_var"] = np.asarray(s["var"])
        return sd

    sd = _conv1d_sd(params["head"], "decoder.layers.0")
    for key, src in params.items():
        if key == "head":
            continue
        b, _, r = key[1:].partition("_")
        stats = None if batch_stats is None else batch_stats[key]["bn"]
        dst = f"encoder.layers.{b}"
        if r.startswith("res"):
            sd[f"{dst}.res.{r[3:]}.0.weight"] = _conv1d(src["conv"]["kernel"])
            sd.update(bn(src["bn"], stats, f"{dst}.res.{r[3:]}.1"))
        elif "dw" in src:
            first = 5 * int(r)
            sd[f"{dst}.conv.{first}.weight"] = _conv1d(src["dw"]["kernel"])
            sd[f"{dst}.conv.{first + 1}.weight"] = _conv1d(src["pw"]["kernel"])
            sd.update(bn(src["bn"], stats, f"{dst}.conv.{first + 2}"))
        else:
            first = 4 * int(r)
            sd[f"{dst}.conv.{first}.weight"] = _conv1d(src["conv"]["kernel"])
            sd.update(bn(src["bn"], stats, f"{dst}.conv.{first + 1}"))
    return sd


def ncf_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``NeuMF`` params, or their gradients -> the port's ``NeuMF``
    ``state_dict`` (the reference's names): the inverse of ``convert_ncf``."""
    sd = {f"{name}_embed.weight": np.asarray(tree[name]["embedding"])
          for name in ("mf_user", "mf_item", "mlp_user", "mlp_item")}
    for i in range(sum(k.startswith("mlp_") and k[4:].isdigit() for k in tree)):
        sd.update(_dense_sd(tree[f"mlp_{i}"], f"mlp.{i}"))
    sd.update(_dense_sd(tree["final"], "final"))
    return sd


def _tft_grn(tree: Mapping[str, Any], dst: str) -> dict:
    sd: dict = {}
    for name in ("lin_a", "lin_c", "lin_i", "out_proj"):
        if name in tree:
            sd.update(_dense_sd(tree[name], f"{dst}.{name}"))
    sd.update(_dense_sd(tree["glu"]["lin"], f"{dst}.glu.lin"))
    if "ln" in tree:
        sd.update(_ln(tree["ln"], f"{dst}.layer_norm.ln"))
    return sd


def _tft_vsn(tree: Mapping[str, Any], dst: str) -> dict:
    sd = _tft_grn(tree["joint_grn"], f"{dst}.joint_grn")
    for key, src in tree.items():
        if key.startswith("var_grn_"):
            sd.update(_tft_grn(src, f"{dst}.var_grns.{key[len('var_grn_'):]}"))
    return sd


def tft_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``TFT`` params, or their gradients -> the port's ``TFT``
    ``state_dict`` (the reference's names): the inverse of ``convert_tft``.
    The two ``OptimizedLSTMCell``s become ``nn.LSTM`` layers (``_l0``, flax's
    bias in ``bias_hh_l0``)."""
    emb = tree["embedding"]
    sd = {}
    for src, dst in (("k_cont", "t_cont_k"), ("o_cont", "t_cont_o"),
                     ("target", "t_tgt")):
        if f"{src}_vectors" in emb:
            sd[f"embedding.{dst}_embedding_vectors"] = np.asarray(
                emb[f"{src}_vectors"])
            sd[f"embedding.{dst}_embedding_bias"] = np.asarray(
                emb[f"{src}_bias"])
    for key, src in emb.items():
        if key.startswith("s_cat_"):
            sd[f"embedding.s_cat_embed.{key[len('s_cat_'):]}.weight"] = \
                np.asarray(src["embedding"])
    static = tree["static_encoder"]
    sd.update(_tft_vsn(static["vsn"], "static_encoder.vsn"))
    for i in range(4):
        sd.update(_tft_grn(static[f"context_grn_{i}"],
                           f"static_encoder.context_grns.{i}"))
    p2 = "TFTpart2"
    for name in ("history_vsn", "future_vsn"):
        sd.update(_tft_vsn(tree[name], f"{p2}.{name}"))
    for name in ("history_encoder", "future_encoder"):
        sd.update(_lstm_cell(tree[name], f"{p2}.{name}", "_l0"))
    for name in ("input_gate", "attention_gate", "decoder_gate"):
        sd.update(_dense_sd(tree[name]["lin"], f"{p2}.{name}.lin"))
    for name in ("input_gate_ln", "attention_ln", "decoder_ln"):
        sd.update(_ln(tree[name], f"{p2}.{name}"))
    for name in ("enrichment_grn", "positionwise_grn"):
        sd.update(_tft_grn(tree[name], f"{p2}.{name}"))
    att = tree["attention"]
    sd.update(_dense_sd(att["qkv"], f"{p2}.attention.qkv_linears"))
    sd.update(_dense_sd(att["out_proj"], f"{p2}.attention.out_proj"))
    sd.update(_dense_sd(tree["quantile_proj"], f"{p2}.quantile_proj"))
    return sd


def _conv_nd(kernel: Any) -> np.ndarray:
    """flax kernel (*k, in, out) -> torch (out, in, *k)."""
    k = np.asarray(kernel)
    r = k.ndim - 2
    return np.ascontiguousarray(k.transpose(r + 1, r, *range(r)))


def _conv_nd_sd(tree: Mapping[str, Any], dst: str) -> dict:
    sd = {f"{dst}.weight": _conv_nd(tree["kernel"])}
    if "bias" in tree:
        sd[f"{dst}.bias"] = np.asarray(tree["bias"])
    return sd


def dynunet_state_dict_from_jax(tree: Mapping[str, Any]
                                ) -> dict[str, np.ndarray]:
    """JAX ``DynUNet`` params, or their gradients -> the port's ``DynUNet``
    ``state_dict`` (JAX's names; no reference converter exists). An
    ``up_{d}`` kernel (*k, in, out) becomes ``ConvTranspose``'s (in, out,
    *k) reversed in space (flax's transposed convolution does not flip
    it)."""
    sd: dict = {}
    for key, src in tree.items():
        if key.startswith("up_"):
            k = np.asarray(src["kernel"])
            r = k.ndim - 2
            k = k[(slice(None, None, -1),) * r].transpose(r, r + 1, *range(r))
            sd[f"{key}.weight"] = np.ascontiguousarray(k)
            sd[f"{key}.bias"] = np.asarray(src["bias"])
        elif "kernel" in src:  # the heads
            sd.update(_conv_nd_sd(src, key))
        else:  # a ConvBlock
            for name, leaf in src.items():
                if name.startswith("conv"):
                    sd.update(_conv_nd_sd(leaf, f"{key}.{name}"))
                else:
                    sd[f"{key}.{name}"] = np.asarray(leaf)
    return sd


def brats_unet3d_state_dict_from_jax(tree: Mapping[str, Any]
                                     ) -> dict[str, np.ndarray]:
    """JAX ``BratsUNet3D`` params, or their gradients -> the port's
    ``BratsUNet3D`` ``state_dict`` (the reference's names): the inverse of
    ``convert_brats_unet3d``."""

    def layer(t, dst):
        return {**_conv_nd_sd(t["conv"], f"{dst}.conv"),
                f"{dst}.norm.weight": np.asarray(t["in_scale"]),
                f"{dst}.norm.bias": np.asarray(t["in_bias"])}

    def block(t, dst):
        return {**layer(t["conv1"], f"{dst}.conv1"),
                **layer(t["conv2"], f"{dst}.conv2")}

    sd = {**_conv_nd_sd(tree["in_conv1"], "input_block.conv1"),
          **_conv_nd_sd(tree["in_conv2"], "input_block.conv2"),
          "input_block.norm.weight": np.asarray(tree["in_scale"]),
          "input_block.norm.bias": np.asarray(tree["in_bias"]),
          **_conv_nd_sd(tree["out_conv"], "output_block.conv"),
          **block(tree["bottleneck"], "bottleneck")}
    for key, src in tree.items():
        kind, _, i = key.partition("_")
        if kind == "down":
            sd.update(block(src, f"downsamples.{i}"))
        elif kind == "up":
            sd.update(block(src, f"upsamples.{i}.conv_block"))
        elif kind == "ds":
            sd.update(_conv_nd_sd(src, f"deep_supervision_heads.{i}.conv"))
    return sd


def transformer_xl_state_dict_from_jax(tree: Mapping[str, Any]
                                       ) -> dict[str, np.ndarray]:
    """JAX ``TransformerXL`` params, or their gradients -> the port's
    ``TransformerXL`` ``state_dict`` (the reference's names, the table and
    the softmax bias with their ``padded_vocab`` rows): the inverse of
    ``convert_transformer_xl``. The q, k and v kernels stack into
    ``qkv_net``."""
    sd = {"word_emb.emb_layers.0.weight": np.asarray(tree["embed"]["embedding"]),
          "r_w_bias": np.asarray(tree["r_w_bias"]),
          "r_r_bias": np.asarray(tree["r_r_bias"]),
          "crit.out_layers_biases.0": np.asarray(tree["softmax_bias"])}
    for key, src in tree.items():
        if not key.startswith("layer_"):
            continue
        dst, att = f"layers.{key[len('layer_'):]}", src["attn"]
        sd[f"{dst}.dec_attn.qkv_net.weight"] = np.concatenate(
            [_t(att[k]["kernel"]) for k in "qkv"])
        sd[f"{dst}.dec_attn.r_net.weight"] = _t(att["r"]["kernel"])
        sd[f"{dst}.dec_attn.o_net.weight"] = _t(att["o"]["kernel"])
        sd.update(_ln(src["ln1"], f"{dst}.dec_attn.layer_norm"))
        sd.update(_dense_sd(src["ff1"], f"{dst}.pos_ff.CoreNet.0"))
        sd.update(_dense_sd(src["ff2"], f"{dst}.pos_ff.CoreNet.3"))
        sd.update(_ln(src["ln2"], f"{dst}.pos_ff.layer_norm"))
    return sd


def moflow_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] | None = None
                               ) -> dict[str, np.ndarray]:
    """JAX ``MoFlow`` params (with ``ln_var``), or their gradients, and
    optionally its ``batch_stats`` -> the port's ``MoFlow`` ``state_dict``
    (the reference's names): the inverse of ``convert_moflow``. An ActNorm's
    (C,) ``loc`` and ``scale`` become (1, C, 1, 1) for the bonds and (1, N,
    1) for the atoms."""

    def bn(p, s, dst):
        sd = _ln(p, dst)
        if s is not None:
            sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
            sd[f"{dst}.running_var"] = np.asarray(s["var"])
        return sd

    def actnorm(t, dst, shape):
        return {f"{dst}.actnorm.{k}": np.asarray(t[k]).reshape(shape)
                for k in ("loc", "scale")}

    sd: dict = {}
    if "ln_var" in params:
        sd["ln_var"] = np.asarray(params["ln_var"])
    for side, dst_side in (("bond_glow", "bond_model"),
                           ("atom_flow", "atom_model")):
        tree = params[side]
        stats = (batch_stats or {}).get(side, {})
        n = sum(k.startswith("actnorm") for k in tree)
        for i in range(n):
            dst = f"{dst_side}.blocks.0.flows.{i}"
            cp, st = tree[f"coupling{i}"], stats.get(f"coupling{i}", {}).get
            if side == "bond_glow":
                sd.update(actnorm(tree[f"actnorm{i}"], dst, (1, -1, 1, 1)))
                hidden = sum(k.startswith("conv") for k in cp)
                for j in range(hidden):
                    sd.update(_conv_nd_sd(cp[f"conv{j}"],
                                          f"{dst}.coupling.layers.{3 * j}"))
                    sd.update(bn(cp[f"bn{j}"], st(f"bn{j}"),
                                 f"{dst}.coupling.layers.{3 * j + 1}"))
                sd.update(_conv_nd_sd(cp["out"],
                                      f"{dst}.coupling.layers.{3 * hidden}"))
                continue
            sd.update(actnorm(tree[f"actnorm{i}"], dst, (1, -1, 1)))
            for k in range(sum(key.startswith("gnn_bn") for key in cp)):
                g = f"{dst}.coupling.net_conv.{k}"
                sd.update(_dense_sd(cp[f"gnn{k}"]["self"],
                                    f"{g}.graph_conv.graph_linear_self"))
                sd.update(_dense_sd(cp[f"gnn{k}"]["edge"],
                                    f"{g}.graph_conv.graph_linear_edge"))
                sd.update(bn(cp[f"gnn_bn{k}"], st(f"gnn_bn{k}"), f"{g}.bn"))
            n_lin = sum(key.startswith("lin_bn") for key in cp)
            for k in range(n_lin):
                li = f"{dst}.coupling.net_lin.{k}"
                sd.update(_dense_sd(cp[f"lin{k}"], f"{li}.lin"))
                sd.update(bn(cp[f"lin_bn{k}"], st(f"lin_bn{k}"), f"{li}.bn"))
            sd.update(_dense_sd(cp["out"], f"{dst}.coupling.net_lin.{n_lin}"))
    return sd


def maskrcnn_state_dict_from_jax(params: Mapping[str, Any],
                                 batch_stats: Mapping[str, Any] | None = None,
                                 pool: int = 7) -> dict[str, np.ndarray]:
    """JAX ``MaskRCNN`` params, or their gradients, and optionally its
    ``batch_stats`` -> the port's ``MaskRCNN`` ``state_dict``: the backbone
    under ``backbone.`` with the ResNet's names, the heads under the
    reference's (the inverse of ``convert_maskrcnn_heads``): ``fc6`` reads
    its input channel-major, ``conv5_mask`` is a ``ConvTranspose2d``
    weight (in, out, 2, 2), JAX's kernel reversed in space."""
    stats = (batch_stats or {}).get("backbone")
    sd = {f"backbone.{k}": v for k, v in
          resnet_state_dict_from_jax(params["backbone"], stats).items()}

    def put(dst: str, tree: Mapping[str, Any]) -> None:
        sd[f"{dst}.weight"] = _leaf(tree["kernel"])
        sd[f"{dst}.bias"] = np.asarray(tree["bias"])

    fpn, rpn = params["fpn"], params["rpn_head"]
    box, mask = params["box_head"], params["mask_head"]
    for i in range(4):
        put(f"fpn.fpn_inner{i + 1}", fpn[f"lateral_{i}"])
        put(f"fpn.fpn_layer{i + 1}", fpn[f"out_{i}"])
        put(f"mask_ext.mask_fcn{i + 1}", mask[f"fcn{i}"])
    for src, dst in (("conv", "conv"), ("logits", "cls_logits"),
                     ("deltas", "bbox_pred")):
        put(f"rpn.{dst}", rpn[src])
    w6 = np.asarray(box["fc6"]["kernel"])  # (pool * pool * C, fc), NHWC-major
    c = w6.shape[0] // (pool * pool)
    sd["box_ext.fc6.weight"] = np.ascontiguousarray(
        w6.reshape(pool, pool, c, -1).transpose(3, 2, 0, 1).reshape(
            w6.shape[1], -1))
    sd["box_ext.fc6.bias"] = np.asarray(box["fc6"]["bias"])
    for src, dst in (("fc7", "box_ext.fc7"), ("cls", "box_pred.cls_score"),
                     ("box", "box_pred.bbox_pred")):
        put(dst, box[src])
    kt = np.asarray(mask["deconv"]["kernel"])  # (2, 2, in, out)
    sd["mask_pred.conv5_mask.weight"] = np.ascontiguousarray(
        kt[::-1, ::-1].transpose(2, 3, 0, 1))
    sd["mask_pred.conv5_mask.bias"] = np.asarray(mask["deconv"]["bias"])
    put("mask_pred.mask_fcn_logits", mask["predict"])
    return sd


def se3_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``SE3Transformer`` or ``SE3Trunk`` params, or their gradients ->
    the port's ``state_dict``: JAX's module names, dense kernels transposed,
    LayerNorm scales as weights, ``LinearSE3``'s ``w{d}`` (c_out, c_in) as
    they are."""
    sd: dict[str, np.ndarray] = {}

    def walk(t: Mapping[str, Any], prefix: str) -> None:
        for key, value in t.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            elif key in _LEAF:
                sd[f"{prefix}{_LEAF[key]}"] = _leaf(value)
            else:  # w{d}
                sd[f"{prefix}{key}"] = np.asarray(value)

    walk(tree, "")
    return sd


def moe_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX ``MoEFeedForward`` params, or their gradients (``router/kernel``
    (d, E), ``wi`` (E, d, f), ``wo`` (E, f, d)) -> the port's
    ``MoEFeedForward`` ``state_dict``: the router's kernel transposed, the
    experts as they are (all E; ``parallel.mesh.shard_rows_of`` takes a
    rank's block)."""
    return {"router.weight": np.ascontiguousarray(
                np.asarray(tree["router"]["kernel"]).T),
            "wi": np.asarray(tree["wi"]), "wo": np.asarray(tree["wo"])}


def stacked_stages_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX's stacked stage tree (``stack_stage_params``: leaves with a
    leading stage axis), or its gradients -> the dict
    ``parallel.pipeline.pipeline_apply`` takes: each leaf under its path
    joined by dots, the stage axis kept."""
    out: dict[str, np.ndarray] = {}

    def walk(t: Mapping[str, Any], prefix: str) -> None:
        for key, value in t.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = np.asarray(value)

    walk(tree, "")
    return out
