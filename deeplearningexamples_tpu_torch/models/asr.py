"""Jasper and QuartzNet: CTC speech recognition from stacked 1-D
convolutions, in PyTorch.

Port of ``deeplearningexamples_tpu/models/asr.py`` (reference
``PyTorch/SpeechRecognition/{Jasper,QuartzNet}``), with the reference's
``state_dict`` names, which ``utils/torch_import.convert_jasper`` in the JAX
package reads: block ``b`` is ``encoder.layers.{b}``, its repeat ``r``'s
convolution ``conv.{4r}`` and BN ``conv.{4r + 1}`` (the reference's list
interleaves an activation and a dropout, which hold no parameters; a
separable repeat's depthwise, pointwise and BN are ``conv.{5r}``,
``conv.{5r + 1}``, ``conv.{5r + 2}``), the residual panes ``res.{p}.0``
(1x1 conv) and ``res.{p}.1`` (BN), the head ``decoder.layers.0``.

- Convolutions run NCW without bias, padded ``(k // 2) * dilation`` on both
  sides (the reference's ``get_same_padding``; flax's ``"SAME"`` would pad
  asymmetrically under stride 2); a separable convolution is a depthwise
  then a pointwise one.
- BN has epsilon 1e-3 and flax's momentum 0.9 with the biased running
  variance (``tts.layers.BatchNorm1d``).
- ReLU and dropout run between a block's repeats and after its residual
  sum, not after its last convolution; a ``dense`` block sums one residual
  pane per earlier dense block's output and the stem input.
- The head is an fp32 1x1 convolution; the output is log-probabilities (B,
  T', vocab).

Dropout is ``ops.dropout.RegenDropout`` (its bits cannot match
``jax.random``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.losses import ctc_loss
from ..ops.dropout import RegenDropout
from .tts.layers import BatchNorm1d, Conv1d, acc_dtype

__all__ = ["JASPER_10x5DR", "Jasper", "JasperBlock",
           "JasperConfig", "JasperTask", "QUARTZNET_15x5",
           "conv_bn_layers", "greedy_ctc_decode"]

BN_EPS = 1e-3


@dataclass(frozen=True)
class JasperBlock:
    repeats: int
    channels: int
    kernel: int
    dropout: float = 0.2
    residual: bool = True
    separable: bool = False
    stride: int = 1
    dilation: int = 1
    # the reference's residual_dense: residual convs from the outputs of
    # every earlier dense block and the stem input
    dense: bool = False


@dataclass(frozen=True)
class JasperConfig:
    """Jasper 5x3 by default, as JAX's."""

    n_mels: int = 64
    vocab_size: int = 29  # blank + a-z + space + apostrophe
    blocks: tuple[JasperBlock, ...] = (
        JasperBlock(1, 256, 11, 0.2, residual=False, stride=2),
        JasperBlock(3, 256, 11),
        JasperBlock(3, 384, 13),
        JasperBlock(3, 512, 17),
        JasperBlock(3, 640, 21, 0.3),
        JasperBlock(3, 768, 25, 0.3),
        JasperBlock(1, 896, 29, 0.4, residual=False, dilation=2),
        JasperBlock(1, 1024, 1, 0.4, residual=False),
    )


def conv_bn_layers(cin: int, ch: int, kernel: int, stride: int,
                   dilation: int, separable: bool,
                   dtype: torch.dtype) -> list[nn.Module]:
    """JAX's ``ConvBnRelu`` (whose ReLU is its caller's): the convolution,
    or the depthwise and pointwise ones, then BN."""
    pad = (kernel // 2) * dilation
    if separable:
        convs = [Conv1d(cin, cin, kernel, stride, pad, dilation, groups=cin,
                        bias=False, dtype=dtype),
                 Conv1d(cin, ch, 1, bias=False, dtype=dtype)]
    else:
        convs = [Conv1d(cin, ch, kernel, stride, pad, dilation, bias=False,
                        dtype=dtype)]
    return convs + [BatchNorm1d(ch, eps=BN_EPS)]


class _Block(nn.Module):
    """One ``JasperBlock``: the repeats' layers in ``conv`` under the
    reference's indices, the residual panes' in ``res``."""

    def __init__(self, blk: JasperBlock, cin: int, pane_chs: list[int],
                 dtype: torch.dtype):
        super().__init__()
        self.blk = blk
        self.conv = nn.ModuleDict()
        step = 5 if blk.separable else 4
        self.repeats = []
        for r in range(blk.repeats):
            layers = conv_bn_layers(cin if r == 0 else blk.channels,
                                    blk.channels, blk.kernel, blk.stride,
                                    blk.dilation, blk.separable, dtype)
            names = [str(step * r + i) for i in range(len(layers))]
            self.conv.update(zip(names, layers))
            self.repeats.append(names)
        self.res = nn.ModuleList(
            nn.Sequential(*conv_bn_layers(c, blk.channels, 1, 1, 1, False,
                                          dtype))
            for c in pane_chs)
        self.drop = RegenDropout(blk.dropout)

    def forward(self, x, panes, generator=None):
        for r, names in enumerate(self.repeats):
            for n in names:
                x = self.conv[n](x)
            if r < len(self.repeats) - 1:
                x = self.drop(torch.relu(x), generator)
        for res, pane in zip(self.res, panes):
            x = x + res(pane)
        return self.drop(torch.relu(x), generator)


class Jasper(nn.Module):
    """feats (B, T, n_mels) -> log-probabilities (B, T', vocab) fp32. In
    training mode BN normalises with the batch statistics and updates the
    running ones; ``generator`` runs dropout."""

    def __init__(self, cfg: JasperConfig = JasperConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.encoder = nn.Module()
        layers, panes = [], [cfg.n_mels]
        for blk in cfg.blocks:
            use = (panes if blk.dense else panes[:1]) if blk.residual else []
            layers.append(_Block(blk, panes[-1], use, dtype))
            panes = panes + [blk.channels] if (blk.residual and blk.dense) \
                else [blk.channels]
        self.encoder.layers = nn.ModuleList(layers)
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(
            [Conv1d(panes[-1], cfg.vocab_size, 1, dtype=acc_dtype(dtype))])

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero bias, unit BN."""
        for m in self.modules():
            if isinstance(m, (Conv1d, BatchNorm1d)):
                m.init_(generator)

    def forward(self, feats, generator: torch.Generator | None = None):
        xs = [feats.to(self.dtype).transpose(1, 2)]  # the panes
        for layer in self.encoder.layers:
            blk = layer.blk
            panes = (xs if blk.dense else xs[:1]) if blk.residual else []
            out = layer(xs[-1], panes, generator)
            xs = xs + [out] if (blk.residual and blk.dense) else [out]
        head = self.decoder.layers[0]
        logits = head(xs[-1].to(head.dtype)).transpose(1, 2)
        return F.log_softmax(logits, -1)


def greedy_ctc_decode(log_probs: np.ndarray, blank: int = 0) -> list[list[int]]:
    """Collapse repeats and drop blanks of each row's argmax (numpy)."""
    out = []
    for seq in np.argmax(np.asarray(log_probs), axis=-1):
        toks, prev = [], -1
        for t in seq:
            if t != prev and t != blank:
                toks.append(int(t))
            prev = t
        out.append(toks)
    return out


@dataclass
class JasperTask:
    """A batch holds ``feats`` (B, T, n_mels) fp32, ``feat_paddings`` (B,
    T), ``labels`` (B, L) int32 and ``label_paddings`` (B, L), paddings 1 at
    the pads."""

    cfg: JasperConfig = JasperConfig()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Jasper:
        model = Jasper(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
        """The BN running statistics, by their ``state_dict`` names."""
        return {n: b for n, b in model.named_buffers() if ".running_" in n}

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """The mean CTC loss; block 0's stride 2 halves the frame paddings."""
        logp = model(batch["feats"], generator)
        pad = batch["feat_paddings"][:, ::2][:, :logp.shape[1]]
        loss = ctc_loss(logp, pad, batch["labels"],
                        batch["label_paddings"]).mean()
        return loss, (model_state, {})


# Jasper 10x5 dense-residual (the reference's jasper10x5dr config)
JASPER_10x5DR = JasperConfig(
    blocks=(
        JasperBlock(1, 256, 11, 0.2, residual=False, stride=2),
        *[JasperBlock(5, 256, 11, 0.2, dense=True) for _ in range(2)],
        *[JasperBlock(5, 384, 13, 0.2, dense=True) for _ in range(2)],
        *[JasperBlock(5, 512, 17, 0.2, dense=True) for _ in range(2)],
        *[JasperBlock(5, 640, 21, 0.3, dense=True) for _ in range(2)],
        *[JasperBlock(5, 768, 25, 0.3, dense=True) for _ in range(2)],
        JasperBlock(1, 896, 29, 0.4, residual=False, dilation=2),
        JasperBlock(1, 1024, 1, 0.4, residual=False),
    ),
)


# QuartzNet-15x5 (the reference's quartznet15x5 config): time-separable
# convolutions
QUARTZNET_15x5 = JasperConfig(
    blocks=(
        JasperBlock(1, 256, 33, 0.0, residual=False, separable=True, stride=2),
        *[JasperBlock(5, 256, 33, 0.0, separable=True) for _ in range(3)],
        *[JasperBlock(5, 256, 39, 0.0, separable=True) for _ in range(3)],
        *[JasperBlock(5, 512, 51, 0.0, separable=True) for _ in range(3)],
        *[JasperBlock(5, 512, 63, 0.0, separable=True) for _ in range(3)],
        *[JasperBlock(5, 512, 75, 0.0, separable=True) for _ in range(3)],
        JasperBlock(1, 512, 87, 0.0, residual=False, separable=True,
                    dilation=2),
        JasperBlock(1, 1024, 1, 0.0, residual=False),
    ),
)
