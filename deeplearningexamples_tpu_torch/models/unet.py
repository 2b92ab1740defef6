"""nnU-Net's dynamic U-Net and the BraTS UNet3D for medical segmentation,
in PyTorch.

Port of ``deeplearningexamples_tpu/models/unet.py`` (reference
``PyTorch/Segmentation/nnUNet``). Tensors are NCHW (2-D) or NCDHW (3-D);
the logits come out channels-first, (B, n_classes, *spatial), and the
losses read the classes on dim 1.

``DynUNet`` keeps the JAX module's names (``input_block``, ``down_{d}``,
``up_{d}``, ``dec_{d}``, ``ds_head_{d}``, ``head``; a block's ``conv{i}``,
``in_scale{i}``, ``in_bias{i}``), for which no reference checkpoint exists.
``BratsUNet3D`` keeps the reference's ``brats22_model.py`` names, which
``utils/torch_import.convert_brats_unet3d`` in the JAX package reads.

- flax's ``"SAME"`` padding: a stride-2 3x3 convolution of an even input
  pads (0, 1), where ``padding=1`` would pad (1, 1); the pads are explicit.
- flax's ``ConvTranspose`` does not flip its kernel: the port's
  ``ConvTranspose{2,3}d`` holds JAX's kernel reversed in space (the bridge
  reverses it).
- An instance norm takes the mean in the compute dtype and the variance in
  fp32 (in a float64 model too), as JAX's does.
- BraTS's upsampling is linear with ``align_corners=True``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .tts.layers import acc_dtype, lecun_normal_, same_pads

__all__ = ["BratsUNet3D", "ConvBlock", "DynUNet", "UNetConfig", "UNetTask",
           "dice_loss", "focal_loss"]


@dataclass(frozen=True)
class UNetConfig:
    """The JAX ``UNetConfig``."""

    spatial_rank: int = 2  # 2: (B, C, H, W) images, 3: (B, C, D, H, W)
    in_channels: int = 1
    n_classes: int = 3
    base_filters: int = 32
    depth: int = 4  # downsamplings
    max_filters: int = 320
    deep_supervision: bool = False


def dice_loss(logits, labels, eps: float = 1e-5) -> torch.Tensor:
    """Soft dice over the classes (reference ``nnunet/loss.py``): logits
    (B, C, *S), labels (B, *S) int."""
    c = logits.shape[1]
    p = torch.softmax(logits.to(acc_dtype(logits.dtype)), 1)
    y = F.one_hot(labels.long(), c).movedim(-1, 1).to(p.dtype)
    axes = tuple(range(2, p.dim()))
    inter = (p * y).sum(axes)
    denom = p.sum(axes) + y.sum(axes)
    return 1.0 - ((2 * inter + eps) / (denom + eps)).mean()


def focal_loss(logits, labels, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Multi-class focal loss: logits (B, C, *S), labels (B, *S) int."""
    logp = torch.log_softmax(logits.to(acc_dtype(logits.dtype)), 1)
    ce = -logp.gather(1, labels.long()[:, None])[:, 0]
    pt = torch.exp(-ce)
    return (alpha * (1.0 - pt) ** gamma * ce).mean()


def _conv(x, w, bias, stride: int, pads: list[tuple[int, int]]):
    """A 2-D or 3-D convolution with per-axis (left, right) zero pads."""
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    if all(lo == hi for lo, hi in pads):  # the convolution pads itself
        return conv(x, w, bias, stride, [lo for lo, _ in pads])
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    return conv(x, w, bias, stride)


class _Conv(nn.Module):
    """flax ``nn.Conv`` over (B, C, *S): an fp32 (out, in, *k) weight cast
    to ``dtype``; ``pad`` ``"SAME"`` (flax's, from the input's size) or an
    int for both sides of every axis."""

    def __init__(self, cin: int, cout: int, k: int, rank: int,
                 stride: int = 1, pad: str | int = "SAME", bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.stride, self.pad, self.dtype = k, stride, pad, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *(k,) * rank))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        pads = ([same_pads(n, self.k, self.stride) for n in x.shape[2:]]
                if self.pad == "SAME" else [(self.pad, self.pad)] * (x.dim() - 2))
        b = None if self.bias is None else self.bias.to(self.dtype)
        return _conv(x.to(self.dtype), self.weight.to(self.dtype), b,
                     self.stride, pads)

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()


def _instance_norm(x, scale, bias, eps: float = 1e-5):
    """Per sample and channel over the spatial axes: the mean in x's dtype,
    the variance in fp32 (whatever x's dtype, as JAX's)."""
    axes = tuple(range(2, x.dim()))
    view = (1, -1) + (1,) * len(axes)
    mu = x.mean(axes, keepdim=True)
    var = x.float().var(axes, unbiased=False, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps).to(x.dtype)
            * scale.to(x.dtype).view(view) + bias.to(x.dtype).view(view))


class ConvBlock(nn.Module):
    """Two 3x3 convolutions without bias (the first at ``stride``), each
    followed by an affine instance norm and a leaky ReLU (0.01)."""

    def __init__(self, cin: int, filters: int, rank: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        for i, (a, s) in enumerate(((cin, stride), (filters, 1))):
            setattr(self, f"conv{i}", _Conv(a, filters, 3, rank, s,
                                            bias=False, dtype=dtype))
            self.register_parameter(f"in_scale{i}",
                                    nn.Parameter(torch.ones(filters)))
            self.register_parameter(f"in_bias{i}",
                                    nn.Parameter(torch.zeros(filters)))

    def forward(self, x):
        for i in range(2):
            x = getattr(self, f"conv{i}")(x)
            x = _instance_norm(x, getattr(self, f"in_scale{i}"),
                               getattr(self, f"in_bias{i}"))
            x = F.leaky_relu(x, 0.01)
        return x


class _ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel 2 and stride 2 (``"SAME"``):
    ``conv_transpose{2,3}d`` of the kernel reversed in space, (in, out,
    *k), which the bridge lays out."""

    def __init__(self, cin: int, cout: int, rank: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, *(2,) * rank))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        fn = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
        return fn(x.to(self.dtype), self.weight.to(self.dtype),
                  self.bias.to(self.dtype), 2)

    def init_(self, generator: torch.Generator) -> None:
        # flax's lecun normal over the kernel's (k, k, in) fan-in
        cin = self.weight.shape[0]
        lecun_normal_(self.weight, cin * self.weight[0, 0].numel(), generator)
        self.bias.zero_()


class DynUNet(nn.Module):
    """(B, in_channels, *S) -> logits (B, n_classes, *S) fp32, and in
    training with ``deep_supervision`` the heads of decoder levels 2 and 1
    too: ``(logits, [heads])``."""

    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        r = cfg.spatial_rank
        f = [min(cfg.base_filters * 2 ** i, cfg.max_filters)
             for i in range(cfg.depth + 1)]
        self.input_block = ConvBlock(cfg.in_channels, f[0], r, 1, dtype)
        for d in range(cfg.depth):
            setattr(self, f"down_{d}", ConvBlock(f[d], f[d + 1], r, 2, dtype))
        for d in reversed(range(cfg.depth)):
            setattr(self, f"up_{d}", _ConvTranspose(f[d + 1], f[d], r, dtype))
            setattr(self, f"dec_{d}", ConvBlock(2 * f[d], f[d], r, 1, dtype))
            if cfg.deep_supervision and 0 < d <= 2:
                setattr(self, f"ds_head_{d}",
                        _Conv(f[d], cfg.n_classes, 1, r, dtype=acc_dtype(dtype)))
        self.head = _Conv(f[0], cfg.n_classes, 1, r, dtype=acc_dtype(dtype))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero biases, unit
        instance-norm scales."""
        for m in self.modules():
            if isinstance(m, (_Conv, _ConvTranspose)):
                m.init_(generator)

    def forward(self, x):
        cfg = self.cfg
        x = self.input_block(x.to(self.dtype))
        skips = []
        for d in range(cfg.depth):
            skips.append(x)
            x = getattr(self, f"down_{d}")(x)
        heads = []
        for d in reversed(range(cfg.depth)):
            x = torch.cat([getattr(self, f"up_{d}")(x), skips[d]], 1)
            x = getattr(self, f"dec_{d}")(x)
            if cfg.deep_supervision and 0 < d <= 2:
                head = getattr(self, f"ds_head_{d}")
                heads.append(head(x.to(head.dtype)))
        logits = self.head(x.to(self.head.dtype))
        if cfg.deep_supervision and self.training:
            return logits, heads
        return logits


@dataclass
class UNetTask:
    """A batch holds ``image`` (B, *S, in_channels), channels last as the
    JAX runner makes it, and ``label`` (B, *S) int."""

    cfg: UNetConfig = UNetConfig()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> DynUNet:
        model = DynUNet(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    @staticmethod
    def images(batch: dict) -> torch.Tensor:
        """The batch's channels-last images as (B, C, *S)."""
        return batch["image"].movedim(-1, 1)

    def loss_fn(self, model: DynUNet, model_state, batch: dict,
                generator: torch.Generator):
        """Dice plus cross-entropy; each deep-supervision head adds half the
        weight of the one before, its dice against the labels subsampled
        2 ** (i + 1) times, where its size matches those (JAX's check: at
        the decoder order it never does, so no head adds)."""
        out = model(self.images(batch))
        logits, heads = out if isinstance(out, tuple) else (out, [])
        labels = batch["label"].long()
        loss = dice_loss(logits, labels) + F.cross_entropy(
            logits.to(acc_dtype(logits.dtype)), labels)
        for i, h in enumerate(heads):
            factor = 2 ** (i + 1)
            sub = labels[(slice(None),) + (slice(None, None, factor),)
                         * self.cfg.spatial_rank]
            if h.shape[2] == sub.shape[1]:
                loss = loss + 0.5 ** (i + 1) * dice_loss(h, sub)
        return loss, (model_state, {})

    @torch.no_grad()
    def metric_fn(self, model: DynUNet, model_state, batch: dict) -> dict:
        """The mean dice of the argmax segmentation."""
        training = model.training
        model.eval()
        try:
            logits = model(self.images(batch))
        finally:
            model.train(training)
        c = self.cfg.n_classes
        y = F.one_hot(batch["label"].long(), c).float()
        p = F.one_hot(logits.argmax(1), c).float()
        axes = tuple(range(1, p.dim() - 1))
        inter = (p * y).sum(axes)
        denom = p.sum(axes) + y.sum(axes)
        return {"dice": ((2 * inter + 1e-5) / (denom + 1e-5)).mean()}


# -- BraTS22 UNet3D (the reference's brats22_model.py) ------------------------


def _upsample_align_corners(x, factor: int = 2):
    """Linear interpolation by ``factor`` on every spatial axis on torch's
    ``align_corners=True`` grid (an axis of one is repeated)."""
    mode = {4: "bilinear", 5: "trilinear"}[x.dim()]
    return F.interpolate(x, scale_factor=factor, mode=mode, align_corners=True)


class _Norm(nn.Module):
    """The affine instance norm's ``weight`` and ``bias``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return _instance_norm(x, self.weight, self.bias)


class _BratsConvLayer(nn.Module):
    """Instance norm over the INPUT channels, then the convolution (no bias,
    symmetric padding ``(k - s + 1) // 2``), then ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm = _Norm(cin)
        self.conv = _Conv(cin, cout, k, 3, stride, (k - stride + 1) // 2,
                          bias=False, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.conv(self.norm(x)))


class _BratsConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = _BratsConvLayer(cin, cout, k, stride, dtype)
        self.conv2 = _BratsConvLayer(cout, cout, k, 1, dtype)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class BratsUNet3D(nn.Module):
    """``brats22_model.UNet3D`` over (B, in_channels, D, H, W): ``kernels``
    and ``strides`` per level; filters [64, 128, ...] cut to the levels.
    Returns the fp32 logits, or in training with ``deep_supervision`` the
    list [logits, head of the next-to-last decoder level, head of the one
    before] (with three levels, one head)."""

    def __init__(self, kernels=(3, 3, 3, 3), strides=(1, 2, 2, 2),
                 in_channels: int = 5, n_classes: int = 3,
                 deep_supervision: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.deep_supervision = dtype, deep_supervision
        f = [64, 128, 256, 512, 768, 1024, 2048][:len(strides)]
        self.input_block = nn.Module()
        self.input_block.conv1 = _Conv(in_channels, f[0], 3, 3, pad=1,
                                       bias=False, dtype=dtype)
        self.input_block.norm = _Norm(f[0])
        self.input_block.conv2 = _Conv(f[0], f[0], 3, 3, pad=1, bias=False,
                                       dtype=dtype)
        self.downsamples = nn.ModuleList(
            [_BratsConvBlock(f[i], f[i + 1], k, s, dtype) for i, (k, s) in
             enumerate(zip(kernels[1:-1], strides[1:-1]))])
        self.bottleneck = _BratsConvBlock(f[-2], f[-1], kernels[-1],
                                          strides[-1], dtype)
        up = []
        for i, cout in enumerate(f[:-1][::-1]):
            block = nn.Module()
            block.conv_block = _BratsConvBlock(
                f[::-1][i] + cout, cout, kernels[1:][::-1][i], 1, dtype)
            up.append(block)
        self.upsamples = nn.ModuleList(up)
        out = acc_dtype(dtype)
        self.output_block = nn.Module()
        self.output_block.conv = _Conv(f[0], n_classes, 1, 3, dtype=out)
        if deep_supervision:
            heads = []  # one per decoder level below the last, at most 2
            for j in range(min(2, len(f) - 2)):
                head = nn.Module()
                head.conv = _Conv(f[j + 1], n_classes, 1, 3, dtype=out)
                heads.append(head)
            self.deep_supervision_heads = nn.ModuleList(heads)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, _Conv):
                m.init_(generator)

    def forward(self, x):
        blk = self.input_block
        x = torch.relu(blk.norm(blk.conv1(x.to(self.dtype))))
        x = torch.relu(blk.conv2(x))
        skips = [x]
        for down in self.downsamples:
            x = down(x)
            skips.append(x)
        x = self.bottleneck(x)
        decoded = []
        for i, up in enumerate(self.upsamples):
            x = torch.cat([_upsample_align_corners(x), skips[-(i + 1)]], 1)
            x = up.conv_block(x)
            decoded.append(x)
        conv = self.output_block.conv
        out = conv(x.to(conv.dtype))
        if not (self.training and self.deep_supervision):
            return out
        heads = [out]
        for j, dec in enumerate(decoded[-3:-1][::-1]):
            conv = self.deep_supervision_heads[j].conv
            heads.append(conv(dec.to(conv.dtype)))
        return heads
