"""HiFi-GAN: the generator, the multi-period and multi-scale
discriminators and their alternating GAN steps, in PyTorch.

Port of ``deeplearningexamples_tpu/models/tts/hifigan.py`` (reference
``PyTorch/SpeechSynthesis/HiFiGAN/hifigan/models.py``). The generator keeps
the names ``utils/torch_import.convert_hifigan_generator`` in the JAX
package reads (``conv_pre``, ``ups.{i}``, ``resblocks.{i}.{j}.convs1.{m}``,
``conv_post``), the discriminators the reference's
(``mpd.discriminators.{k}.convs.{i}``, ``msd.discriminators.{k}.conv_post``
...). Weight norm is not used, as in JAX. Convolutions run NCW (NCHW for a
period discriminator's (T / p, p) plane) with flax's padding:

- each upsampling layer is a ``ConvTranspose1d`` with padding ``(k - u) //
  2``, which gives flax's ``ConvTranspose(padding="SAME")`` output (T x u)
  with the kernel reversed in time (the bridge reverses JAX's);
- flax's ``"SAME"`` under a stride pads one more on the right (a period
  discriminator's (5, 1) convs at stride (3, 1), the scale
  discriminators' strided convs);
- the scales' average pool pads ``"SAME"`` with zeros and counts them in the
  mean;
- the generator's last activation is a leaky ReLU of slope 0.01 (the
  reference's ``F.leaky_relu`` default), every other one 0.1; a scale
  discriminator's groups are ``min(g, channels in)``.

The last convolutions (the generator's ``conv_post`` and each
discriminator's) run in fp32. ``HiFiGanTask`` gives the differentiable
log-mel of the mel-L1 loss (reflect padding, a periodic Hann window,
``rfft``) and the alternating ``d_step`` and ``g_step``, the fake audio
detached in the discriminator's loss. Under a data axis each step averages
its gradients and its losses over the data ranks (the losses are plain
means over equal rows), as JAX's steps do on the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import all_reduce_mean_, mean_over_data
from .audio import MelConfig, mel_filterbank
from .layers import Conv1d, acc_dtype, lecun_normal_, same_pads

__all__ = ["HiFiGanConfig", "HiFiGanDiscriminators", "HiFiGanGenerator",
           "HiFiGanTask", "PeriodDiscriminator", "ResBlock",
           "ScaleDiscriminator"]


@dataclass(frozen=True)
class HiFiGanConfig:
    """The JAX ``HiFiGanConfig``'s fields and defaults."""

    n_mels: int = 80
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    periods: tuple[int, ...] = (2, 3, 5, 7, 11)
    segment_length: int = 8192
    hop_length: int = 256
    lrelu: float = 0.1
    mpd_channels: tuple[int, ...] = (32, 128, 512, 1024)
    msd_channels: tuple[int, ...] = (128, 128, 256, 512, 1024, 1024, 1024)
    msd_scales: int = 3


class _ConvTranspose1d(nn.ConvTranspose1d):
    """An upsampling layer in ``dtype``: output length T x stride."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        if (k - stride) % 2:
            raise ValueError(f"kernel {k} - stride {stride} must be even")
        super().__init__(cin, cout, k, stride, padding=(k - stride) // 2)
        self.dtype = dtype

    def forward(self, x):
        return F.conv_transpose1d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), self.stride,
                                  self.padding)

    def init_(self, generator: torch.Generator) -> None:
        cin, _, k = self.weight.shape
        lecun_normal_(self.weight, cin * k, generator)
        with torch.no_grad():
            self.bias.zero_()


class _PeriodConv(nn.Conv2d):
    """A (k, 1) convolution over (B, C, T / p, p) in ``dtype``, flax's
    ``"SAME"`` padding along T / p."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__(cin, cout, (k, 1), (stride, 1))
        self.dtype = dtype

    def forward(self, x):
        lo, hi = same_pads(x.shape[2], self.kernel_size[0], self.stride[0])
        return F.conv2d(F.pad(x.to(self.dtype), (0, 0, lo, hi)),
                        self.weight.to(self.dtype), self.bias.to(self.dtype),
                        self.stride)

    def init_(self, generator: torch.Generator) -> None:
        cout, cin, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k, generator)
        with torch.no_grad():
            self.bias.zero_()


class ResBlock(nn.Module):
    """``x + c2(lrelu(c1(lrelu(x))))`` per dilation, ``c1`` dilated."""

    def __init__(self, ch: int, kernel: int, dilations: tuple[int, ...],
                 lrelu: float, dtype: torch.dtype):
        super().__init__()
        self.lrelu = lrelu
        self.convs1 = nn.ModuleList(Conv1d(ch, ch, kernel, dilation=d,
                                           dtype=dtype) for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(ch, ch, kernel, dtype=dtype)
                                    for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            y = c1(F.leaky_relu(x, self.lrelu))
            x = x + c2(F.leaky_relu(y, self.lrelu))
        return x


class HiFiGanGenerator(nn.Module):
    """mel (B, T, n_mels) -> audio (B, T x hop) fp32."""

    def __init__(self, cfg: HiFiGanConfig = HiFiGanConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.n_mels, c0, 7, dtype=dtype)
        chs = [c0 // 2 ** (i + 1) for i in range(len(cfg.upsample_rates))]
        self.ups = nn.ModuleList(
            _ConvTranspose1d(c0 // 2 ** i, ch, k, r, dtype)
            for i, (ch, r, k) in enumerate(zip(chs, cfg.upsample_rates,
                                               cfg.upsample_kernels)))
        self.resblocks = nn.ModuleList(
            nn.ModuleList(ResBlock(ch, k, d, cfg.lrelu, dtype) for k, d in
                          zip(cfg.resblock_kernels, cfg.resblock_dilations))
            for ch in chs)
        self.conv_post = Conv1d(chs[-1], 1, 7, dtype=acc_dtype(dtype))

    def forward(self, mel):
        x = self.conv_pre(mel.transpose(1, 2))
        for up, mrf in zip(self.ups, self.resblocks):
            x = up(F.leaky_relu(x, self.cfg.lrelu))
            acc = None
            for blk in mrf:
                y = blk(x)
                acc = y if acc is None else acc + y
            x = acc / len(mrf)
        # the reference's last activation: F.leaky_relu's default slope
        x = F.leaky_relu(x, 0.01)
        return torch.tanh(self.conv_post(x.to(self.conv_post.dtype)))[:, 0]


class PeriodDiscriminator(nn.Module):
    """audio (B, T) -> (score (B, -1) fp32, features): the audio
    reflect-padded to a multiple of the period and folded to (T / p, p)."""

    def __init__(self, period: int, lrelu: float, dtype: torch.dtype,
                 channels: tuple[int, ...] = (32, 128, 512, 1024)):
        super().__init__()
        self.period, self.lrelu = period, lrelu
        cins = (1,) + tuple(channels)
        self.convs = nn.ModuleList(
            [_PeriodConv(cin, c, 5, 3, dtype) for cin, c in zip(cins, channels)]
            + [_PeriodConv(channels[-1], channels[-1], 5, 1, dtype)])
        self.conv_post = _PeriodConv(channels[-1], 1, 3, 1, acc_dtype(dtype))

    def forward(self, audio):
        b, t = audio.shape
        p = self.period
        x = F.pad(audio[:, None], (0, (-t) % p), mode="reflect")
        x = x.view(b, 1, -1, p)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.lrelu)
            feats.append(x)
        score = self.conv_post(x.to(self.conv_post.dtype))
        return score.reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    """audio (B, T) -> (score (B, -1) fp32, features)."""

    STRIDES = (1, 2, 2, 4, 4, 1, 1)
    GROUPS = (1, 4, 16, 16, 16, 16, 1)
    KERNELS = (15, 41, 41, 41, 41, 41, 5)

    def __init__(self, lrelu: float, dtype: torch.dtype,
                 channels: tuple[int, ...] = (128, 128, 256, 512, 1024, 1024,
                                              1024)):
        super().__init__()
        self.lrelu = lrelu
        cins = (1,) + tuple(channels)
        self.convs = nn.ModuleList(
            Conv1d(cin, c, k, stride=s, groups=min(g, cin), dtype=dtype)
            for cin, c, s, g, k in zip(cins, channels, self.STRIDES,
                                       self.GROUPS, self.KERNELS))
        self.conv_post = Conv1d(channels[-1], 1, 3, dtype=acc_dtype(dtype))

    def forward(self, audio):
        x = audio[:, None]
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.lrelu)
            feats.append(x)
        score = self.conv_post(x.to(self.conv_post.dtype))
        return score.reshape(audio.shape[0], -1), feats


def _avg_pool_same(x):
    """flax's ``avg_pool(window 4, stride 2, "SAME")`` over (B, T): zero
    padding, counted in the mean."""
    lo, hi = same_pads(x.shape[-1], 4, 2)
    return F.avg_pool1d(F.pad(x[:, None], (lo, hi)), 4, 2)[:, 0]


class HiFiGanDiscriminators(nn.Module):
    """audio (B, T) -> (scores, features), the period discriminators' first
    and then the scales'."""

    def __init__(self, cfg: HiFiGanConfig = HiFiGanConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.mpd = nn.Module()
        self.mpd.discriminators = nn.ModuleList(
            PeriodDiscriminator(p, cfg.lrelu, dtype, cfg.mpd_channels)
            for p in cfg.periods)
        self.msd = nn.Module()
        self.msd.discriminators = nn.ModuleList(
            ScaleDiscriminator(cfg.lrelu, dtype, cfg.msd_channels)
            for _ in range(cfg.msd_scales))

    def forward(self, audio):
        scores, feats = [], []
        for d in self.mpd.discriminators:
            s, f = d(audio)
            scores.append(s)
            feats.append(f)
        x = audio
        n = len(self.msd.discriminators)
        for i, d in enumerate(self.msd.discriminators):
            s, f = d(x)
            scores.append(s)
            feats.append(f)
            if i < n - 1:
                x = _avg_pool_same(x)
        return scores, feats


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.to(acc_dtype(x.dtype))


@torch.no_grad()
def _init_(model: nn.Module, generator: torch.Generator) -> None:
    for m in model.modules():
        if isinstance(m, (Conv1d, _ConvTranspose1d, _PeriodConv)):
            m.init_(generator)


@dataclass
class HiFiGanTask:
    """GAN training: ``d_step`` and ``g_step`` each update one network in
    place with its own optimizer. A batch holds ``mel`` (B, T, n_mels) and
    ``audio`` (B, T x hop) fp32."""

    cfg: HiFiGanConfig = HiFiGanConfig()
    dtype: torch.dtype = torch.bfloat16
    mel_loss_weight: float = 45.0
    fm_loss_weight: float = 2.0

    def __post_init__(self):
        self._mel_cfg = MelConfig(n_mels=self.cfg.n_mels,
                                  hop_length=self.cfg.hop_length)
        self._fb = mel_filterbank(self._mel_cfg).T.astype(np.float32)

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda"
             ) -> tuple[HiFiGanGenerator, HiFiGanDiscriminators]:
        gen = HiFiGanGenerator(self.cfg, self.dtype)
        disc = HiFiGanDiscriminators(self.cfg, self.dtype)
        _init_(gen, generator)
        _init_(disc, generator)
        return gen.to(device).train(), disc.to(device).train()

    def mel(self, audio: torch.Tensor) -> torch.Tensor:
        """The differentiable log-mel (B, frames, n_mels) of fp32 (or
        float64) audio."""
        mc = self._mel_cfg
        pad = mc.n_fft // 2
        x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
        win = torch.from_numpy(
            np.hanning(mc.win_length + 1)[:-1].astype(np.float32)).to(x.device)
        frames = x.unfold(1, mc.n_fft, mc.hop_length) * win
        mag = torch.fft.rfft(frames, dim=-1).abs()
        mel = mag @ torch.from_numpy(self._fb).to(x.device, mag.dtype)
        return torch.log(mel.clamp_min(1e-5))

    def d_loss(self, gen, disc, batch) -> torch.Tensor:
        with torch.no_grad():
            fake = gen(batch["mel"])
        real_scores, _ = disc(batch["audio"])
        fake_scores, _ = disc(fake)
        loss = 0.0
        for r, f in zip(real_scores, fake_scores):
            loss = loss + ((r - 1.0) ** 2).mean() + (f ** 2).mean()
        return loss

    def g_loss(self, gen, disc, batch):
        fake = gen(batch["mel"])
        fake_scores, fake_feats = disc(fake)
        with torch.no_grad():
            _, real_feats = disc(batch["audio"])
        adv = sum(((f - 1.0) ** 2).mean() for f in fake_scores)
        fm = sum((_acc(rf) - _acc(ff)).abs().mean()
                 for rfs, ffs in zip(real_feats, fake_feats)
                 for rf, ff in zip(rfs, ffs))
        mel_l1 = (self.mel(fake) - self.mel(batch["audio"])).abs().mean()
        loss = adv + self.fm_loss_weight * fm + self.mel_loss_weight * mel_l1
        return loss, {"adv": adv.detach(), "fm": fm.detach(),
                      "mel_l1": mel_l1.detach()}

    @staticmethod
    def grads(model: nn.Module, loss: torch.Tensor) -> dict:
        """The gradients of ``loss`` by parameter name, averaged over the
        data axis (0 where the loss does not reach a parameter)."""
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        with torch.no_grad():
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            all_reduce_mean_(list(grads.values()))
        return grads

    @classmethod
    def _update(cls, tx, model: nn.Module, opt_state, loss: torch.Tensor):
        params = dict(model.named_parameters())
        grads = cls.grads(model, loss)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            torch._foreach_add_(list(params.values()),
                                [updates[n] for n in params])
        return opt_state

    def make_steps(self, g_tx, d_tx):
        """``g_step(gen, g_opt, disc, batch) -> (g_opt, loss, aux)`` and
        ``d_step(disc, d_opt, gen, batch) -> (d_opt, loss)``; the optimizer
        states come from ``tx.init(dict(model.named_parameters()))``."""

        def d_step(disc, d_opt, gen, batch):
            loss = self.d_loss(gen, disc, batch)
            d_opt = self._update(d_tx, disc, d_opt, loss)
            return d_opt, mean_over_data({"loss": loss.detach()})["loss"]

        def g_step(gen, g_opt, disc, batch):
            loss, aux = self.g_loss(gen, disc, batch)
            g_opt = self._update(g_tx, gen, g_opt, loss)
            aux = mean_over_data({**aux, "loss": loss.detach()})
            return g_opt, aux.pop("loss"), aux

        return g_step, d_step
