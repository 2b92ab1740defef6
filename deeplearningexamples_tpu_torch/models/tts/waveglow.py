"""WaveGlow: the normalizing-flow vocoder.

Port of ``deeplearningexamples_tpu/models/tts/waveglow.py`` (reference
``PyTorch/SpeechSynthesis/Tacotron2/waveglow/model.py:160-381``): 12 flows
over audio grouped into 8 channels, each an invertible 1x1 channel mix and
a WN affine coupling of gated-tanh dilated convolutions; 2 channels leave
early every 4 flows; the mel conditioning is upsampled by a transposed
convolution. The modules carry the reference's ``state_dict`` names (the
ones the JAX package's ``utils/torch_import.convert_waveglow`` reads), with
plain weights: JAX trains the convolutions with weight norm folded in, and
so does the port.

The layout is the reference's NCW, which puts three things where the
reference has them and JAX does not (the bridge,
``utils/jax_bridge.waveglow_state_dict_from_jax``, re-lays JAX's weights):

- ``upsample`` is ``ConvTranspose1d`` (JAX's kernel is reversed in time);
- the conditioning channels are mel-major, ``m * n_group + g`` (JAX's are
  group-major), with one ``cond_layers.{i}`` per WN layer, run as one
  convolution;
- ``end`` gives ``(b, log_s)`` (JAX's gives ``(log_s, b)``).

Audio groups as ``t * n_group + g`` in both. ``end`` starts at zero, so a
fresh model's couplings are the identity. ``log_det`` is ``slogdet`` in
fp32 times ``B * T``, the inverse mix ``inv`` in float64, ``log_s`` and the
affine step fp32 under bf16. The interface is JAX's: audio (B, S), mel (B,
T_mel, n_mel); ``forward`` returns z (B, n_group, T) in the reference's
channel order, the early outputs first.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .layers import acc_dtype, lecun_normal_

__all__ = ["Invertible1x1Conv", "WN", "WaveGlow", "WaveGlowConfig",
           "waveglow_loss"]


@dataclass(frozen=True)
class WaveGlowConfig:
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    wn_n_layers: int = 8
    wn_n_channels: int = 256
    wn_kernel_size: int = 3
    sampling_rate: int = 22050
    segment_length: int = 8000
    hop_length: int = 256


class Invertible1x1Conv(nn.Module):
    """``conv.weight`` (C, C, 1): z -> W z, orthogonal at init (QR, the
    determinant made positive)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, 1, bias=False)

    def forward(self, z: torch.Tensor, reverse: bool = False):
        w = self.conv.weight[..., 0]
        if reverse:
            w_inv = torch.linalg.inv(w.double()).to(acc_dtype(z.dtype))
            return F.conv1d(z, w_inv.to(z.dtype)[..., None]), None
        log_det = torch.linalg.slogdet(w.to(acc_dtype(w.dtype)))[1]
        return F.conv1d(z, w.to(z.dtype)[..., None]), log_det

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        c = self.conv.weight.shape[0]
        q, _ = torch.linalg.qr(torch.randn(c, c, generator=generator,
                                           dtype=torch.float64))
        if torch.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        self.conv.weight.copy_(q[..., None])


class WN(nn.Module):
    """The gated dilated-conv stack: (audio half (B, n_half, T), cond (B,
    n_mel * n_group, T)) -> (log_s, b), each (B, n_half, T) in fp32."""

    def __init__(self, cfg: WaveGlowConfig, n_half: int, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.n_half, self.dtype = cfg, n_half, dtype
        c, n = cfg.wn_n_channels, cfg.wn_n_layers
        self.start = nn.Conv1d(n_half, c, 1)
        self.cond_layers = nn.ModuleList(
            nn.Conv1d(cfg.n_mel_channels * cfg.n_group, 2 * c, 1)
            for _ in range(n))
        k = cfg.wn_kernel_size
        self.in_layers = nn.ModuleList(
            nn.Conv1d(c, 2 * c, k, dilation=2**i, padding=(k - 1) // 2 * 2**i)
            for i in range(n))
        self.res_skip_layers = nn.ModuleList(
            nn.Conv1d(c, 2 * c if i < n - 1 else c, 1) for i in range(n))
        self.end = nn.Conv1d(c, 2 * n_half, 1)

    def _conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        """``conv`` in the compute dtype, with flax's ``SAME`` padding."""
        return F.conv1d(x.to(self.dtype), conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), padding=conv.padding,
                        dilation=conv.dilation)

    def forward(self, audio_half: torch.Tensor, cond: torch.Tensor):
        c = self.cfg.wn_n_channels
        x = self._conv(self.start, audio_half)
        # every layer's conditioning at once, as JAX's one cond_layer
        cond_all = F.conv1d(
            cond.to(self.dtype),
            torch.cat([m.weight for m in self.cond_layers]).to(self.dtype),
            torch.cat([m.bias for m in self.cond_layers]).to(self.dtype))
        output = None
        n = len(self.in_layers)
        for i in range(n):
            in_act = self._conv(self.in_layers[i], x) \
                + cond_all[:, 2 * c * i:2 * c * (i + 1)]
            acts = torch.tanh(in_act[:, :c]) * torch.sigmoid(in_act[:, c:])
            res_skip = self._conv(self.res_skip_layers[i], acts)
            if i < n - 1:
                x = x + res_skip[:, :c]
                skip = res_skip[:, c:]
            else:
                skip = res_skip
            output = skip if output is None else output + skip
        f32 = acc_dtype(self.dtype)
        end = F.conv1d(output.to(f32), self.end.weight.to(f32),
                       self.end.bias.to(f32))
        return end[:, self.n_half:], end[:, :self.n_half]  # log_s, b

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """flax's lecun normal kernels and zero biases; ``end`` all zeros."""
        for m in (self.start, *self.cond_layers, *self.in_layers,
                  *self.res_skip_layers):
            cout, cin, k = m.weight.shape
            lecun_normal_(m.weight, cin * k, generator)
            m.bias.zero_()
        self.end.weight.zero_()
        self.end.bias.zero_()


class WaveGlow(nn.Module):
    def __init__(self, cfg: WaveGlowConfig = WaveGlowConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.upsample = nn.ConvTranspose1d(cfg.n_mel_channels,
                                           cfg.n_mel_channels, 1024,
                                           stride=cfg.hop_length)
        sizes = self.flow_channels()
        self.convinv = nn.ModuleList(Invertible1x1Conv(s) for s in sizes)
        self.WN = nn.ModuleList(WN(cfg, s // 2, dtype) for s in sizes)

    def flow_channels(self) -> list[int]:
        """The audio channels entering each flow."""
        cfg, sizes, remaining = self.cfg, [], self.cfg.n_group
        for k in range(cfg.n_flows):
            if k % cfg.n_early_every == 0 and k > 0:
                remaining -= cfg.n_early_size
            sizes.append(remaining)
        return sizes

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn from ``generator`` (a CPU generator) in
        the modules' order."""
        w = self.upsample.weight  # (in, out, k); flax's fan_in is k * in
        lecun_normal_(w, w.shape[0] * w.shape[2], generator)
        self.upsample.bias.zero_()
        for m in self.modules():
            if isinstance(m, (WN, Invertible1x1Conv)):
                m.init_(generator)

    def _cond(self, mel: torch.Tensor, t: int) -> torch.Tensor:
        """mel (B, T_mel, n_mel) -> (B, n_mel * n_group, t), mel-major."""
        cfg = self.cfg
        up = F.conv_transpose1d(mel.transpose(1, 2).to(self.dtype),
                                self.upsample.weight.to(self.dtype),
                                self.upsample.bias.to(self.dtype),
                                stride=cfg.hop_length)
        up = up[:, :, :t * cfg.n_group]
        b = up.shape[0]
        return up.reshape(b, cfg.n_mel_channels, t, cfg.n_group).transpose(
            2, 3).reshape(b, cfg.n_mel_channels * cfg.n_group, t)

    def forward(self, audio: torch.Tensor, mel: torch.Tensor):
        """audio (B, S), mel (B, T_mel, n_mel) -> (z (B, n_group, S //
        n_group) fp32, total log_s, total log_det)."""
        cfg = self.cfg
        b, s = audio.shape
        t = s // cfg.n_group
        z = audio[:, :t * cfg.n_group].reshape(b, t, cfg.n_group).transpose(
            1, 2).to(self.dtype)
        cond = self._cond(mel, t)
        f32 = acc_dtype(self.dtype)
        out_z, total_log_s, total_log_det = [], 0.0, 0.0
        for k, (inv, wn) in enumerate(zip(self.convinv, self.WN)):
            if k % cfg.n_early_every == 0 and k > 0:
                out_z.append(z[:, :cfg.n_early_size].to(f32))
                z = z[:, cfg.n_early_size:]
            z, log_det = inv(z)
            total_log_det = total_log_det + log_det * (b * t)
            n_half = wn.n_half
            z0, z1 = z[:, :n_half], z[:, n_half:]
            log_s, bias = wn(z0, cond)
            z1 = (z1.to(f32) * torch.exp(log_s) + bias).to(self.dtype)
            total_log_s = total_log_s + log_s.sum()
            z = torch.cat([z0, z1], 1)
        out_z.append(z.to(f32))
        return torch.cat(out_z, 1), total_log_s, total_log_det

    @torch.no_grad()
    def infer(self, mel: torch.Tensor, sigma: float = 1.0,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """The inverse flow from noise: mel (B, T_mel, n_mel) -> audio (B,
        T_mel * hop_length) fp32. The noise is N(0, sigma^2), drawn from
        ``generator`` on its own device (the CPU's default generator when
        None): first the last flow's channels, then each early output's as
        the flows are undone."""
        cfg = self.cfg
        b, t_mel, _ = mel.shape
        t = t_mel * cfg.hop_length // cfg.n_group
        cond = self._cond(mel, t)
        f32 = acc_dtype(self.dtype)

        def noise(c: int) -> torch.Tensor:
            gdev = generator.device if generator is not None else "cpu"
            n = torch.randn(b, c, t, generator=generator, device=gdev)
            return (sigma * n).to(mel.device, self.dtype)

        sizes = self.flow_channels()
        z = noise(sizes[-1])
        for k in reversed(range(cfg.n_flows)):
            wn = self.WN[k]
            z0, z1 = z[:, :wn.n_half], z[:, wn.n_half:]
            log_s, bias = wn(z0, cond)
            z1 = ((z1.to(f32) - bias) * torch.exp(-log_s)).to(self.dtype)
            z, _ = self.convinv[k](torch.cat([z0, z1], 1), reverse=True)
            if k % cfg.n_early_every == 0 and k > 0:
                z = torch.cat([noise(cfg.n_early_size), z], 1)
        return z.transpose(1, 2).reshape(b, t * cfg.n_group).to(f32)


def waveglow_loss(z, log_s_total, log_det_total, sigma: float = 1.0):
    """The negative log-likelihood per element (reference
    ``waveglow/loss_function.py:30-48``)."""
    return ((z * z).sum() / (2 * sigma * sigma) - log_s_total
            - log_det_total) / z.numel()
