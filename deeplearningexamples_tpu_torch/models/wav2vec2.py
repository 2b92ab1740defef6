"""wav2vec 2.0: self-supervised speech pretraining and CTC fine-tuning, in
PyTorch.

Port of ``deeplearningexamples_tpu/models/wav2vec2.py`` (reference
``PyTorch/SpeechRecognition/wav2vec2/wav2vec2/model.py``), with the
reference's ``state_dict`` names, which
``utils/torch_import.convert_wav2vec2`` in the JAX package reads
(``feature_extractor.conv_layers.{i}.0``, its GroupNorm ``.2``,
``layer_norm``, ``post_extract_proj``, ``mask_emb``, ``encoder.pos_conv.0``,
``encoder.layer_norm``, ``encoder.layers.{i}.self_attn.{q,k,v,out}_proj``,
``self_attn_layer_norm``, ``fc1``, ``fc2``, ``final_layer_norm``,
``final_proj``, ``project_q``, ``quantizer.weight_proj``,
``quantizer.vars``):

- the feature encoder: strided convolutions without bias over the raw
  audio, ``GroupNorm(512, 512)`` on the first only (the BASE recipe's
  "default" mode; "layer_norm" puts a LayerNorm on each), exact GELU;
- the context network: the latents' LayerNorm and projection, masked
  frames replaced by ``mask_emb``, the grouped positional convolution (128
  taps, 16 groups, 64 pads a side, its last step dropped) through GELU and
  added, then post-LN blocks (pre-LN with ``layer_norm_first``) whose
  attention runs the flash kernels (K1/K2) with no mask and no dropout,
  q, k and v read in place from their projections;
- the Gumbel product quantizer: fp32 logits, ``softmax((logits + g) /
  tau)`` with a straight-through hard one-hot, or a plain argmax without
  noise, and the softmax perplexity for the diversity term.

flax's ``LayerNorm`` and ``GroupNorm`` take epsilon 1e-6, which the port
keeps. The random draws, the Gumbel noise's uniforms and the negatives'
indices in ``Wav2Vec2Task``, the time mask in ``Wav2Vec2CtcTask``, each
come from one method, which the CPU tests replace with JAX's draws; the
hidden dropout is ``ops.dropout.RegenDropout``.

Under a data axis (``parallel/mesh.py``) each draw is made at the global
batch's rows and a rank keeps its own (``draw_rows``), the contrastive
loss is over the global batch's masked frames (``data_mean``), and the
perplexity is of the codebook probabilities' mean over the global batch's
frames (``sum_over_ranks``): a nonlinear function of a batch mean, which
the ranks' own perplexities averaged would not give.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.losses import ctc_loss
from ..ops.dropout import RegenDropout
from ..ops.flash_attention import flash_attention
from ..parallel.mesh import data_mean, data_rows, draw_rows, sum_over_ranks
from .bert.modeling import LayerNorm
from .convnets.layers import Dense
from .tts.layers import Conv1d, acc_dtype

__all__ = ["ContextBlock", "FeatureEncoder", "GumbelQuantizer", "Wav2Vec2",
           "Wav2Vec2Config", "Wav2Vec2CtcTask", "Wav2Vec2ForCTC",
           "Wav2Vec2Task", "n_frames", "sample_spans_mask"]

EPS = 1e-6  # flax's LayerNorm and GroupNorm


@dataclass(frozen=True)
class Wav2Vec2Config:
    """The JAX ``Wav2Vec2Config``'s fields and defaults (BASE)."""

    conv_layers: tuple = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                          (512, 3, 2), (512, 2, 2), (512, 2, 2))
    extractor_mode: str = "group_norm"  # or "layer_norm"
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dropout: float = 0.1
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    n_groups: int = 2
    n_entries: int = 320
    codevector_dim: int = 256
    mask_prob: float = 0.065
    mask_span: int = 10
    n_negatives: int = 100
    temperature: float = 0.1
    diversity_weight: float = 0.1


class _GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm``: fp32 statistics, the output in ``dtype``."""

    def __init__(self, groups: int, ch: int, dtype: torch.dtype):
        super().__init__(groups, ch, eps=EPS)
        self.dtype = dtype

    def forward(self, x):
        return F.group_norm(x.to(acc_dtype(self.dtype)), self.num_groups,
                            self.weight, self.bias, self.eps).to(self.dtype)


class _ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channels of (B, C, T)."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class FeatureEncoder(nn.Module):
    """audio (B, T) -> (B, frames, 512)."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        cin = 1
        for i, (ch, k, s) in enumerate(cfg.conv_layers):
            block = nn.ModuleDict(
                {"0": Conv1d(cin, ch, k, s, "VALID", bias=False, dtype=dtype)})
            if cfg.extractor_mode == "layer_norm":
                block["2"] = nn.ModuleDict(
                    {"1": _ChannelLayerNorm(ch, EPS, dtype)})
            elif i == 0:
                block["2"] = _GroupNorm(ch, ch, dtype)
            self.conv_layers.append(block)
            cin = ch

    def forward(self, audio):
        x = audio[:, None]
        for block in self.conv_layers:
            x = block["0"](x)
            if "2" in block:
                norm = block["2"]
                x = norm["1"](x) if isinstance(norm, nn.ModuleDict) else norm(x)
            x = F.gelu(x)
        return x.transpose(1, 2)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.n_heads = cfg.n_heads
        d = cfg.d_model
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(d, d, dtype) for _ in range(4))

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = (p(x).view(b, s, self.n_heads, d // self.n_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        ctx = flash_attention(q, k, v, layout="bshd")
        return self.out_proj(ctx.reshape(b, s, d))


class ContextBlock(nn.Module):
    """A transformer block, post-LN (BASE) or pre-LN."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.pre_ln = cfg.layer_norm_first
        self.self_attn = _SelfAttention(cfg, dtype)
        self.self_attn_layer_norm = LayerNorm(cfg.d_model, EPS, dtype)
        self.fc1 = Dense(cfg.d_model, cfg.d_ff, dtype)
        self.fc2 = Dense(cfg.d_ff, cfg.d_model, dtype)
        self.final_layer_norm = LayerNorm(cfg.d_model, EPS, dtype)
        self.drop = RegenDropout(cfg.dropout)

    def _ff(self, x):
        return self.fc2(F.gelu(self.fc1(x)))

    def forward(self, x, generator=None):
        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        if self.pre_ln:
            x = x + self.drop(self.self_attn(ln1(x)), generator)
            return x + self.drop(self._ff(ln2(x)), generator)
        x = ln1(x + self.drop(self.self_attn(x), generator))
        return ln2(x + self.drop(self._ff(x), generator))


class GumbelQuantizer(nn.Module):
    """The product quantizer: ``vars`` (1, groups x entries, dim / groups)
    is the codebook."""

    def __init__(self, cfg: Wav2Vec2Config, cin: int):
        super().__init__()
        self.cfg = cfg
        g, e = cfg.n_groups, cfg.n_entries
        self.weight_proj = Dense(cin, g * e, torch.float32)
        self.vars = nn.Parameter(torch.empty(1, g * e, cfg.codevector_dim // g))

    def forward(self, z, tau: float, uniform: torch.Tensor | None = None):
        """(q (B, T, codevector_dim), perplexity (groups,)), fp32 (float64 in
        a float64 model). ``uniform``
        (B, T, groups, entries) in (0, 1) gives the Gumbel noise; None takes
        the plain argmax."""
        cfg = self.cfg
        b, t, _ = z.shape
        g, e = cfg.n_groups, cfg.n_entries
        logits = self.weight_proj(z.to(self.weight_proj.dtype)).reshape(
            b, t, g, e)
        if uniform is None:
            y = F.one_hot(logits.argmax(-1), e).to(logits.dtype)
        else:
            gumbel = -torch.log(-torch.log(uniform))
            y = torch.softmax((logits + gumbel) / tau, -1)
            y_hard = F.one_hot(y.argmax(-1), e).to(y.dtype)
            y = y_hard + y - y.detach()  # straight-through
        codebook = self.vars.to(logits.dtype).reshape(g, e, -1)
        q = torch.einsum("btge,ged->btgd", y, codebook).reshape(b, t, -1)
        # the mean over the global batch's frames: the rows' sums summed
        # over the data axis (whose backward sums the cotangents, as each
        # rank's loss holds the whole perplexity), over the global count
        n = data_rows(b)[1] * t
        avg = sum_over_ranks(torch.softmax(logits, -1).sum((0, 1))) / n
        perplexity = torch.exp(-(avg * torch.log(avg + 1e-9)).sum(-1))
        return q, perplexity


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        p = cfg.conv_pos
        self.pos_conv = nn.ModuleList([Conv1d(
            cfg.d_model, cfg.d_model, p, padding=p // 2,
            groups=cfg.conv_pos_groups, dtype=dtype)])
        self.layer_norm = LayerNorm(cfg.d_model, EPS, dtype)
        self.layers = nn.ModuleList(ContextBlock(cfg, dtype)
                                    for _ in range(cfg.n_layers))


class Wav2Vec2(nn.Module):
    """``features``, ``contextualize`` and the pretraining ``forward`` of
    JAX's ``Wav2Vec2``. ``pretraining=False`` leaves out the quantizer and
    the two output projections, which fine-tuning does not call (JAX's
    CTC tree has none)."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 dtype: torch.dtype = torch.bfloat16, pretraining: bool = True):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        ch = cfg.conv_layers[-1][0]
        self.feature_extractor = FeatureEncoder(cfg, dtype)
        self.layer_norm = LayerNorm(ch, EPS, dtype)
        self.post_extract_proj = Dense(ch, cfg.d_model, dtype)
        self.mask_emb = nn.Parameter(torch.empty(cfg.d_model))
        self.encoder = _Encoder(cfg, dtype)
        if pretraining:
            self.final_proj = Dense(cfg.d_model, cfg.codevector_dim,
                                    acc_dtype(dtype))
            self.project_q = Dense(cfg.codevector_dim, cfg.codevector_dim,
                                   acc_dtype(dtype))
            self.quantizer = GumbelQuantizer(cfg, ch)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun normal kernels, zero biases, unit
        norms, ``mask_emb`` U(0, 1), the codebook N(0, 1)."""
        for m in self.modules():
            if isinstance(m, (Conv1d, Dense)):
                m.init_(generator)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.mask_emb.copy_(torch.rand(self.mask_emb.shape, generator=generator))
        if hasattr(self, "quantizer"):
            v = self.quantizer.vars
            v.copy_(torch.randn(v.shape, generator=generator))

    def features(self, audio):
        return self.layer_norm(self.feature_extractor(audio))

    def contextualize(self, latents, mask, generator=None):
        """The context network's output (B, T, d_model), before
        ``final_proj``; ``mask`` (B, T) bool marks the masked frames."""
        cfg = self.cfg
        x = self.post_extract_proj(latents)
        x = torch.where(mask[:, :, None], self.mask_emb.to(x.dtype), x)
        pc = self.encoder.pos_conv[0](x.transpose(1, 2)).transpose(1, 2)
        if cfg.conv_pos % 2 == 0:
            pc = pc[:, :-1]  # an even kernel gives one step more
        x = x + F.gelu(pc)
        if not cfg.layer_norm_first:
            x = self.encoder.layer_norm(x)
        for blk in self.encoder.layers:
            x = blk(x, generator)
        if cfg.layer_norm_first:
            x = self.encoder.layer_norm(x)
        return x

    def forward(self, audio, mask, tau: float = 2.0,
                uniform: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """(c, q (B, T, codevector_dim) fp32, perplexity). ``uniform`` runs
        the Gumbel noise, ``generator`` the dropout."""
        z = self.features(audio)
        q, perplexity = self.quantizer(z, tau, uniform)
        q = self.project_q(q)
        c = self.contextualize(z, mask, generator)
        c = self.final_proj(c.to(self.final_proj.dtype))
        return c, q, perplexity


def n_frames(cfg: Wav2Vec2Config, t: int) -> int:
    """The feature encoder's frames for ``t`` samples."""
    for _, k, s in cfg.conv_layers:
        t = (t - k) // s + 1
    return t


def sample_spans_mask(rng: np.random.Generator, b: int, t: int,
                      mask_prob: float, span: int) -> np.ndarray:
    """Span masking on the host (the reference's compute_mask_indices)."""
    mask = np.zeros((b, t), bool)
    n_spans = max(1, int(mask_prob * t / span))
    for i in range(b):
        starts = rng.choice(max(t - span, 1), size=n_spans, replace=False)
        for s in starts:
            mask[i, s:s + span] = True
    return mask


@dataclass
class Wav2Vec2Task:
    """Pretraining. A batch holds ``audio`` (B, T) fp32 and ``mask`` (B,
    frames) bool."""

    cfg: Wav2Vec2Config = Wav2Vec2Config()
    dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Wav2Vec2:
        model = Wav2Vec2(self.cfg, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def n_negatives(self, t: int) -> int:
        return min(self.cfg.n_negatives, t - 1)

    def draws(self, generator: torch.Generator, b: int, t: int,
              device) -> dict[str, torch.Tensor]:
        """The step's random draws: ``uniform`` (B, T, groups, entries) in
        [1e-6, 1 - 1e-6) for the Gumbel noise and ``negatives`` (B, T, K)
        in [0, T - 1), on ``device``, from a generator seeded from
        ``generator``."""
        cfg = self.cfg
        g = torch.Generator(device=device)
        g.manual_seed(int(torch.randint(0, 2**62, (1,), generator=generator)))
        u = draw_rows(lambda rows: torch.rand(
            (rows, t, cfg.n_groups, cfg.n_entries), generator=g,
            device=device), b)
        return {"uniform": u * (1.0 - 2e-6) + 1e-6,
                "negatives": draw_rows(lambda rows: torch.randint(
                    0, t - 1, (rows, t, self.n_negatives(t)), generator=g,
                    device=device), b)}

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        """InfoNCE over the masked frames against K other frames of the same
        utterance, plus ``diversity_weight`` x the codebook diversity."""
        cfg = self.cfg
        audio, mask = batch["audio"], batch["mask"]
        b, t = mask.shape
        d = self.draws(generator, b, t, audio.device)
        c, q, perplexity = model(audio, mask, uniform=d["uniform"],
                                 generator=generator)
        pos = torch.arange(t, device=audio.device)[None, :, None]
        neg_idx = d["negatives"]
        neg_idx = torch.where(neg_idx >= pos, neg_idx + 1, neg_idx)
        negs = q[torch.arange(b, device=q.device)[:, None, None], neg_idx]

        def unit(x):
            return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)

        cn, qn = unit(c), unit(q)
        pos_sim = (cn * qn).sum(-1) / cfg.temperature
        neg_sim = torch.einsum("btd,btkd->btk", cn, unit(negs)) / cfg.temperature
        logits = torch.cat([pos_sim[..., None], neg_sim], -1)
        ce = torch.logsumexp(logits, -1) - logits[..., 0]
        m = mask.float()
        contrastive = data_mean((ce * m).sum(), m.sum())
        diversity = ((cfg.n_entries - perplexity) / cfg.n_entries).mean()
        loss = contrastive + cfg.diversity_weight * diversity
        return loss, (model_state, {"contrastive": contrastive.detach(),
                                    "diversity": diversity.detach()})


class Wav2Vec2ForCTC(nn.Module):
    """The fine-tuning model: ``w2v`` (features and context network) and an
    fp32 linear ``head`` to the CTC vocabulary; log-probabilities out."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 vocab_size: int = 32, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.w2v = Wav2Vec2(cfg, dtype, pretraining=False)
        self.head = Dense(cfg.d_model, vocab_size, acc_dtype(dtype))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        self.w2v.init_weights_(generator)
        self.head.init_(generator)

    def forward(self, audio, mask=None, generator=None):
        z = self.w2v.features(audio)
        if mask is None:
            mask = torch.zeros(z.shape[:2], dtype=torch.bool, device=z.device)
        x = self.w2v.contextualize(z, mask, generator)
        return F.log_softmax(self.head(x.to(self.head.dtype)), -1)


@dataclass
class Wav2Vec2CtcTask:
    """Fine-tuning. A batch holds ``audio`` (B, T), ``frame_paddings`` (B,
    frames), ``labels`` (B, L) and ``label_paddings`` (B, L), paddings 1 at
    the pads. Frames are time-masked at ``mask_prob`` while training."""

    cfg: Wav2Vec2Config = Wav2Vec2Config()
    vocab_size: int = 32
    dtype: torch.dtype = torch.bfloat16
    mask_prob: float = 0.05

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> Wav2Vec2ForCTC:
        model = Wav2Vec2ForCTC(self.cfg, self.vocab_size, self.dtype)
        model.init_weights_(generator)
        return model.to(device).train()

    def draws(self, generator: torch.Generator, b: int, frames: int,
              device) -> torch.Tensor:
        """The time mask (B, frames) bool, each frame masked at
        ``mask_prob``."""
        g = torch.Generator(device=device)
        g.manual_seed(int(torch.randint(0, 2**62, (1,), generator=generator)))
        return draw_rows(lambda rows: torch.rand(
            (rows, frames), generator=g, device=device), b) < self.mask_prob

    def loss_fn(self, model: nn.Module, model_state, batch: dict,
                generator: torch.Generator):
        audio = batch["audio"]
        mask = self.draws(generator, audio.shape[0],
                          batch["frame_paddings"].shape[1], audio.device)
        logp = model(audio, mask, generator)
        loss = ctc_loss(logp, batch["frame_paddings"], batch["labels"],
                        batch["label_paddings"]).mean()
        return loss, (model_state, {})
