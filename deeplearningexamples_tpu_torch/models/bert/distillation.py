"""Port of ``deeplearningexamples_tpu/models/bert/distillation.py``: BERT
knowledge distillation.

Covers the reference's distillation suite
(``PyTorch/LanguageModeling/BERT/distillation/{general_distill.py,
task_distill.py,hooks.py}`` + the 4L/6L student configs): a student BERT
trained against a frozen teacher with

- hidden-state MSE over a layer mapping (student layer i <- teacher layer
  (i + 1) * (T / S) - 1), through a learned projection (``distill_proj``)
  when the widths differ. The teacher runs without dropout, the student
  with it.
- no attention-map loss: with flash attention the scores are never
  materialised, so the hidden losses carry the signal (per TinyBERT's
  ablations these dominate)
- task distillation: soft cross-entropy against the teacher's softened
  distribution at a temperature, times T^2, plus the hard-label CE

Each ``BertLayer``'s output is read through a forward hook on the port's
``BertModel`` (JAX's ``capture_intermediates``). The ``4l-312`` student has
312 / 12 = 26 per head, which K1/K2 run at tile width 32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .modeling import BertConfig, BertModel
from .task import init_bert_weights_

__all__ = ["DistillationStudent", "DistillationTask", "STUDENT_CONFIGS"]

STUDENT_CONFIGS = {
    # reference ships 4-layer-312 and 6-layer-768 students
    "4l-312": BertConfig(hidden_size=312, num_layers=4, num_heads=12,
                         intermediate_size=1200),
    "6l-768": BertConfig(hidden_size=768, num_layers=6, num_heads=12,
                         intermediate_size=3072),
}


class DistillationStudent(nn.Module):
    """The student encoder (``bert``) and, when its width differs from the
    teacher's, the (student width, teacher width) projection that maps its
    hidden states onto the teacher's (JAX's ``distill_proj``, applied as
    ``h @ distill_proj``)."""

    def __init__(self, cfg: BertConfig, teacher_width: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.bert = BertModel(cfg, dtype)
        self.distill_proj = (
            nn.Parameter(torch.zeros(cfg.hidden_size, teacher_width))
            if cfg.hidden_size != teacher_width else None)


def layer_outputs(model: BertModel, batch: dict,
                  generator: torch.Generator | None = None) -> dict[int, torch.Tensor]:
    """{i: the output of ``model``'s encoder layer i} for one forward of
    ``batch`` (dropout drawn from ``generator``, none without one)."""
    out: dict[int, torch.Tensor] = {}
    hooks = [layer.register_forward_hook(
        lambda _m, _a, y, i=i: out.__setitem__(i, y))
        for i, layer in enumerate(model.encoder.layer)]
    try:
        model(batch["input_ids"], batch["attention_mask"],
              batch["token_type_ids"], generator=generator)
    finally:
        for h in hooks:
            h.remove()
    return out


@dataclass
class DistillationTask:
    teacher_cfg: BertConfig
    student_cfg: BertConfig
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        t, s = self.teacher_cfg.num_layers, self.student_cfg.num_layers
        if t % s:
            raise ValueError("teacher layers must be a multiple of student's")
        self.layer_map = [(i, (i + 1) * (t // s) - 1) for i in range(s)]

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> DistillationStudent:
        """A student with fresh fp32 weights drawn on the CPU from
        ``generator`` (the JAX initialisers; the projection normal(0.02)),
        placed on ``device``."""
        student = DistillationStudent(self.student_cfg,
                                      self.teacher_cfg.hidden_size, self.dtype)
        init_bert_weights_(student.bert, generator,
                           self.student_cfg.initializer_range)
        if student.distill_proj is not None:
            with torch.no_grad():
                student.distill_proj.normal_(0.0, 0.02, generator=generator)
        return student.to(device)

    def teacher(self, device: torch.device | str = "cuda") -> BertModel:
        """An untrained teacher encoder in this task's precision; the caller
        loads its weights. It is frozen: its parameters take no gradient."""
        model = BertModel(self.teacher_cfg, self.dtype).to(device)
        return model.requires_grad_(False).eval()

    def loss_fn(self, teacher: BertModel):
        """``loss_fn(student, model_state, batch, generator)`` for
        ``make_train_step``: the mean over the layer map of each mapped pair's
        hidden MSE (in fp32, the student's through ``distill_proj``)."""

        def fn(student: DistillationStudent, model_state, batch: dict,
               generator: torch.Generator):
            with torch.no_grad():
                t_h = layer_outputs(teacher, batch)
            s_h = layer_outputs(student.bert, batch, generator)
            proj = student.distill_proj
            loss = 0.0
            for si, ti in self.layer_map:
                s = s_h[si].float()
                if proj is not None:
                    s = s @ proj.float()
                loss = loss + torch.mean((s - t_h[ti].float()) ** 2)
            loss = loss / len(self.layer_map)
            return loss, (model_state, {"hidden_mse": loss.detach()})

        return fn

    @staticmethod
    def task_distill_loss(student_logits, teacher_logits, labels,
                          temperature: float = 1.0, alpha: float = 0.5):
        """Soft + hard loss (reference ``task_distill.py``): the mean
        cross-entropy of the student's softened logits against the teacher's
        softened distribution, times T^2, weighted by ``alpha``, plus the
        hard-label cross-entropy weighted by ``1 - alpha``."""
        t = temperature
        soft_targets = torch.softmax(teacher_logits / t, dim=-1)
        soft = torch.mean(-(soft_targets * torch.log_softmax(
            student_logits / t, dim=-1)).sum(-1)) * (t * t)
        hard = F.cross_entropy(student_logits, labels.long())
        return alpha * soft + (1 - alpha) * hard
