"""BERT tasks of the port: pretraining (MLM + NSP) and SQuAD.

Port of ``BertPretrainTask`` and ``BertSquadTask`` in
``deeplearningexamples_tpu/models/bert/task.py``. The losses are the
reference's: for pretraining, cross-entropy over the masked positions plus
the NSP cross-entropy (the MLM mean over the global batch's masked positions
under a data axis, ``parallel.mesh.data_mean``); for SQuAD fine-tuning, the mean of the start and end
cross-entropies with the positions clipped to the sequence.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import data_mean
from .modeling import BertConfig, BertForPreTraining, BertForQuestionAnswering

__all__ = ["BertPretrainTask", "BertSquadTask", "init_bert_weights_",
           "masked_positions"]


@torch.no_grad()
def init_bert_weights_(model: nn.Module, generator: torch.Generator,
                       std: float) -> None:
    """The JAX initialisers: normal(std) dense kernels and embeddings, zero
    biases, LayerNorm ones and zeros. Draws from ``generator`` in module
    order, so one seed gives one set of weights on any device."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, std, generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


@dataclass
class BertSquadTask:
    cfg: BertConfig
    dtype: torch.dtype = torch.bfloat16  # the encoder's; the QA head is fp32

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> BertForQuestionAnswering:
        """A serving model with fresh weights drawn on the CPU from
        ``generator``, then placed on ``device``."""
        model = BertForQuestionAnswering(self.cfg)
        init_bert_weights_(model, generator, self.cfg.initializer_range)
        return self.place(model, device)

    def init_train(self, generator: torch.Generator,
                   device: torch.device | str = "cuda") -> BertForQuestionAnswering:
        """A model to fine-tune: fresh fp32 weights drawn on the CPU from
        ``generator`` (the JAX initialisers), computing in ``dtype``, placed
        on ``device`` in training mode."""
        model = BertForQuestionAnswering(self.cfg, self.dtype)
        init_bert_weights_(model, generator, self.cfg.initializer_range)
        return model.to(device).train()

    def place(self, model: BertForQuestionAnswering,
              device: torch.device | str) -> BertForQuestionAnswering:
        """Move ``model`` to ``device`` in this task's precision, in eval
        mode: the encoder in ``dtype``, the QA head in fp32."""
        model.bert.to(device=device, dtype=self.dtype)
        model.qa_outputs.to(device=device, dtype=torch.float32)
        return model.eval()

    def loss_fn(self, model: BertForQuestionAnswering, model_state,
                batch: dict, generator: torch.Generator):
        """``(loss, (model_state, {}))``: ``0.5 * (CE(start) + CE(end))`` on
        the fp32 logits, positions clipped to [0, S - 1], with dropout drawn
        from ``generator``."""
        start_logits, end_logits = model(
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], generator=generator)
        last = start_logits.shape[-1] - 1
        start = batch["start_positions"].long().clamp(0, last)
        end = batch["end_positions"].long().clamp(0, last)
        loss = 0.5 * (F.cross_entropy(start_logits, start)
                      + F.cross_entropy(end_logits, end))
        return loss, (model_state, {})

    @torch.inference_mode()
    def predict_fn(self, model: BertForQuestionAnswering, batch: dict):
        """(start_logits, end_logits), fp32, without dropout, for a batch of
        tensors on the model's device (a serving or a training model)."""
        return model(batch["input_ids"], batch["attention_mask"],
                     batch["token_type_ids"])


def masked_positions(labels: torch.Tensor, k: int):
    """JAX ``jax.lax.top_k(labels >= 0, k)``: ``(weights, positions)``, the
    masked positions first in ascending order, then unmasked ones (weight 0).
    ``top_k`` breaks ties toward lower indices, which ``torch.topk`` does not
    promise; a stable descending sort does."""
    is_masked = (labels >= 0).to(torch.int32)
    weights, positions = torch.sort(is_masked, dim=1, descending=True,
                                    stable=True)
    return weights[:, :k], positions[:, :k]


@dataclass
class BertPretrainTask:
    cfg: BertConfig
    dtype: torch.dtype = torch.bfloat16  # compute; parameters stay fp32
    max_predictions: int = 20  # dense-sequence-output width (76 for seq512)

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cuda") -> BertForPreTraining:
        """A model with fresh fp32 weights drawn on the CPU from
        ``generator`` (the JAX initialisers), then placed on ``device``."""
        model = BertForPreTraining(self.cfg, self.dtype)
        init_bert_weights_(model, generator, self.cfg.initializer_range)
        return model.to(device)

    def loss_fn(self, model: BertForPreTraining, model_state, batch: dict,
                generator: torch.Generator):
        """``(loss, (model_state, {"mlm_loss", "nsp_loss"}))`` with dropout
        drawn from ``generator``; ``batch`` holds tensors on the model's
        device."""
        labels = batch["mlm_labels"]
        k = min(self.max_predictions, labels.shape[-1])
        weights, positions = masked_positions(labels, k)
        gathered = labels.gather(1, positions)
        mlm_logits, nsp_logits = model(
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], masked_positions=positions,
            generator=generator)
        safe = torch.where(weights > 0, gathered, 0).long()
        ce = F.cross_entropy(mlm_logits.float().flatten(0, 1), safe.flatten(),
                             reduction="none").view_as(weights)
        w = weights.float()
        # over the global batch's masked positions (JAX's denominator)
        mlm = data_mean((ce * w).sum(), w.sum())
        nsp = F.cross_entropy(nsp_logits, batch["nsp_label"].long())
        return mlm + nsp, (model_state, {"mlm_loss": mlm, "nsp_loss": nsp})

    @torch.no_grad()
    def metric_fn(self, model: BertForPreTraining, model_state, batch: dict):
        """MLM accuracy over the labelled positions and NSP accuracy, without
        dropout. Under a data axis the MLM accuracy is this rank's share of
        the global one (``data_mean``), which the eval loop's mean over the
        data axis sums."""
        mlm_logits, nsp_logits = model(batch["input_ids"],
                                       batch["attention_mask"],
                                       batch["token_type_ids"])
        labels = batch["mlm_labels"]
        valid = labels >= 0
        pred = mlm_logits.argmax(-1)
        acc = data_mean(((pred == labels) & valid).sum(), valid.sum())
        nsp = (nsp_logits.argmax(-1) == batch["nsp_label"]).float().mean()
        return {"mlm_acc": acc, "nsp_acc": nsp}
