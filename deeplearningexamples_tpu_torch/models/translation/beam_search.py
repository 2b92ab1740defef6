"""Beam search: length-normalised, with EOS handling, plain and KV-cached.

Port of ``deeplearningexamples_tpu/models/translation/beam_search.py`` (the
role of fairseq's ``SequenceGenerator`` in the reference Transformer, GNMT
and BART recipes). JAX runs the steps in a ``lax.fori_loop``; here the loop
runs on the host and every tensor stays on the decoder's device. The
semantics are JAX's:

- only beam 0 is live at the start (the others score ``NEG``);
- padded vocab columns (at or past ``vocab_size``) are masked to ``NEG``,
  and a finished beam continues only with ``pad``, at no cost;
- the ``beam_size`` best candidates of each row are taken as ``lax.top_k``
  takes them, the lower flat index first on ties (a stable sort: in fp32
  ``NEG + logp`` has an ulp of 64, so candidates that carry ``NEG`` tie);
- final scores are divided by ``((5 + len) / 6) ** length_penalty``, and
  the beams are ordered best first by a stable sort, as ``jnp.argsort``.

``beam_search_cached`` steps ``model.decode_step`` one token at a time over
a KV cache (``model.init_cache``) and gathers every cache tensor along its
first (B * beam) dim when beams reorder; the position is the loop's own.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NEG", "beam_search", "beam_search_cached"]

NEG = -1e9


def _initial(batch_size: int, beam_size: int, max_len: int, bos_id: int,
             pad_id: int, device):
    bb = batch_size * beam_size
    seqs = torch.full((bb, max_len), pad_id, dtype=torch.int64, device=device)
    seqs[:, 0] = bos_id
    scores = torch.tensor([0.0] + [NEG] * (beam_size - 1), dtype=torch.float32,
                          device=device).repeat(batch_size)
    finished = torch.zeros(bb, dtype=torch.bool, device=device)
    return seqs, scores, finished


def _step(t: int, logits: torch.Tensor, seqs, scores, finished,
          batch_size: int, beam_size: int, eos_id: int, pad_id: int,
          vocab_size: int | None):
    """One step from the (bb, V) logits of position ``t - 1``: the new
    (seqs, scores, finished) and ``flat_src``, the row each beam came from."""
    logp = torch.log_softmax(logits.float(), -1)
    v = logp.shape[-1]
    cols = torch.arange(v, device=logp.device)[None, :]
    if vocab_size is not None and vocab_size < v:
        logp = torch.where(cols < vocab_size, logp, NEG)
    cont = torch.where(finished[:, None], NEG, logp)
    cont = torch.where(finished[:, None] & (cols == pad_id), 0.0, cont)
    cand = (scores[:, None] + cont).reshape(batch_size, beam_size * v)
    top_scores, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :beam_size], top_idx[:, :beam_size]
    beam_src = top_idx // v
    token = (top_idx % v).reshape(-1)
    flat_src = (beam_src + torch.arange(batch_size, device=cand.device)[:, None]
                * beam_size).reshape(-1)
    seqs = seqs[flat_src]
    seqs[:, t] = token
    finished = finished[flat_src] | (token == eos_id)
    return seqs, top_scores.reshape(-1), finished, flat_src


def _finish(seqs, scores, batch_size: int, beam_size: int, pad_id: int,
            length_penalty: float):
    lengths = (seqs != pad_id).sum(1).to(torch.float32)
    norm = ((5.0 + lengths) / 6.0) ** length_penalty
    final = (scores / norm).reshape(batch_size, beam_size)
    order = torch.argsort(-final, dim=1, stable=True)
    seqs = seqs.reshape(batch_size, beam_size, -1)
    seqs = seqs.gather(1, order[:, :, None].expand_as(seqs))
    return seqs, final.gather(1, order)


@torch.no_grad()
def beam_search(
    decode_logits: Callable[[torch.Tensor], torch.Tensor],
    batch_size: int,
    beam_size: int = 4,
    max_len: int = 64,
    bos_id: int = 0,
    eos_id: int = 2,
    pad_id: int = 1,
    length_penalty: float = 0.6,
    vocab_size: int | None = None,
    device: torch.device | str = "cuda",
):
    """``decode_logits(tgt_ids (B*beam, L)) -> (B*beam, L, V)``: the full-
    prefix causal decoder (the encoder memory closed over, tiled to
    B*beam), re-run at every step. Returns (sequences (B, beam, L) int64,
    scores (B, beam) fp32), best first, on ``device``."""
    seqs, scores, finished = _initial(batch_size, beam_size, max_len, bos_id,
                                      pad_id, device)
    for t in range(1, max_len):
        logits = decode_logits(seqs)[:, t - 1]
        seqs, scores, finished, _ = _step(t, logits, seqs, scores, finished,
                                          batch_size, beam_size, eos_id,
                                          pad_id, vocab_size)
    return _finish(seqs, scores, batch_size, beam_size, pad_id, length_penalty)


@torch.no_grad()
def beam_search_cached(
    model,
    memory: torch.Tensor,  # (B*beam, S, D), the encoder output tiled
    memory_mask: torch.Tensor,
    batch_size: int,
    beam_size: int = 4,
    max_len: int = 64,
    bos_id: int = 0,
    eos_id: int = 2,
    pad_id: int = 1,
    length_penalty: float = 0.6,
    vocab_size: int | None = None,
):
    """KV-cached beam search over ``model.decode_step``: one token of
    decoder work a step instead of ``beam_search``'s whole prefix. Raises
    when ``max_len`` exceeds the cache's ``model.cfg.max_len`` slots.
    Returns what ``beam_search`` returns, on ``memory``'s device."""
    if max_len > model.cfg.max_len:
        raise ValueError(
            f"max_len={max_len} exceeds the model's KV-cache capacity "
            f"(cfg.max_len={model.cfg.max_len})")
    device = memory.device
    seqs, scores, finished = _initial(batch_size, beam_size, max_len, bos_id,
                                      pad_id, device)
    cache = model.init_cache(batch_size * beam_size, device)
    for t in range(1, max_len):
        logits = model.decode_step(seqs[:, t - 1], t - 1, memory, memory_mask,
                                   cache)
        seqs, scores, finished, flat_src = _step(
            t, logits, seqs, scores, finished, batch_size, beam_size, eos_id,
            pad_id, vocab_size)
        for name, x in cache.items():  # follow the surviving beams
            cache[name] = x[flat_src]
    return _finish(seqs, scores, batch_size, beam_size, pad_id, length_penalty)
