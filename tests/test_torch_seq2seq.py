"""Port parity: the Transformer NMT, beam search (plain and KV-cached),
BART, the summarization data path and ROUGE, and GNMT, in torch against the
JAX package.

The models run at small widths (2+2 layers, d 64, 2 heads of 32, a vocab of
200 padded to 256; GNMT 4 layers of 32), the JAX side in fp32 at "highest"
precision, its Pallas attention in interpret mode, jitted once per function
and shared by the tests; the port in fp32. JAX's parameters are drawn in
numpy for its own shapes (no LayerNorm at 1, no bias at 0, so a wrong name,
transpose or gate order gives the right shapes and wrong numbers) and
carried into the port by the bridge, which also carries JAX's gradients
across. Every dropout rate is 0 on both sides: its bits cannot match
``jax.random``.

The sources are left-padded (0, 2 and 5 pads) and the targets right-padded,
so the encoder's key mask, the Transformer's left-pad positions, BART's
causal-and-masked decoder and its fully masked query rows, and GNMT's
reverse direction over each row's length are all exercised.

Tolerances, relative to the largest entry of the JAX tensor: logits 1e-5;
the loss 1e-5 relative; every gradient within 1e-4 of its own largest entry
and 1e-5 of the largest entry of all (fp32 reads about 1e-6 and 1e-7);
``decode_step`` over a prefix against ``decode`` 1e-5, in each package and
across; beam search sequences equal and scores to 1e-5 relative, cached
against uncached and port against JAX; the noising functions, the
denoising batch, the summarization batches and ROUGE bit for bit (both
sides run the same numpy); the bridges' round trips through JAX's
converters bit for bit.
"""

import functools
import inspect
import json
import math
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.cli import main as jax_cli
from deeplearningexamples_tpu.data import summarization as jax_summ
from deeplearningexamples_tpu.data.tokenization import (
    BertTokenizer as JaxTokenizer,
)
from deeplearningexamples_tpu.models import bart as jax_bart
from deeplearningexamples_tpu.models.translation import (
    beam_search as jax_beam_search,
    beam_search_cached as jax_beam_search_cached,
)
from deeplearningexamples_tpu.models.translation import gnmt as jax_gnmt
from deeplearningexamples_tpu.models.translation import (
    transformer as jax_transformer,
)
from deeplearningexamples_tpu.utils.torch_import import (
    convert_bart,
    convert_gnmt,
    convert_nmt_transformer,
)
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.data import summarization as summ
from deeplearningexamples_tpu_torch.data.tokenization import BertTokenizer
from deeplearningexamples_tpu_torch.models import bart, translation
from deeplearningexamples_tpu_torch.models.translation import (
    beam_search,
    beam_search_cached,
    gnmt,
)
from deeplearningexamples_tpu_torch.models.translation import (
    transformer as tr,
)
from deeplearningexamples_tpu_torch.ops import flash_attention as fa
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bart_state_dict_from_jax,
    gnmt_state_dict_from_jax,
    transformer_state_dict_from_jax,
)

FTOL = 1e-5  # logits, decode_step against decode
LTOL = 1e-5  # a loss, relative
GTOL = (1e-4, 1e-5)  # gradients: of their own largest entry, of all
STOL = 1e-5  # beam scores, relative

SMALL = dict(vocab_size=200, d_model=64, d_ff=128, num_heads=2,
             encoder_layers=2, decoder_layers=2, dropout=0.0, max_len=24)
GNMT_SMALL = dict(vocab_size=200, hidden_size=32, num_layers=4, dropout=0.0)
B, S, T = 3, 10, 9  # batch, source length, target length (BOS ... EOS)
SRC_PADS = (0, 2, 5)
TGT_LENGTHS = (9, 6, 4)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _worst(got: dict, want: dict) -> tuple[tuple, tuple]:
    """The worst (error, name) over each tensor's largest entry and over the
    largest entry of all. A key projection's bias (BART's ``k_proj.bias``)
    moves every score of a query row by the same amount, which the softmax
    cancels: its gradient is 0 but for rounding, and is held to the second
    only."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return (max((_rel(got[n], w), n) for n, w in want.items()
                if not n.endswith("k_proj.bias")),
            max((float(np.abs(np.asarray(got[n], np.float64) - w).max()) / top,
                 n) for n, w in want.items()))


@pytest.fixture(autouse=True)
def _exact_fp32_one_thread():
    """JAX at "highest" precision; torch on one thread: at these sizes its
    work is a few small ops at a time, which a pool of threads shared with
    other test processes on the host waits on far longer than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _draw(shapes, seed: int):
    """Parameters of the JAX model's shapes, drawn in numpy: LayerNorm
    scales 1 + 0.2 N(0, 1), biases 0.1 N(0, 1), every other leaf N(0, 1 /
    fan_in) (tables and vectors N(0, 1 / width))."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name == "scale":
            out = 1.0 + 0.2 * rng.normal(size=x.shape)
        elif name == "bias":
            out = 0.1 * rng.normal(size=x.shape)
        elif name == "g":
            out = np.asarray(0.5 + rng.uniform())
        else:
            fan = x.shape[0] if len(x.shape) == 2 and name == "kernel" else (
                x.shape[-1] if x.shape else 1)
            out = rng.standard_normal(x.shape) / np.sqrt(fan)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return model.train()


def _batch(pad_id: int, bos: int, eos: int, seed: int = 3) -> dict:
    """src (B, S) left-padded by ``SRC_PADS``, tgt (B, T) BOS ... EOS
    right-padded to ``TGT_LENGTHS``; ids in [3, 200)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 200, (B, S)).astype(np.int32)
    for i, n in enumerate(SRC_PADS):
        src[i, :n] = pad_id
    tgt = np.full((B, T), pad_id, np.int32)
    for i, n in enumerate(TGT_LENGTHS):
        tgt[i, 0], tgt[i, n - 1] = bos, eos
        tgt[i, 1:n - 1] = rng.integers(4, 200, n - 2)
    return {"src": src, "tgt": tgt}


def _right_pad(src: np.ndarray, pad_id: int) -> np.ndarray:
    """The same rows with their pads moved behind the tokens."""
    out = np.full_like(src, pad_id)
    for i, row in enumerate(src):
        toks = row[row != pad_id]
        out[i, :len(toks)] = toks
    return out


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(task, model, batch) -> tuple[float, dict]:
    model.zero_grad()
    loss, _ = task.loss_fn(model, {}, _t(batch), torch.Generator())
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


def _params_only(sd: dict, model: torch.nn.Module) -> dict:
    """The bridge's entries for the model's parameters (not its buffers)."""
    names = dict(model.named_parameters())
    return {k: v for k, v in sd.items() if k in names}


# -- the Transformer NMT: the shared JAX side ---------------------------------


@functools.lru_cache(maxsize=None)
def _nmt():
    """(JAX task, params, jitted forward, jitted loss and grad, batch)."""
    task = jax_transformer.TransformerTask(
        jax_transformer.TransformerConfig(**SMALL), jnp.float32)
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0))[0])
    params = _draw(shapes, 1)
    cfg = task.cfg
    batch = _batch(cfg.pad_id, cfg.bos_id, cfg.eos_id)
    fwd = jax.jit(lambda p, s, t: task.model.apply({"params": p}, s, t))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: task.loss_fn(p, {}, b, jax.random.key(0))[0]))
    return task, params, fwd, grad, batch


def _nmt_port(dtype=torch.float32) -> tr.Transformer:
    _, params, *_ = _nmt()
    return _load(tr.Transformer(tr.TransformerConfig(**SMALL), dtype),
                 transformer_state_dict_from_jax(params))


def test_sinusoid_table_and_left_pad_positions_are_jaxs():
    np.testing.assert_array_equal(
        tr.sinusoidal_positions(30, 64, 1),
        jax_transformer.sinusoidal_positions(30, 64, 1))
    src = _nmt()[4]["src"]
    for left in (True, False):
        np.testing.assert_array_equal(
            tr.fairseq_position_ids(torch.from_numpy(src), 1, left).numpy(),
            np.asarray(jax_transformer.fairseq_position_ids(
                jnp.asarray(src), 1, left)))


def test_transformer_logits_and_loss_match_jax():
    """Left-padded sources, right-padded targets: the fp32 logits (over the
    padded vocab) and the label-smoothed loss, whose smoothing term runs over
    all 256 columns."""
    task, params, fwd, grad, batch = _nmt()
    want = np.asarray(fwd(params, batch["src"], batch["tgt"][:, :-1]))
    model = _nmt_port()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["src"]),
                    torch.from_numpy(batch["tgt"][:, :-1]))
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, T - 1, 256)
    assert _rel(got, want) <= FTOL
    loss, _ = grad(params, batch)
    port_task = tr.TransformerTask(model.cfg, torch.float32)
    got_loss, _ = port_task.loss_fn(model, {}, _t(batch), torch.Generator())
    assert abs(float(got_loss.detach()) - float(loss)) <= LTOL * abs(float(loss))


def test_transformer_gradients_match_jax():
    _, params, _, grad, batch = _nmt()
    loss, g = grad(params, batch)
    model = _nmt_port()
    got_loss, got = _port_grads(tr.TransformerTask(model.cfg, torch.float32),
                                model, batch)
    want = transformer_state_dict_from_jax(g)
    assert set(got) == set(want)
    (own, n1), (alls, n2) = _worst(got, want)
    assert own <= GTOL[0] and alls <= GTOL[1], (n1, own, n2, alls)
    assert abs(got_loss - float(loss)) <= LTOL * abs(float(loss))


@functools.lru_cache(maxsize=None)
def _jax_encode(which: str):
    """JAX's ``encode`` of the small model, jitted once: (task, params,
    src, memory, mask) for the test batch's sources."""
    task, params, *_ = _nmt() if which == "transformer" else _bart()
    model, cfg = task.model, task.cfg
    enc = jax.jit(lambda p, s: model.apply({"params": p}, s, method=model.encode))
    src = _batch(cfg.pad_id, cfg.bos_id, cfg.eos_id)["src"]
    memory, mask = enc(params, jnp.asarray(src))
    return task, params, src, memory, mask


def _jax_steps(task, params, memory, mask, tgt):
    """JAX's ``decode_step`` over every position of ``tgt``: (B, T, V)."""
    model = task.model
    step = jax.jit(lambda p, c, tok, pos: model.apply(
        {"params": p, **c}, tok, pos, memory, mask, method=model.decode_step,
        mutable=["cache"]))
    _, cache = model.apply({"params": params}, jnp.asarray(tgt[:, 0]), 0,
                           memory, mask, method=model.decode_step,
                           mutable=["cache"])
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
    out = []
    for t in range(tgt.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(tgt[:, t]), t)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


def _port_steps(model, memory, mask, tgt):
    cache = model.init_cache(tgt.shape[0], "cpu")
    with torch.no_grad():
        return torch.stack([model.decode_step(
            torch.from_numpy(tgt[:, t]), t, memory, mask, cache)
            for t in range(tgt.shape[1])], 1).numpy()


@pytest.mark.parametrize("which", ["transformer", "bart"])
def test_decode_step_over_a_prefix_equals_decode(which):
    """``decode_step`` stepped over a right-padded prefix (the cached
    self-attention in plain ops, the cross-attention at Sq = 1 through the
    flash path) gives ``decode``'s logits at each position, in both
    packages, and the two packages agree."""
    task, params, src, memory, mask = _jax_encode(which)
    fwd = (_nmt() if which == "transformer" else _bart())[2]
    model = _nmt_port() if which == "transformer" else _bart_port()
    cfg = task.cfg
    batch = _batch(cfg.pad_id, cfg.bos_id, cfg.eos_id)
    # the steps run over real tokens only: targets without pads
    tgt = np.where(batch["tgt"] == cfg.pad_id, 5, batch["tgt"])[:, :-1]
    full = np.asarray(fwd(params, src, tgt))  # encode, then decode
    steps = _jax_steps(task, params, memory, mask, tgt)
    assert _rel(steps, full) <= FTOL
    with torch.no_grad():
        pm, pmask = model.encode(torch.from_numpy(src))
        pfull = model.decode(torch.from_numpy(tgt), pm, pmask).numpy()
    psteps = _port_steps(model, pm, pmask, tgt)
    assert _rel(psteps, pfull) <= FTOL
    assert _rel(psteps, steps) <= FTOL and _rel(pfull, full) <= FTOL


# -- beam search ---------------------------------------------------------------

BEAM, MAX_LEN = 3, 8


@functools.lru_cache(maxsize=None)
def _jax_beams(which: str):
    """JAX's ``beam_search`` and ``beam_search_cached`` on the small model's
    encoder output: ((seqs, scores), (seqs, scores))."""
    task, params, src, memory, mask = _jax_encode(which)
    cfg, model = task.cfg, task.model
    mem, msk = jnp.repeat(memory, BEAM, 0), jnp.repeat(mask, BEAM, 0)
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, bos_id=cfg.bos_id,
              eos_id=cfg.eos_id, pad_id=cfg.pad_id, vocab_size=cfg.vocab_size)
    plain = jax_beam_search(
        lambda ids: model.apply({"params": params}, ids, mem, msk,
                                method=model.decode), B, **kw)
    cached = jax_beam_search_cached(model, params, mem, msk, B, **kw)
    return src, tuple((np.asarray(s), np.asarray(f)) for s, f in (plain, cached))


@pytest.mark.parametrize("which", ["transformer", "bart"])
def test_beam_search_plain_and_cached_match_jax(which):
    """Both searches give JAX's sequences bit for bit and its
    length-normalised scores, best first; cached equals uncached."""
    src, (jplain, jcached) = _jax_beams(which)
    model = _nmt_port() if which == "transformer" else _bart_port()
    cfg = model.cfg
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, bos_id=cfg.bos_id,
              eos_id=cfg.eos_id, pad_id=cfg.pad_id, vocab_size=cfg.vocab_size)
    with torch.no_grad():
        memory, mask = model.encode(torch.from_numpy(src))
    mem, msk = memory.repeat_interleave(BEAM, 0), mask.repeat_interleave(BEAM, 0)
    plain = beam_search(lambda ids: model.decode(ids, mem, msk), B,
                        device="cpu", **kw)
    before = fa.launches
    cached = beam_search_cached(model, mem, msk, B, **kw)
    assert fa.launches == before  # the CPU runs the plain versions
    np.testing.assert_array_equal(jplain[0], jcached[0])
    for (seqs, scores), (jseqs, jscores) in ((plain, jplain), (cached, jcached)):
        assert seqs.shape == (B, BEAM, MAX_LEN)
        np.testing.assert_array_equal(seqs.numpy(), jseqs)
        assert _rel(scores, jscores) <= STOL
        assert (np.diff(scores.numpy(), axis=1) <= 0).all()
    np.testing.assert_array_equal(plain[0].numpy(), cached[0].numpy())
    assert _rel(plain[1], cached[1]) <= STOL


def test_beam_search_masks_padded_columns_ties_and_finished_beams():
    """A decoder whose padded column (id 7 of 8, vocab 7) would win, whose
    live tokens tie, and which emits EOS at step 2: JAX's sequences and
    scores bit for bit (lower index first on ties, pad after EOS at no
    cost), and ``max_len`` past the cache raises."""
    v, vocab = 8, 7

    def logits_of(ids, xp):
        t = ids.shape[1]
        base = xp.zeros((ids.shape[0], t, v)) + xp.asarray(
            [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.5, 9.0])
        step2 = xp.asarray([0.0, 0.0, 5.0, 0, 0, 0, 0, 0])
        pos = xp.arange(t)[None, :, None]
        return xp.where(pos == 1, base + step2, base)

    jseqs, jscores = jax_beam_search(lambda ids: logits_of(ids, jnp), 2,
                                     beam_size=3, max_len=6,
                                     vocab_size=vocab)
    seqs, scores = beam_search(
        lambda ids: logits_of(ids, torch).float(), 2, beam_size=3, max_len=6,
        vocab_size=vocab, device="cpu")
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    assert not (seqs == 7).any()
    model = _nmt_port()
    with pytest.raises(ValueError, match="KV-cache capacity"):
        beam_search_cached(model, torch.zeros(3, 4, 64), torch.ones(3, 4), 1,
                           beam_size=3, max_len=model.cfg.max_len + 1)


# -- BART ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bart():
    cfg = jax_bart.BartConfig(**{k: v for k, v in SMALL.items()})
    task = jax_bart.BartTask(cfg, jnp.float32)
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0))[0])
    params = _draw(shapes, 2)
    batch = _batch(cfg.pad_id, cfg.bos_id, cfg.eos_id, seed=4)
    batch["src"] = _right_pad(batch["src"], cfg.pad_id)
    fwd = jax.jit(lambda p, s, t: task.model.apply({"params": p}, s, t))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: task.loss_fn(p, {}, b, jax.random.key(0))[0]))
    return task, params, fwd, grad, batch


def _bart_port(dtype=torch.float32) -> bart.BartModel:
    _, params, *_ = _bart()
    return _load(bart.BartModel(bart.BartConfig(**SMALL), dtype),
                 bart_state_dict_from_jax(params))


def test_bart_logits_loss_and_gradients_match_jax():
    """The decoder is causal and masked by the target's pads (its padded
    query rows see no key and average V uniformly, as in JAX): logits, loss
    and every gradient."""
    task, params, fwd, grad, batch = _bart()
    want = np.asarray(fwd(params, batch["src"], batch["tgt"][:, :-1]))
    model = _bart_port()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["src"]),
                    torch.from_numpy(batch["tgt"][:, :-1]))
    assert _rel(got, want) <= FTOL
    loss, g = grad(params, batch)
    got_loss, got_g = _port_grads(bart.BartTask(model.cfg, torch.float32),
                                  model, batch)
    assert abs(got_loss - float(loss)) <= LTOL * abs(float(loss))
    (own, n1), (alls, n2) = _worst(got_g, bart_state_dict_from_jax(g))
    assert own <= GTOL[0] and alls <= GTOL[1], (n1, own, n2, alls)


def test_noising_and_denoising_batch_are_jaxs_bit_for_bit():
    """``bart_text_infilling``, ``bart_sentence_permute`` and
    ``make_denoising_batch`` under one ``np.random.Generator`` seed."""
    docs = [np.random.default_rng(i).integers(4, 200, n).astype(np.int32)
            for i, n in enumerate((30, 17, 44, 5))]
    for doc in docs:
        doc[::7] = 9  # sentence ends
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        np.testing.assert_array_equal(
            bart.bart_text_infilling(doc, 3, a),
            jax_bart.bart_text_infilling(doc, 3, b))
        np.testing.assert_array_equal(
            bart.bart_sentence_permute(doc, 9, a),
            jax_bart.bart_sentence_permute(doc, 9, b))
    cfg = bart.BartConfig(**SMALL)
    got = bart.BartTask(cfg).make_denoising_batch(
        docs, 24, np.random.default_rng(6))
    want = jax_bart.BartTask(jax_bart.BartConfig(**SMALL)).make_denoising_batch(
        docs, 24, np.random.default_rng(6))
    for k in ("src", "tgt"):
        np.testing.assert_array_equal(got[k], want[k])


# -- the summarization data path and ROUGE --------------------------------------


ROUGE_CASES = [
    ("the cat sat on the mat", "the cat lay on the mat"),
    ("the cat sat on the mat", ""),
    ("a b c d", "a b c d"),
    ("x y z", "p q r"),
    ("a a a b", "a b a b a"),
]


def test_rouge_is_jaxs():
    """``tests/test_summarization.py:14``'s cases and a few more, each score
    equal to JAX's."""
    hyps = [h.split() for h, _ in ROUGE_CASES]
    refs = [r.split() for _, r in ROUGE_CASES]
    for h, r in zip(hyps, refs):
        for n in (1, 2):
            assert summ.rouge_n(h, r, n) == jax_summ.rouge_n(h, r, n)
        assert summ.rouge_l(h, r) == jax_summ.rouge_l(h, r)
    assert summ.rouge_scores(hyps, refs) == jax_summ.rouge_scores(hyps, refs)
    np.testing.assert_allclose(summ.rouge_n(hyps[0], refs[0], 2), 3 / 5,
                               rtol=1e-9)
    np.testing.assert_allclose(summ.rouge_l(hyps[0], refs[0]), 5 / 6, rtol=1e-9)


def test_summarization_dataset_batches_are_jaxs(tmp_path):
    """The synthetic CNN-DM files, the corpus vocab and every batch of the
    shuffled train split and the ordered val split, bit for bit."""
    summ.write_synthetic_summarization(str(tmp_path / "a"), n=16, seed=3)
    jax_summ.write_synthetic_summarization(str(tmp_path / "b"), n=16, seed=3)
    for f in ("train.source", "train.target", "val.source", "val.target"):
        assert (tmp_path / "a" / f).read_text() == (tmp_path / "b" / f).read_text()
    paths = [str(tmp_path / "a" / "train.source"),
             str(tmp_path / "a" / "train.target")]
    vocab = cli_main._corpus_vocab(paths)
    assert vocab == jax_cli._corpus_vocab(paths)
    for split in ("train", "val"):
        got = summ.SummarizationDataset(
            str(tmp_path / "a"), split, BertTokenizer(vocab), 4,
            max_source_len=40, max_target_len=8)
        want = jax_summ.SummarizationDataset(
            str(tmp_path / "a"), split, JaxTokenizer(vocab), 4,
            max_source_len=40, max_target_len=8)
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"src", "tgt", "indices"}
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


# -- GNMT ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gnmt():
    cfg = jax_gnmt.GnmtConfig(**GNMT_SMALL)
    task = jax_gnmt.GnmtTask(cfg, jnp.float32)
    shapes = jax.eval_shape(lambda: task.init(jax.random.key(0))[0])
    params = _draw(shapes, 3)
    batch = _batch(cfg.pad_id, cfg.bos_id, cfg.eos_id, seed=5)
    batch["src"] = _right_pad(batch["src"], cfg.pad_id)
    fwd = jax.jit(lambda p, s, t: task.model.apply({"params": p}, s, t))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: task.loss_fn(p, {}, b, jax.random.key(0))[0]))
    return task, params, fwd, grad, batch


def _gnmt_port(dtype=torch.float32) -> gnmt.Gnmt:
    _, params, *_ = _gnmt()
    return _load(gnmt.Gnmt(gnmt.GnmtConfig(**GNMT_SMALL), dtype),
                 gnmt_state_dict_from_jax(params))


def test_gnmt_logits_loss_and_gradients_match_jax():
    """Right-padded sources of 10, 8 and 5 tokens (the bidirectional layer
    0's reverse direction runs over each row's length), random non-symmetric
    gates: logits, loss and every gradient."""
    task, params, fwd, grad, batch = _gnmt()
    want = np.asarray(fwd(params, batch["src"], batch["tgt"][:, :-1]))
    model = _gnmt_port()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["src"]),
                    torch.from_numpy(batch["tgt"][:, :-1]))
    assert got.dtype == torch.float32 and _rel(got, want) <= FTOL
    loss, g = grad(params, batch)
    got_loss, got_g = _port_grads(gnmt.GnmtTask(model.cfg, torch.float32),
                                  model, batch)
    assert abs(got_loss - float(loss)) <= LTOL * abs(float(loss))
    (own, n1), (alls, n2) = _worst(
        got_g, _params_only(gnmt_state_dict_from_jax(g), model))
    assert own <= GTOL[0] and alls <= GTOL[1], (n1, own, n2, alls)


def test_flip_sequences_is_flaxs():
    from flax.linen.recurrent import flip_sequences

    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    lengths = np.array([5, 2])
    np.testing.assert_array_equal(
        gnmt.flip_sequences(torch.from_numpy(x), torch.from_numpy(lengths)),
        np.asarray(flip_sequences(jnp.asarray(x), jnp.asarray(lengths), 1,
                                  False)))


def test_gnmt_dropout_keeps_its_rate():
    """At dropout 0.2 a training forward differs from the deterministic
    one, and the encoder's input dropout zeroes about 20% of entries."""
    torch.manual_seed(0)
    model = gnmt.Gnmt(gnmt.GnmtConfig(**{**GNMT_SMALL, "dropout": 0.2}),
                      torch.float32)
    x = torch.ones(64, 50, 32)
    kept = model.drop(x, torch.Generator().manual_seed(1))
    share = float((kept == 0).float().mean())
    assert abs(share - 0.2) < 0.01
    assert torch.allclose(kept[kept != 0], torch.tensor(1.25))


# -- the bridges ----------------------------------------------------------------


def _tree_equal(want, got) -> None:
    flat_w = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        np.testing.assert_array_equal(np.asarray(flat_g[k]), np.asarray(w))


@pytest.mark.parametrize("which", ["transformer", "bart", "gnmt"])
def test_weights_round_trip_through_jaxs_converters(which):
    """A JAX tree of JAX's shapes goes through the bridge into the port's
    model (strict names and shapes), and the port's ``state_dict`` through
    JAX's converter gives the same tree back, bit for bit; the parameter
    counts agree."""
    if which == "transformer":
        task, params, *_ = _nmt()
        model = _nmt_port()
        back = lambda sd: convert_nmt_transformer(sd, 2, 2, 256)  # noqa: E731
    elif which == "bart":
        task, params, *_ = _bart()
        model = _bart_port()
        back = lambda sd: convert_bart(sd, 2, 2, 256)  # noqa: E731
    else:
        task, params, *_ = _gnmt()
        model = _gnmt_port()
        back = lambda sd: convert_gnmt(sd, 256, 4)  # noqa: E731
    sd = {k: t.detach().numpy() for k, t in model.state_dict().items()}
    _tree_equal(params, back(sd))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("which", ["transformer", "bart", "gnmt"])
def test_full_width_models_have_jaxs_parameter_count(which):
    """At the CLI's full widths (Transformer-base, bart-large, GNMT), the
    port's parameter count is JAX's (the port's model built without
    storage, on the meta device)."""
    meta = torch.device("meta")
    if which == "transformer":
        jt = jax_transformer.TransformerTask(
            jax_transformer.TransformerConfig(), jnp.float32)
        with meta:
            pt = tr.Transformer(tr.TransformerConfig(), torch.float32)
    elif which == "bart":
        jt = jax_bart.BartTask(jax_bart.BartConfig(), jnp.float32)
        with meta:
            pt = bart.BartModel(bart.BartConfig(), torch.float32)
    else:
        jt = jax_gnmt.GnmtTask(jax_gnmt.GnmtConfig(), jnp.float32)
        with meta:
            pt = gnmt.Gnmt(gnmt.GnmtConfig(), torch.float32)
    shapes = jax.eval_shape(lambda: jt.init(jax.random.key(0))[0])
    assert sum(p.numel() for p in pt.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))


# -- the CLI ---------------------------------------------------------------------


def _raport(path: Path) -> list[dict]:
    return [json.loads(line[len("DLLL "):]) for line in path.read_text().splitlines()
            if line.startswith("DLLL ")]


def _losses(path: Path) -> list[float]:
    return [r["data"]["train.loss"] for r in _raport(path)
            if "train.loss" in r.get("data", {})]


@pytest.fixture
def small_models(monkeypatch):
    """The CLI's Transformer and GNMT at CPU widths (BART's runner builds
    its own small config)."""
    monkeypatch.setattr(translation, "TransformerConfig",
                        functools.partial(tr.TransformerConfig,
                                          **{**SMALL, "vocab_size": 300,
                                             "max_len": 80}))
    monkeypatch.setattr(gnmt, "GnmtTask", functools.partial(
        gnmt.GnmtTask, gnmt.GnmtConfig(**{**GNMT_SMALL, "vocab_size": 300})))


@pytest.mark.parametrize("model", ["transformer", "gnmt", "bart-pretrain",
                                   "bart-summarize"])
def test_cli_trains_on_the_cpu(tmp_path, small_models, model):
    """2 steps at B=4 in bf16 on the CPU (``bart --task summarize`` an epoch
    of the synthetic set, 4 batches, then the beam-decoded val split):
    every loss finite, a checkpoint, no kernel launched; summarize logs
    ``val.rouge1/2/L``."""
    name, _, task = model.partition("-")
    args = [name, "--device", "cpu", "--batch-size", "4", "--steps-per-epoch",
            "2", "--workspace", str(tmp_path), "--lr", "1e-3"]
    if name == "bart":
        args += ["--task", task, "--max-source-len", "32",
                 "--max-target-len", "8", "--beam-size", "2"]
    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    if task == "summarize":
        with mock.patch.object(summ, "write_synthetic_summarization",
                               functools.partial(
                                   summ.write_synthetic_summarization, n=16)):
            state, out = cli(args)
    else:
        state, out = cli(args)
    assert state.model.dtype == torch.bfloat16
    assert (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv) == before
    loss = _losses(tmp_path / f"{name}_raport.json")
    steps = 4 if task == "summarize" else 2
    assert state.step == steps and len(loss) == steps
    assert all(math.isfinite(x) for x in loss)
    assert (tmp_path / f"{name}_ckpt" / f"ckpt_{steps}.pt").exists()
    if task == "summarize":
        assert set(out) == {"val.rouge1", "val.rouge2", "val.rougeL"}
        assert all(0.0 <= v <= 1.0 for v in out.values())
        logged = [r["data"] for r in _raport(tmp_path / "bart_raport.json")
                  if "val.rouge1" in r.get("data", {})]
        assert logged and logged[-1]["val.rougeL"] == pytest.approx(
            out["val.rougeL"])


def test_cli_transformer_batch_is_jaxs(tmp_path, small_models):
    """``transformer``'s one synthetic batch: src (B, 64) and BOS + src[:,
    :62] + EOS drawn as JAX's runner draws them (the loader handed to the
    loop is checked)."""
    seen = {}

    def loop(state, step, it, **kw):
        seen["batch"] = next(iter(it()))
        return state, None

    with mock.patch.object(cli_main, "train_loop", loop):
        cli(["transformer", "--device", "cpu", "--batch-size", "3",
             "--steps-per-epoch", "1", "--workspace", str(tmp_path)])
    rng = np.random.default_rng(0)
    src = rng.integers(3, 300, (3, 64)).astype(np.int32)
    np.testing.assert_array_equal(seen["batch"]["src"].numpy(), src)
    tgt = seen["batch"]["tgt"].numpy()
    assert tgt.shape == (3, 64) and (tgt[:, 0] == 0).all() and (
        tgt[:, -1] == 2).all()
    np.testing.assert_array_equal(tgt[:, 1:63], src[:, :62])


def test_cli_takes_mesh_flags(tmp_path):
    """``--mesh-data`` is ported (``test_torch_parallel_families.py`` runs
    it on two ranks): two data ranks in one process are JAX's mesh error."""
    for name in ("transformer", "bart", "gnmt"):
        with pytest.raises(ValueError, match="!= 1 devices"):
            cli([name, "--device", "cpu", "--mesh-data", "2", "--workspace",
                 str(tmp_path)])


def test_cli_rate_quirk(tmp_path, small_models):
    """ROADMAP Queue 3 quirk 8i, kept on purpose: JAX's ``cfg.lr or 5e-4``
    (``transformer``), ``or 1e-3`` (``bart``, ``gnmt``) never fall back,
    because ``CommonConfig.lr`` is 0.1, so without ``--lr`` all three train
    at 0.1; ``run_transformer`` reads neither ``--resume`` nor
    ``--data-backend``."""
    assert jax_cli.CommonConfig().lr == cli_main.CommonConfig().lr == 0.1
    src = inspect.getsource(jax_cli.run_transformer)
    assert "cfg.lr or 5e-4" in src and "_maybe_resume" not in src \
        and "data_backend" not in src
    assert "cfg.lr or 1e-3" in inspect.getsource(jax_cli.run_bart)
    assert "optax.adam(cfg.lr or 1e-3)" in inspect.getsource(
        jax_cli._breadth_spec)
    rates = []

    def poly(base, *a, **kw):
        rates.append(base)
        return lambda step: 0.0

    def adam(lr, *a, **kw):
        rates.append(lr)
        return cli_main.opt.adamw(lambda step: 0.0, weight_decay=0.0)

    common = ["--device", "cpu", "--batch-size", "2", "--steps-per-epoch", "1",
              "--workspace", str(tmp_path)]
    with mock.patch.object(cli_main, "lr_poly_warmup", poly), \
            mock.patch.object(cli_main.opt, "adam", adam):
        cli(["transformer", *common])
        cli(["gnmt", *common])
        cli(["bart", "--task", "pretrain", "--max-source-len", "16", *common])
    assert rates == [0.1, 0.1, 0.1]
    # a checkpoint at step 1 is there; transformer starts again from step 0
    # with --resume, and takes --data-backend corpus without a word
    assert (tmp_path / "transformer_ckpt" / "ckpt_1.pt").exists()
    state, _ = cli(["transformer", *common, "--resume", "true",
                    "--data-backend", "corpus"])
    assert state.step == 1
