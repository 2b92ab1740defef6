"""Port parity: the nine serving recipes added to
``deeplearningexamples_tpu_torch/serving/recipes.py`` answer the same
numpy requests as JAX's endpoints.

Each family runs at a small width with JAX's parameters drawn in numpy for
its own shapes and carried into the port by the bridge. Both endpoints
serve the same requests through their batchers (buckets of 2, so one JAX
compile an endpoint; JAX compiled with XLA's quick code generation at
"highest" precision), and each test first holds the wire contract equal:
``name``, ``input_spec`` (names, shapes, dtype strings), ``output_names``
and the default buckets.

Tolerances, relative to the largest entry of JAX's output: integer outputs
(tokens, labels, valid, masks, the ranking, generated ids) equal; beam
scores 1e-5 relative (the seq2seq tests' ``STOL``); TFT's quantiles, NCF's
scores and the U-Net's probabilities 1e-5 (their families' ``FTOL``); the
detectors' boxes, scores and masks 1e-4 (Mask R-CNN's ``TOL_PREDICT``:
proposals decoded through ``exp`` sit about 1e-5 apart). One NCF request
repeats items, so its scores tie exactly and the stable sort must rank them
by position; the Transformer-XL model's padded vocab columns carry a bias of
100, so a slice after the argmax would emit them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.models import asr as jax_asr
from deeplearningexamples_tpu.models import bart as jax_bart
from deeplearningexamples_tpu.models import efficientdet as jax_det
from deeplearningexamples_tpu.models import maskrcnn as jax_mrcnn
from deeplearningexamples_tpu.models import ncf as jax_ncf
from deeplearningexamples_tpu.models import tft as jax_tft
from deeplearningexamples_tpu.models import transformer_xl as jax_txl
from deeplearningexamples_tpu.models import unet as jax_unet
from deeplearningexamples_tpu.models.translation import gnmt as jax_gnmt
from deeplearningexamples_tpu.serving import recipes as jax_recipes
from deeplearningexamples_tpu_torch.models import (asr, bart, efficientdet,
                                                   maskrcnn, ncf, tft,
                                                   transformer_xl, unet)
from deeplearningexamples_tpu_torch.models.translation import gnmt
from deeplearningexamples_tpu_torch.serving import recipes
from deeplearningexamples_tpu_torch.utils import jax_bridge as bridge
from torch_parity import draw, load, rel
from torch_threads import torch_one_thread  # noqa: F401

STOL = 1e-5
FTOL = 1e-5
DTOL = 1e-4
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _highest():
    """JAX's endpoints compile on their batcher's thread, which a
    ``default_matmul_precision`` context would not reach."""
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", prev)


@pytest.fixture(autouse=True)
def _quick_jit(monkeypatch):
    """JAX's recipes call ``jax.jit`` when built: compile them with XLA's
    quick code generation (one call each)."""
    jit = jax.jit
    monkeypatch.setattr(jax, "jit",
                        lambda f, **kw: jit(f, compiler_options=QUICK, **kw))


def _contract(ep) -> tuple:
    return (ep.name, {k: (tuple(s), d) for k, (s, d) in ep.input_spec.items()},
            tuple(ep.output_names), tuple(ep.batcher.buckets))


def _same_contract(jax_ep, port_ep) -> None:
    try:
        assert _contract(port_ep) == _contract(jax_ep)
    finally:
        jax_ep.batcher.close()
        port_ep.batcher.close()


def _serve(ep, reqs: list[dict]) -> list[dict]:
    """Every request submitted at once, so the batcher pads real buckets."""
    try:
        futs = [ep.batcher.submit(r) for r in reqs]
        return [{k: np.asarray(v) for k, v in f.result(timeout=600).items()}
                for f in futs]
    finally:
        ep.batcher.close()


def _both(jax_ep, port_ep, reqs):
    got = _serve(port_ep, reqs)
    want = _serve(jax_ep, reqs)
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w) == set(port_ep.output_names)
        for k in g:
            assert g[k].shape == w[k].shape, k
    return got, want


def _equal(got, want, keys) -> None:
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _close(got, want, keys, tol) -> None:
    for g, w in zip(got, want):
        for k in keys:
            assert rel(g[k], w[k]) <= tol, (k, rel(g[k], w[k]))


# -- the encoder-decoders ----------------------------------------------------

SEQ = dict(vocab_size=200, d_model=64, d_ff=128, num_heads=2,
           encoder_layers=2, decoder_layers=2, dropout=0.0, max_len=24)
GNMT = dict(vocab_size=200, hidden_size=32, num_layers=4, dropout=0.0)


def _sources(n: int, width: int, pad: int, lengths) -> list[dict]:
    rng = np.random.default_rng(n)
    out = []
    for k in lengths:
        src = np.full((width,), pad, np.int32)
        src[:k] = rng.integers(4, 200, k)
        out.append({"src": src})
    return out


def test_bart_endpoint_matches_jax():
    """Beam 2 over the KV cache, 8 target positions: tokens equal, scores
    to 1e-5; a source of the whole ``max_len`` and a short one."""
    cfg = jax_bart.BartConfig(**SEQ)
    task = jax_bart.BartTask(cfg, jnp.float32)
    params = draw(jax.eval_shape(lambda: task.init(jax.random.key(0))[0]), 2)
    model = load(bart.BartModel(bart.BartConfig(**SEQ), torch.float32),
                 bridge.bart_state_dict_from_jax(params))
    _same_contract(jax_recipes.bart_endpoint(task.model, params, cfg),
                   recipes.bart_endpoint(model, model.cfg))
    kw = dict(beam_size=2, max_target_len=8, batch_buckets=(2,))
    reqs = _sources(1, cfg.max_len, cfg.pad_id, (24, 5, 11))
    got, want = _both(jax_recipes.bart_endpoint(task.model, params, cfg, **kw),
                      recipes.bart_endpoint(model, model.cfg, **kw), reqs)
    _equal(got, want, ["tokens"])
    _close(got, want, ["scores"], STOL)
    assert got[0]["tokens"].dtype == np.int32
    assert all(g["tokens"][0] == cfg.bos_id for g in got)


def test_gnmt_endpoint_matches_jax():
    """The full-prefix beam search on the model's device (the CPU here)."""
    cfg = jax_gnmt.GnmtConfig(**GNMT)
    task = jax_gnmt.GnmtTask(cfg, jnp.float32)
    params = draw(jax.eval_shape(lambda: task.init(jax.random.key(0))[0]), 3)
    ptask = gnmt.GnmtTask(gnmt.GnmtConfig(**GNMT), torch.float32)
    model = load(gnmt.Gnmt(ptask.cfg, torch.float32),
                 bridge.gnmt_state_dict_from_jax(params))
    _same_contract(jax_recipes.gnmt_endpoint(task, params),
                   recipes.gnmt_endpoint(ptask, model))
    kw = dict(beam_size=2, max_len=10, max_target_len=8, batch_buckets=(2,))
    reqs = _sources(2, 10, cfg.pad_id, (10, 4, 7))
    got, want = _both(jax_recipes.gnmt_endpoint(task, params, **kw),
                      recipes.gnmt_endpoint(ptask, model, **kw), reqs)
    _equal(got, want, ["tokens"])
    _close(got, want, ["scores"], STOL)
    assert all(((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()
               for g in got)


# -- TFT, NCF, the U-Net, Transformer-XL ---------------------------------------


def test_tft_endpoint_matches_jax():
    kw = dict(hidden=16, n_heads=2, encoder_len=12, horizon=4, dropout=0.0)
    task = jax_tft.TFTTask(jax_tft.TFTConfig(**kw))
    params = draw(jax.eval_shape(lambda: task.init(jax.random.key(0))[0]), 4)
    ptask = tft.TFTTask(tft.TFTConfig(**kw), torch.float32)
    model = load(tft.TFT(ptask.cfg, torch.float32),
                 bridge.tft_state_dict_from_jax(params))
    _same_contract(jax_recipes.tft_endpoint(task, params),
                   recipes.tft_endpoint(ptask, model))
    rng = np.random.default_rng(5)
    reqs = [{"observed": rng.normal(size=(12, 4)).astype(np.float32),
             "known": rng.normal(size=(16, 2)).astype(np.float32)}
            for _ in range(3)]
    got, want = _both(jax_recipes.tft_endpoint(task, params,
                                               batch_buckets=(2,)),
                      recipes.tft_endpoint(ptask, model, batch_buckets=(2,)),
                      reqs)
    _close(got, want, ["quantiles"], FTOL)


def test_ncf_endpoint_matches_jax_with_tied_scores():
    """The third request repeats items: equal scores, which the stable sort
    ranks by position, as ``jnp.argsort``."""
    kw = dict(nb_users=50, nb_items=40, mf_dim=8,
              mlp_layer_sizes=(16, 16, 8, 4), dropout=0.0)
    task = jax_ncf.NcfTask(jax_ncf.NcfConfig(**kw), jnp.float32)
    params = draw(jax.eval_shape(lambda: task.init(jax.random.key(0)))[0], 6)
    ptask = ncf.NcfTask(ncf.NcfConfig(**kw), torch.float32)
    model = load(ncf.NeuMF(ptask.cfg, torch.float32),
                 bridge.ncf_state_dict_from_jax(params))
    _same_contract(jax_recipes.ncf_endpoint(task, params),
                   recipes.ncf_endpoint(ptask, model))
    rng = np.random.default_rng(7)
    reqs = [{"user": np.array([u], np.int32),
             "items": rng.integers(0, 40, 10).astype(np.int32)}
            for u in (3, 17)]
    reqs.append({"user": np.array([9], np.int32),
                 "items": np.array([5, 2, 5, 8, 2, 5, 11, 8, 2, 5], np.int32)})
    ek = dict(n_candidates=10, batch_buckets=(2,))
    got, want = _both(jax_recipes.ncf_endpoint(task, params, **ek),
                      recipes.ncf_endpoint(ptask, model, **ek), reqs)
    _equal(got, want, ["ranking"])
    _close(got, want, ["scores"], FTOL)
    tied = got[2]
    s, order = tied["scores"], tied["ranking"]
    assert (np.diff(s[order]) <= 0).all()
    for item in (5, 2, 8):  # each item's copies, in their positions' order
        pos = [p for p in order if reqs[2]["items"][p] == item]
        assert pos == sorted(pos)


@pytest.mark.parametrize("rank", [2, 3])
def test_unet_endpoint_matches_jax(rank):
    kw = dict(spatial_rank=rank, in_channels=2, n_classes=3, base_filters=8,
              depth=2, deep_supervision=False)
    patch = 16 if rank == 2 else 8
    task = jax_unet.UNetTask(jax_unet.UNetConfig(**kw), jnp.float32)
    params = draw(jax.eval_shape(
        lambda: task.init(jax.random.key(0), patch=patch)[0]), 8)
    ptask = unet.UNetTask(unet.UNetConfig(**kw), torch.float32)
    model = load(unet.DynUNet(ptask.cfg, torch.float32),
                 bridge.dynunet_state_dict_from_jax(params))
    _same_contract(jax_recipes.unet_endpoint(task, params),
                   recipes.unet_endpoint(ptask, model))
    rng = np.random.default_rng(9)
    reqs = [{"image": rng.normal(size=(patch,) * rank + (2,)).astype(
        np.float32)} for _ in range(3)]
    ek = dict(patch=patch, batch_buckets=(2,))
    got, want = _both(jax_recipes.unet_endpoint(task, params, **ek),
                      recipes.unet_endpoint(ptask, model, **ek), reqs)
    _equal(got, want, ["mask"])
    _close(got, want, ["probs"], FTOL)
    assert got[0]["mask"].dtype == np.int32


def test_transformer_xl_endpoint_matches_jax_and_never_emits_padding():
    kw = dict(vocab_size=100, d_model=16, n_heads=2, d_head=8, d_ff=32,
              n_layers=2, seg_len=12, mem_len=12, dropout=0.0)
    task = jax_txl.TransformerXLTask(jax_txl.TransformerXLConfig(**kw),
                                     jnp.float32)
    params = draw(jax.eval_shape(lambda: task.init(jax.random.key(0)))[0], 10)
    bias = np.array(params["softmax_bias"])
    bias[kw["vocab_size"]:] = 100.0  # the padded columns would win
    params = {**params, "softmax_bias": bias}
    ptask = transformer_xl.TransformerXLTask(
        transformer_xl.TransformerXLConfig(**kw), torch.float32)
    model = load(transformer_xl.TransformerXL(ptask.cfg, torch.float32),
                 bridge.transformer_xl_state_dict_from_jax(params))
    _same_contract(jax_recipes.transformer_xl_generate_endpoint(task, params),
                   recipes.transformer_xl_generate_endpoint(ptask, model))
    rng = np.random.default_rng(11)
    reqs = [{"context": rng.integers(0, 100, 12).astype(np.int32)}
            for _ in range(3)]
    ek = dict(gen_len=6, batch_buckets=(2,))
    got, want = _both(
        jax_recipes.transformer_xl_generate_endpoint(task, params, **ek),
        recipes.transformer_xl_generate_endpoint(ptask, model, **ek), reqs)
    _equal(got, want, ["generated"])
    for g in got:
        assert ((g["generated"] >= 0) & (g["generated"] < 100)).all()


# -- the detectors -------------------------------------------------------------


def test_efficientdet_endpoint_matches_jax():
    kw = dict(image_size=128, fpn_width=16, fpn_depth=1, head_depth=1,
              num_classes=8)
    task = jax_det.EfficientDetTask(jax_det.EfficientDetConfig(**kw),
                                    jnp.float32)
    v = draw(jax.eval_shape(lambda: task.model.init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 3)), train=False)), 12)
    ptask = efficientdet.EfficientDetTask(
        efficientdet.EfficientDetConfig(**kw), torch.float32)
    model = load(efficientdet.EfficientDet(ptask.cfg, torch.float32),
                 bridge.efficientdet_state_dict_from_jax(v["params"],
                                                         v["batch_stats"]))
    _same_contract(
        jax_recipes.efficientdet_endpoint(task, v["params"], v["batch_stats"]),
        recipes.efficientdet_endpoint(ptask, model))
    rng = np.random.default_rng(13)
    reqs = [{"image": rng.normal(size=(128, 128, 3)).astype(np.float32)}
            for _ in range(3)]
    ek = dict(max_out=10, batch_buckets=(2,))
    got, want = _both(
        jax_recipes.efficientdet_endpoint(task, v["params"], v["batch_stats"],
                                          **ek),
        recipes.efficientdet_endpoint(ptask, model, **ek), reqs)
    _equal(got, want, ["labels", "valid"])
    _close(got, want, ["boxes", "scores"], DTOL)
    assert sum(int(g["valid"].sum()) for g in got) > 0
    assert got[0]["labels"].dtype == np.int32


def test_maskrcnn_endpoint_matches_jax():
    kw = dict(backbone="resnet18", image_size=64, num_classes=6, fpn_width=16,
              head_fc_dim=32, rpn_pre_nms_top_n=100, rpn_post_nms_top_n=32)
    task = jax_mrcnn.MaskRCNNTask(jax_mrcnn.MaskRCNNConfig(**kw), jnp.float32)
    v = draw(jax.eval_shape(lambda: task.model.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)), 14)
    ptask = maskrcnn.MaskRCNNTask(maskrcnn.MaskRCNNConfig(**kw), torch.float32)
    model = load(maskrcnn.MaskRCNN(ptask.cfg, torch.float32),
                 bridge.maskrcnn_state_dict_from_jax(v["params"],
                                                     v["batch_stats"]))
    _same_contract(
        jax_recipes.maskrcnn_endpoint(task, v["params"], v["batch_stats"]),
        recipes.maskrcnn_endpoint(ptask, model))
    rng = np.random.default_rng(15)
    reqs = [{"image": rng.normal(size=(64, 64, 3)).astype(np.float32)}
            for _ in range(3)]
    ek = dict(max_out=8, batch_buckets=(2,))
    got, want = _both(
        jax_recipes.maskrcnn_endpoint(task, v["params"], v["batch_stats"],
                                      **ek),
        recipes.maskrcnn_endpoint(ptask, model, **ek), reqs)
    _equal(got, want, ["labels", "valid"])
    _close(got, want, ["boxes", "scores", "masks"], DTOL)
    assert got[0]["masks"].shape == (8, 28, 28)
    assert sum(int(g["valid"].sum()) for g in got) > 0


# -- streaming QuartzNet ---------------------------------------------------------


def test_quartznet_streaming_server_matches_jax():
    """The recipe's server: the port's transcripts and partials equal JAX's
    over two interleaved streams, and ``time_stride`` is the blocks'."""
    blocks = (dict(repeats=1, channels=32, kernel=11, dropout=0.0,
                   residual=False, separable=True, stride=2),
              dict(repeats=2, channels=32, kernel=11, dropout=0.0,
                   separable=True))
    jcfg = jax_asr.JasperConfig(blocks=tuple(jax_asr.JasperBlock(**b)
                                             for b in blocks))
    pcfg = asr.JasperConfig(blocks=tuple(asr.JasperBlock(**b)
                                         for b in blocks))
    task = jax_asr.JasperTask(jcfg, jnp.float32)
    params, state = draw(jax.eval_shape(
        lambda: task.init(jax.random.key(0), 32, 1)), 16)
    ptask = asr.JasperTask(pcfg, torch.float32)
    model = load(asr.Jasper(pcfg, torch.float32),
                 bridge.jasper_state_dict_from_jax(params,
                                                   state["batch_stats"]))
    kw = dict(chunk_frames=32, context_frames=16)
    jsrv = jax_recipes.quartznet_streaming_server(task, params, state, **kw)
    psrv = recipes.quartznet_streaming_server(ptask, model, **kw)
    assert psrv.time_stride == jsrv.time_stride == 2
    assert dataclasses.asdict(psrv.mel_cfg) == dataclasses.asdict(
        jsrv.mel_cfg)
    rng = np.random.default_rng(17)
    audio = {c: rng.normal(size=12000).astype(np.float32) * 0.2 for c in "ab"}
    for i, part in enumerate(np.array_split(np.arange(12000), 3)):
        for c in "ab":
            last = i == 2
            got = psrv.process_chunk(c, audio[c][part], last=last)
            want = jsrv.process_chunk(c, audio[c][part], last=last)
            assert got == want
        assert got["transcript"] or i < 2
    assert psrv.active_streams == 0
