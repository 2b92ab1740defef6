"""Port parity: ``deeplearningexamples_tpu_torch/serving/streaming_asr.py``
(the Kaldi recipe's streaming sessions) on the port's Jasper, in torch
against the JAX package.

``tests/test_streaming_asr.py``'s three cases, run on the port: a small
stride-2 Jasper (64 mels, 12 symbols, blocks of kernel 5, JAX's parameters
drawn in numpy and carried across by the bridge) in eval mode on one thread.

Tolerances: the windowed log-probabilities equal the full-utterance forward
within 1e-4 where a window has its full right context, and within 0.5 in
the flush's last (chunk + context) / stride frames (BN's shift of the
zero-padded tail), as JAX's test holds them; the server's transcript equals
the greedy decode of those windowed log-probabilities exactly, and equals
JAX's server's transcript on JAX's own model exactly; partials are prefixes
of later ones; interleaved streams equal their sequential runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearningexamples_tpu.models import asr as jax_asr
from deeplearningexamples_tpu.serving.streaming_asr import (
    StreamingAsrServer as JaxServer,
)
from deeplearningexamples_tpu_torch.models import asr
from deeplearningexamples_tpu_torch.models.tts.audio import (
    MelConfig,
    mel_spectrogram,
)
from deeplearningexamples_tpu_torch.serving.streaming_asr import (
    StreamingAsrServer,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    jasper_state_dict_from_jax,
)
from torch_parity import draw, jit, load
from torch_threads import torch_one_thread  # noqa: F401

BLOCKS = (dict(repeats=1, channels=32, kernel=5, dropout=0.0, residual=False,
               stride=2),
          dict(repeats=2, channels=32, kernel=5, dropout=0.0),
          dict(repeats=1, channels=48, kernel=1, dropout=0.0, residual=False))
N_MELS, VOCAB = 64, 12
CHUNK, CONTEXT, STRIDE = 16, 16, 2


@functools.lru_cache(maxsize=None)
def _variables():
    cfg = jax_asr.JasperConfig(N_MELS, VOCAB, tuple(
        jax_asr.JasperBlock(**b) for b in BLOCKS))
    model = jax_asr.Jasper(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 32, N_MELS)), train=False))
    return model, draw(shapes, 1)


@functools.lru_cache(maxsize=None)
def _infer():
    """The port's eval forward as the server's ``infer_fn``."""
    _, v = _variables()
    cfg = asr.JasperConfig(N_MELS, VOCAB, tuple(asr.JasperBlock(**b)
                                               for b in BLOCKS))
    model = load(asr.Jasper(cfg, torch.float32), jasper_state_dict_from_jax(
        v["params"], v["batch_stats"])).eval()

    def infer(feats):
        with torch.no_grad():
            return model(torch.from_numpy(np.asarray(feats, np.float32))
                         ).numpy()

    return infer


def _server(infer=None) -> StreamingAsrServer:
    return StreamingAsrServer(infer or _infer(), MelConfig(n_mels=N_MELS),
                              chunk_frames=CHUNK, context_frames=CONTEXT,
                              time_stride=STRIDE)


def test_streaming_matches_full_utterance_and_jax():
    infer = _infer()
    rng = np.random.default_rng(0)
    audio = rng.normal(size=22000).astype(np.float32) * 0.2  # even frames
    mel = mel_spectrogram(audio, MelConfig(n_mels=N_MELS)).T
    full = infer(mel[None])[0]
    emitted, bands, t = 0, [], mel.shape[0]
    while emitted < t:
        take = min(CHUNK, t - emitted)
        start = max(emitted - CONTEXT, 0)
        ctx = emitted - start
        w = mel[start:min(emitted + take + CONTEXT, t)]
        pad = (2 * CONTEXT + CHUNK) - w.shape[0]
        if pad > 0:
            w = np.pad(w, ((0, pad), (0, 0)))
        bands.append(infer(w[None])[0][ctx // STRIDE:-(-(ctx + take) // STRIDE)])
        emitted += take
    streamed = np.concatenate(bands)
    assert streamed.shape == full.shape
    exact = (t - CHUNK - CONTEXT) // STRIDE
    np.testing.assert_allclose(streamed[:exact], full[:exact], atol=1e-4)
    np.testing.assert_allclose(streamed[exact:], full[exact:], atol=0.5)

    model, v = _variables()
    fwd = jit(lambda x: model.apply(v, x, train=False))
    jax_server = JaxServer(lambda x: np.asarray(fwd(jnp.asarray(x))),
                           MelConfig(n_mels=N_MELS), chunk_frames=CHUNK,
                           context_frames=CONTEXT, time_stride=STRIDE)
    server = _server()
    chunks = np.array_split(audio, 7)
    for i, ch in enumerate(chunks):
        last = i == len(chunks) - 1
        out = server.process_chunk("stream-1", ch, last=last)
        want = jax_server.process_chunk("stream-1", ch, last=last)
        assert out == want
    assert out["final"] and out["transcript"]
    assert out["transcript"] == asr.greedy_ctc_decode(streamed[None])[0]
    assert server.active_streams == 0


def test_streaming_partials_are_prefix_consistent():
    rng = np.random.default_rng(1)
    audio = rng.normal(size=16200).astype(np.float32) * 0.2
    server, prev = _server(), []
    for i, ch in enumerate(np.array_split(audio, 5)):
        r = server.process_chunk("s", ch, last=(i == 4))
        assert r["transcript"][:len(prev)] == prev
        prev = r["transcript"]
    assert prev


def test_interleaved_streams_isolated():
    rng = np.random.default_rng(2)
    a1 = rng.normal(size=12100).astype(np.float32) * 0.2
    a2 = rng.normal(size=12100).astype(np.float32) * 0.2
    server, seq = _server(), _server()
    c1, c2 = np.array_split(a1, 3), np.array_split(a2, 3)
    for i in range(3):
        r1 = server.process_chunk("a", c1[i], last=i == 2)
        r2 = server.process_chunk("b", c2[i], last=i == 2)
    for i in range(3):
        e1 = seq.process_chunk("a", c1[i], last=i == 2)
    for i in range(3):
        e2 = seq.process_chunk("b", c2[i], last=i == 2)
    assert r1["transcript"] == e1["transcript"]
    assert r2["transcript"] == e2["transcript"]
    assert server.active_streams == seq.active_streams == 0
