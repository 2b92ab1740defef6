"""The port's sequence axis on the CPU: ring attention at four gloo ranks and
ring BERT at (data 2, sequence 2) against the JAX package on its 8-device
CPU mesh.

One spawn of four ranks (``tests/torch_mesh_worker.py``, torch on one
thread each) runs the multi-rank checks while this process runs JAX's side.
Four ranks, because at two the ring's j -> j+1 and j -> j-1 are the same
permutation: a ring that rotates the wrong way passes every two-rank check.

- The ring op, B=2 H=2 S=64 D=16 fp32, on a ``sequence=4`` line against
  JAX's ``ring_attention`` on a ``sequence=4`` mesh: masked non-causal,
  causal, zigzag-causal with a mask and dropout (0.1), contiguous masked
  with dropout.
  Forward within 1e-5, the gradients of ``sum(out * g)`` within 1e-4 of each
  tensor's largest entry. The dropout keep mask is JAX's hash bit for bit,
  and the port's ring with dropout equals its flash path's plain version
  (K1's semantics) within 1e-5.
- Tiny BERT (2 layers x 128, 2 heads of 64, B=4 S=32, attention dropout 0.1
  with K1's seeds handed to both packages, hidden dropout 0) with
  ``attention_impl="ring"``, one LAMB step through the port's train step at
  (data 2, sequence 2), against JAX's ring BERT on the global batch (a
  ``sequence=2`` mesh, matmuls at "highest"): the loss within 1e-5
  relative, each gradient within 1e-4 of its largest entry plus 1e-3
  relative (``test_torch_bert_pretrain.py``'s). Two steps with hidden
  dropout on and the seeds drawn from the generator against the port's own
  one-rank flash run (plain versions): losses within 1e-5 relative,
  parameters within 2e-4 + 2e-3 relative (LAMB's bf16 moments). The two
  ranks of each sequence line end every step with equal parameters, bit for
  bit.
"""

import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.ops.flash_attention import _dropout_scale
from deeplearningexamples_tpu.ops.ring_attention import (
    ring_attention as jax_ring_attention,
)
from deeplearningexamples_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearningexamples_tpu.parallel import build_mesh as jax_build_mesh
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.ops.flash_attention import (
    dropout_scale,
    mha_reference,
)
from deeplearningexamples_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_local,
)
from deeplearningexamples_tpu_torch.parallel import mesh
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_pretrain_state_dict_from_jax,
)
from torch_dist_worker import run_bert
from torch_mesh_worker import collect, spawn
from torch_threads import torch_one_thread  # noqa: F401

B, H, S, D = 2, 2, 64, 16
CASES = {
    "masked": dict(masked=True),
    "causal": dict(causal=True),
    "zigzag": dict(masked=True, causal=True, zigzag=True, dropout_rate=0.1,
                   dropout_seed=777),
    "dropout": dict(masked=True, dropout_rate=0.1, dropout_seed=1234),
}
BERT = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64,
            hidden_dropout=0.0, attention_dropout=0.1, attention_impl="ring")
HIDDEN = dict(BERT, hidden_dropout=0.1)
BB, BS, P = 4, 32, 6
SEEDS = (123456789, -987654321)  # K1's dropout seed of layer 0 and 1
LR = 1e-2


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                  for _ in range(4))
    mask = (rng.uniform(size=(B, S)) > 0.3).astype(np.int32)
    mask[:, 0] = 1  # every row keeps a key
    return {"q": q, "k": k, "v": v, "g": g, "mask": mask}


def _bert_batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, BERT["vocab_size"], size=(BB, BS)).astype(np.int32)
    lengths = np.asarray([BS, BS - 5, BS - 11, BS])
    mask = (np.arange(BS)[None, :] < lengths[:, None]).astype(np.int32)
    types = (np.arange(BS)[None, :] >= BS // 2).astype(np.int32) * mask
    labels = np.full((BB, BS), -1, np.int32)
    for i, n in enumerate((5, 1, 4, 3)):
        pos = rng.choice(lengths[i], size=n, replace=False)
        labels[i, pos] = rng.integers(1, BERT["vocab_size"], size=n)
    nsp = rng.integers(0, 2, size=(BB,)).astype(np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask,
            "token_type_ids": types, "mlm_labels": labels, "nsp_label": nsp}


@contextlib.contextmanager
def _jax_attention_seeds():
    """JAX's K1 seed draw (``jax.random.randint(key, (), -2**31, ...)``)
    gives ``SEEDS`` by layer."""
    real, calls = jax.random.randint, itertools.count()

    def fixed(key, shape, minval, maxval, *args, **kw):
        if tuple(shape) == () and minval == -2**31:
            return jnp.int32(SEEDS[next(calls) % len(SEEDS)])
        return real(key, shape, minval, maxval, *args, **kw)

    jax.random.randint = fixed
    try:
        yield
    finally:
        jax.random.randint = real


def _jax_cases(inp):
    smesh = jax_build_mesh(JaxMeshSpec(data=-1, sequence=4))
    q, k, v, g, mask = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "g",
                                                      "mask"))
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        m = mask if kw.pop("masked", False) else None

        @jax.jit
        def run(q, k, v, m=m, kw=kw):
            y, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(
                q, k, v, m, mesh=smesh, **kw), q, k, v)
            return (y, *vjp(g))

        out[name] = dict(zip(("out", "dq", "dk", "dv"),
                             map(np.asarray, run(q, k, v))))
    return out


def _jax_ring_bert(params, batch):
    jtask = JaxPretrainTask(JaxBertConfig(**BERT), dtype=jnp.float32,
                            max_predictions=P)
    smesh = jax_build_mesh(JaxMeshSpec(data=-1, sequence=2))
    with jax.set_mesh(smesh), jax.default_matmul_precision("highest"), \
            _jax_attention_seeds():
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jtask.loss_fn(
            p, {}, batch, jax.random.key(1))[0]))(params)
    return float(loss), bert_pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks started, JAX's side and the port's one-rank run computed
    while they run; then each rank's results."""
    out = tmp_path_factory.mktemp("ring")
    inp = _inputs()
    # the same tree as the ring's, initialised outside a mesh
    jtask = JaxPretrainTask(JaxBertConfig(**dict(BERT, attention_impl="xla")),
                            dtype=jnp.float32, max_predictions=P)
    bert_jax = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jtask.init(key, seq_len=BS, batch=1)[0])(jax.random.key(0)))
    sd = bert_pretrain_state_dict_from_jax(bert_jax)
    batch = _bert_batch()
    procs = spawn("ring", {
        **{n: torch.from_numpy(a) for n, a in inp.items()}, "cases": CASES,
        "bert": {"cfg": BERT, "hidden_cfg": HIDDEN, "sd": sd, "batch": batch,
                 "p": P, "seeds": SEEDS, "lr": LR}}, out)
    try:
        jax_side = {"cases": _jax_cases(inp),
                    "bert": _jax_ring_bert(bert_jax, batch)}
        # the port in this process: one rank, the flash path's plain version
        losses, state, _ = run_bert(dict(HIDDEN, attention_impl="flash"), sd,
                                    batch, P, steps=2, lr=LR)
        one = {"losses": losses, "params": {
            n: p.detach().clone() for n, p in state.model.named_parameters()}}
    finally:
        ranks = collect(procs, out)
    return {"ranks": ranks, "jax": jax_side, "one": one, "inputs": inp}


def _scaled(got, want, tol: float, name: str) -> None:
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_at_four_ranks(run, case):
    want = run["jax"]["cases"][case]
    for res in run["ranks"]:
        got = res["cases"][case]
        np.testing.assert_allclose(got["out"].numpy(), want["out"], rtol=0,
                                   atol=1e-5, err_msg=case)
        for g in ("dq", "dk", "dv"):
            _scaled(got[g].numpy(), want[g], 1e-4, f"{case} {g}")


def test_dropout_keep_mask_is_jax_hash_and_k1s():
    """The hash on global positions, the seed and ``b * H + h``: the port's
    keep mask is JAX's bit for bit, and the ring with dropout equals the
    flash path's plain version (one rank: one block) for the same seed."""
    rows, cols = np.arange(S)[:, None], np.arange(S)[None, :]
    salt = (np.arange(B)[:, None] * H + np.arange(H)[None, :])[..., None, None]
    want = np.asarray(_dropout_scale(jnp.asarray(rows, jnp.int32),
                                     jnp.asarray(cols, jnp.int32),
                                     jnp.int32(-55), jnp.asarray(salt), 0.1))
    got = dropout_scale(torch.as_tensor(rows), torch.as_tensor(cols), -55,
                        torch.as_tensor(salt), 0.1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < float((want == 0).mean()) < 0.15
    inp = {n: torch.from_numpy(a) for n, a in _inputs().items()}
    kw = dict(dropout_rate=0.1, dropout_seed=1234)
    ring = ring_attention(inp["q"], inp["k"], inp["v"], inp["mask"], **kw)
    flash = mha_reference(inp["q"], inp["k"], inp["v"], inp["mask"], **kw)[0]
    np.testing.assert_allclose(ring.numpy(), flash.numpy(), rtol=0, atol=1e-5)
    plain = ring_attention(inp["q"], inp["k"], inp["v"], inp["mask"])
    assert float((ring - plain).abs().max()) > 1e-3


def test_ring_bert_at_data2_sequence2_matches_jax(run):
    want_loss, want = run["jax"]["bert"]
    for res in run["ranks"]:
        got = res["bert"]
        np.testing.assert_allclose(got["losses"][0], want_loss, rtol=1e-5)
        for name, g in got["grads"].items():
            scale = max(float(np.abs(want[name]).max()), 1e-3)
            np.testing.assert_allclose(g.numpy(), want[name],
                                       atol=1e-4 * scale, rtol=1e-3,
                                       err_msg=name)


def test_sequence_ranks_keep_equal_parameters_and_the_one_rank_masks(run):
    """Ranks 0, 1 and 2, 3 are the two sequence lines (rank = 2 d + s):
    equal parameters bit for bit after each run; with hidden dropout on and
    the seeds drawn from the generator, both lines train as the one-rank
    flash run does."""
    ranks = [r["bert"] for r in run["ranks"]]
    for a, b in ((0, 1), (2, 3)):
        for pa, pb in ((ranks[a]["params"], ranks[b]["params"]),
                       (ranks[a]["hidden"]["params"],
                        ranks[b]["hidden"]["params"])):
            assert all(torch.equal(pa[n], pb[n]) for n in pa), (a, b)
    want = run["one"]
    for res in ranks:
        got = res["hidden"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                       atol=2e-4, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("kw,shape,match", [
    (dict(), (B, H, 62, D), "not divisible"),
    (dict(zigzag=True), (B, H, S, D), "causal"),
    (dict(zigzag=True, causal=True), (B, H, 68, D), r"divisible by 2n=8"),
])
def test_errors_are_jax_errors(kw, shape, match):
    """JAX's errors, raised by both packages on a sequence=4 mesh."""
    x = np.zeros(shape, np.float32)
    smesh = jax_build_mesh(JaxMeshSpec(data=-1, sequence=4))
    with pytest.raises(ValueError, match=match):
        jax_ring_attention(*(jnp.asarray(x),) * 3, mesh=smesh, **kw)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match=match):
        ring_attention(t, t, t, mesh=mesh.Mesh((1, 1, 4)), **kw)


def test_zigzag_needs_an_even_local_length():
    t = torch.zeros(1, 1, 3, 4)
    with pytest.raises(ValueError, match="even local length"):
        ring_attention_local(t, t, t, causal=True, zigzag=True)


def test_cli_ring_at_mesh_sequence_1_is_the_flash_run(tmp_path):
    """``bert-pretrain --attention-impl ring`` in one process, no torchrun
    (the 1 x 1 x 1 mesh: one block, no collective), fp32: the losses of
    ``--attention-impl flash`` (its plain version) within 1e-5 relative."""
    args = ["bert-pretrain", "--bert-model", "tiny", "--batch-size", "4",
            "--seq-len", "32", "--max-predictions", "5", "--steps-per-epoch",
            "2", "--lr", "0.01", "--device", "cpu", "--amp", "false",
            "--mesh-sequence", "1"]
    losses = {}
    for impl in ("ring", "flash"):
        state, best = cli([*args, "--attention-impl", impl, "--workspace",
                           str(tmp_path / impl)])
        assert state.step == 2 and np.isfinite(best)
        losses[impl] = [float(v) for v in _losses(tmp_path / impl)]
    np.testing.assert_allclose(losses["ring"], losses["flash"], rtol=1e-5)


def _losses(ws):
    import json

    rows = [json.loads(line.split(" ", 1)[1]) for line in
            (ws / "bert_pretrain_raport.json").read_text().splitlines()]
    return [r["data"]["train.loss"] for r in rows
            if r["type"] == "LOG" and "train.loss" in r.get("data", {})]


def test_other_commands_take_the_sequence_axis(tmp_path):
    """Every command takes ``--mesh-sequence`` (a command that does not
    split along it repeats the data rank's work on each of its ranks, as in
    JAX; ``test_torch_parallel_families.py`` runs one at data 1 x sequence
    2): a sequence axis of 2 ranks in one process is JAX's mesh error."""
    for command in ("resnet50", "ssd300", "dlrm", "bert-squad",
                    "transformer", "efficientdet"):
        with pytest.raises(ValueError, match="1 devices not divisible by 2"):
            cli([command, "--mesh-sequence", "2", "--device", "cpu",
                 "--workspace", str(tmp_path)])
