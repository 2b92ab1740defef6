"""Port parity: BERT pretraining in torch against the JAX package.

A small config (hidden 128 over 2 heads, so D=64 reaches the JAX bshd flash
kernels) with both dropout rates at 0 unless a test says otherwise: dropout
bits cannot match between jax.random and torch.Generator. Weights are made by
the JAX initialisers and carried over with the port's bridge, which also
carries JAX gradients across. The JAX side runs its Pallas kernels in
interpret mode; the torch side runs the plain versions of its kernels.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.core.flat import flatten_train as jax_flatten_train
from deeplearningexamples_tpu.core.flat import unflatten as jax_unflatten
from deeplearningexamples_tpu.core.optimizers import lr_poly_warmup as jax_poly
from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.ops.lamb import lamb as jax_lamb
from deeplearningexamples_tpu_torch.cli.main import cli
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager
from deeplearningexamples_tpu_torch.core.flat import flatten_train
from deeplearningexamples_tpu_torch.core.optimizers import lr_poly_warmup
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    BertPretrainTask,
)
from deeplearningexamples_tpu_torch.ops.dropout import regen_dropout
from deeplearningexamples_tpu_torch.ops.lamb import lamb
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_pretrain_jax_order,
    bert_pretrain_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

SMALL = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position_embeddings=64,
             hidden_dropout=0.0, attention_dropout=0.0)
B, S, P = 4, 32, 6
# fp32 on both sides, JAX matmuls at "highest": only summation order differs
ATOL_F32 = 2e-4
# bf16 on both sides: flax and torch round activations to bf16 at different
# points (dense epilogues, GELU, the embedding sum), and the MLM logits sum
# 128 such products; compared relative to the logits' scale
ATOL_BF16 = 1e-1


@pytest.fixture(scope="module")
def jax_params():
    task = JaxPretrainTask(JaxBertConfig(**SMALL), dtype=jnp.float32,
                           max_predictions=P)
    params = jax.jit(lambda key: task.init(key, seq_len=S, batch=1)[0])(
        jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(seed=0, equal_counts=False):
    """A padded batch; each row masks P - 1 distinct positions (so the
    top-k takes one unmasked slot of weight 0), or exactly P // 2."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, SMALL["vocab_size"], size=(B, S)).astype(np.int32)
    lengths = [S, S - 5, S - 11, S]
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    types = (np.arange(S)[None, :] >= S // 2).astype(np.int32) * mask
    labels = np.full((B, S), -1, np.int32)
    n = P // 2 if equal_counts else P - 1
    for i in range(B):
        pos = rng.choice(lengths[i], size=n, replace=False)
        labels[i, pos] = rng.integers(1, SMALL["vocab_size"], size=n)
    nsp = rng.integers(0, 2, size=(B,)).astype(np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask,
            "token_type_ids": types, "mlm_labels": labels, "nsp_label": nsp}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(params, dtype=torch.float32, cfg=SMALL) -> BertForPreTraining:
    model = BertForPreTraining(BertConfig(**cfg), dtype)
    sd = bert_pretrain_state_dict_from_jax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def test_bridge_covers_the_model_and_ties_the_decoder(jax_params):
    model = _port_model(jax_params)
    names = {n for n, _ in model.named_parameters()}
    assert "cls.predictions.decoder.weight" not in names
    assert names == set(bert_pretrain_state_dict_from_jax(jax_params))
    np.testing.assert_array_equal(
        model.cls.seq_relationship.weight.detach().numpy(),
        jax_params["nsp"]["kernel"].T)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_logits_and_loss_match_jax(jax_params, precision):
    jdtype, tdtype, atol = {"fp32": (jnp.float32, torch.float32, ATOL_F32),
                            "bf16": (jnp.bfloat16, torch.bfloat16, ATOL_BF16)}[precision]
    batch = _batch()
    jtask = JaxPretrainTask(JaxBertConfig(**SMALL), dtype=jdtype, max_predictions=P)
    task = BertPretrainTask(BertConfig(**SMALL), tdtype, max_predictions=P)
    model = _port_model(jax_params, tdtype)
    tb = _torch_batch(batch)
    from deeplearningexamples_tpu_torch.models.bert.task import masked_positions

    weights, positions = masked_positions(tb["mlm_labels"], P)
    want_pos = jax.lax.top_k(jnp.asarray(batch["mlm_labels"] >= 0, jnp.int32), P)[1]
    np.testing.assert_array_equal(positions.numpy(), np.asarray(want_pos))
    @jax.jit  # one compile of the interpret-mode kernels runs faster than eager
    def jax_side(params):
        logits = jtask.model.apply(
            {"params": params}, batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], masked_positions=want_pos)
        loss, (_, metrics) = jtask.loss_fn(params, {}, batch, jax.random.key(1))
        return logits, loss, metrics

    with jax.default_matmul_precision("highest"):
        (want_mlm, want_nsp), want_loss, want_m = jax_side(jax_params)
    with torch.no_grad():
        mlm, nsp = model(tb["input_ids"], tb["attention_mask"],
                         tb["token_type_ids"], masked_positions=positions)
        loss, (_, m) = task.loss_fn(model, {}, tb, torch.Generator())
    assert mlm.dtype == torch.float32 and mlm.shape == (B, P, 1024)
    np.testing.assert_allclose(mlm.numpy(), np.asarray(want_mlm), atol=atol,
                               rtol=atol)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(want_nsp), atol=atol,
                               rtol=atol)
    for got, want in ((loss, want_loss), (m["mlm_loss"], want_m["mlm_loss"]),
                      (m["nsp_loss"], want_m["nsp_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=atol / 10)


def test_gradients_match_jax(jax_params):
    batch = _batch(1)
    jtask = JaxPretrainTask(JaxBertConfig(**SMALL), dtype=jnp.float32,
                            max_predictions=P)
    with jax.default_matmul_precision("highest"):
        jgrads = jax.jit(jax.grad(lambda p: jtask.loss_fn(
            p, {}, batch, jax.random.key(1))[0]))(jax_params)
    want = bert_pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    task = BertPretrainTask(BertConfig(**SMALL), torch.float32, max_predictions=P)
    model = _port_model(jax_params)
    loss, _ = task.loss_fn(model, {}, _torch_batch(batch), torch.Generator())
    loss.backward()
    for name, p in model.named_parameters():
        scale = max(float(np.abs(want[name]).max()), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), want[name],
                                   atol=1e-4 * scale, rtol=1e-3, err_msg=name)
    # the tied word table takes gradient from the lookup and the decoder
    assert float(model.bert.embeddings.word_embeddings.weight.grad.abs().sum()) > 0


def _jax_curve(jax_params, flat, steps, lr):
    jtask = JaxPretrainTask(JaxBertConfig(**SMALL), dtype=jnp.float32,
                            max_predictions=P)
    sched = jax_poly(lr, 1, steps)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    with jax.default_matmul_precision("highest"):
        if flat:
            loss_fn, tx, params = jax_flatten_train(
                jtask.loss_fn, params, lr=sched, weight_decay=0.01,
                moment_dtype=jnp.bfloat16)
        else:
            loss_fn = jtask.loss_fn
            tx = jax_lamb(sched, weight_decay=0.01, moment_dtype=jnp.bfloat16,
                          mask=jax.tree_util.tree_map(lambda p: p.ndim > 1, params))
        step = jax_make_train_step(loss_fn, tx)
        state = jax_create_train_state(params, tx, jax.random.key(1))
        batch = jax.tree_util.tree_map(jnp.asarray, _batch(2))
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    out = state.params
    if flat:
        out = jax_unflatten(loss_fn.layout, out, loss_fn.dtypes)
    return losses, bert_pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, out))


def _port_state(params, flat, lr, steps, dtype=torch.float32, cfg=SMALL,
                accum_steps=1, ema_decay=None, ema_steps=1):
    model = _port_model(params, dtype, cfg)
    task = BertPretrainTask(BertConfig(**cfg), dtype, max_predictions=P)
    sched = lr_poly_warmup(lr, 1, steps)
    if flat:
        tx, tparams, _ = flatten_train(
            model, lr=sched, weight_decay=0.01, moment_dtype=torch.bfloat16,
            order=bert_pretrain_jax_order(cfg["num_layers"]))
    else:
        tparams = dict(model.named_parameters())
        tx = lamb(sched, weight_decay=0.01, moment_dtype=torch.bfloat16,
                  mask={n: p.ndim > 1 for n, p in tparams.items()})
    state = create_train_state(model, tx, 1, params=tparams,
                               ema=ema_decay is not None)
    step = make_train_step(task.loss_fn, tx, accum_steps=accum_steps,
                           ema_decay=ema_decay, ema_steps=ema_steps)
    return state, step


@pytest.mark.parametrize("mode", ["tree", "flat"])
def test_loss_curve_matches_jax(jax_params, mode):
    steps, lr = 5, 1e-2
    want, want_params = _jax_curve(jax_params, mode == "flat", steps, lr)
    state, step = _port_state(jax_params, mode == "flat", lr, steps)
    batch = _torch_batch(_batch(2))
    got = []
    for _ in range(steps):
        state, m = step(state, batch)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   atol=2e-4, rtol=2e-3, err_msg=name)


def test_accum_steps_equals_one_step_on_the_whole_batch(jax_params):
    """Two microbatches with the same number of masked positions each: the
    mean of their fp32 gradients is the whole batch's gradient, and the
    metrics are the microbatches' means."""
    batch = _torch_batch(_batch(3, equal_counts=True))
    out = {}
    for n in (1, 2):
        state, step = _port_state(jax_params, False, 1e-2, 1, accum_steps=n)
        state, m = step(state, batch)
        out[n] = (m, {k: p.grad.clone() for k, p in state.params.items()})
    for k in ("loss", "mlm_loss", "nsp_loss", "grad_norm"):
        torch.testing.assert_close(out[2][0][k], out[1][0][k], rtol=1e-5,
                                   atol=0, msg=k)
    for name, g in out[1][1].items():
        # atol: the key biases' true gradient is 0 (softmax is shift
        # invariant), so theirs is rounding noise near 1e-11
        torch.testing.assert_close(out[2][1][name], g, rtol=1e-4, atol=1e-7,
                                   msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        state, step = _port_state(jax_params, False, 1e-2, 1, accum_steps=3)
        step(state, batch)


def test_ema_every_ema_steps(jax_params):
    state, step = _port_state(jax_params, False, 1e-2, 4, ema_decay=0.9,
                              ema_steps=2)
    batch = _torch_batch(_batch(4))
    want = {k: p.detach().clone() for k, p in state.params.items()}
    for i in range(4):
        state, _ = step(state, batch)
        if i % 2 == 0:  # the state's step before this update
            want = {k: e * 0.9 + state.params[k].detach() * (1 - 0.9)
                    for k, e in want.items()}
    for k, e in want.items():
        torch.testing.assert_close(state.ema_params[k], e, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("mode", ["tree", "flat"])
def test_checkpoint_resume_is_bit_identical(jax_params, mode, tmp_path):
    """With dropout on: the restored generator redraws the same masks."""
    cfg = dict(SMALL, hidden_dropout=0.1, attention_dropout=0.1)
    batch = _torch_batch(_batch(5))
    state, step = _port_state(jax_params, mode == "flat", 1e-2, 4,
                              dtype=torch.bfloat16, cfg=cfg)
    for _ in range(4):
        state, _ = step(state, batch)
    straight = {k: p.detach().clone() for k, p in state.model.named_parameters()}

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    state, step = _port_state(jax_params, mode == "flat", 1e-2, 4,
                              dtype=torch.bfloat16, cfg=cfg)
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt.save(state.step, state)
    state, step = _port_state(jax_params, mode == "flat", 1e-2, 4,
                              dtype=torch.bfloat16, cfg=cfg)
    state = ckpt.restore(state)
    assert state.step == 2
    for _ in range(2):
        state, _ = step(state, batch)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), straight[k], rtol=0, atol=0, msg=k)


def test_hidden_dropout_keep_rate_and_regenerated_mask():
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(512, 1024, dtype=dtype, requires_grad=True)
        y = regen_dropout(x, 0.1, gen)
        kept = y.detach() != 0
        n = kept.numel()
        # binomial keep count within 4 sigma of 0.9 n
        assert abs(int(kept.sum()) - 0.9 * n) < 4 * (n * 0.09) ** 0.5
        scale = torch.tensor(np.float32(1) / np.float32(0.9)).to(dtype)
        assert bool((y.detach()[kept] == scale).all())
        y.sum().backward()
        torch.testing.assert_close(x.grad, y.detach(), rtol=0, atol=0)


def test_model_dropout_follows_the_generator(jax_params):
    cfg = dict(SMALL, hidden_dropout=0.1, attention_dropout=0.1)
    model = _port_model(jax_params, cfg=cfg)
    tb = _torch_batch(_batch(6))
    args = (tb["input_ids"], tb["attention_mask"], tb["token_type_ids"])
    with torch.no_grad():
        a = model(*args, generator=torch.Generator().manual_seed(1))[0]
        b = model(*args, generator=torch.Generator().manual_seed(1))[0]
        c = model(*args, generator=torch.Generator().manual_seed(2))[0]
        d = model(*args)[0]  # no generator: no dropout, as deterministic=True
        e = _port_model(jax_params)(*args)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(d, e, rtol=0, atol=0)


def test_cli_trains_the_tiny_config_on_the_cpu(tmp_path):
    argv = ["bert-pretrain", "--bert-model", "tiny", "--batch-size", "4",
            "--seq-len", "32", "--max-predictions", "5", "--steps-per-epoch",
            "8", "--lr", "0.01", "--device", "cpu", "--workspace",
            str(tmp_path), "--flat-lamb", "--lamb-moments", "fp32"]
    state, best = cli(argv)
    assert state.step == 8 and np.isfinite(best)
    lines = [json.loads(line.split(" ", 1)[1])
             for line in (tmp_path / "bert_pretrain_raport.json").read_text().splitlines()]
    losses = [ln["data"]["train.loss"] for ln in lines
              if ln["type"] == "LOG" and "train.loss" in ln.get("data", {})]
    assert len(losses) == 8 and losses[-1] < losses[0]  # one per step
    assert (tmp_path / "bert_ckpt" / "ckpt_8.pt").exists()
    # the sequence axis is ported: two sequence ranks in one process is
    # JAX's mesh error
    with pytest.raises(ValueError, match="1 devices not divisible by 2"):
        cli(["bert-pretrain", "--device", "cpu", "--workspace", str(tmp_path),
             "--attention-impl", "ring", "--mesh-sequence", "2"])
    # the YAML layers: a key the command's config lacks raises, as JAX's merge
    bad = tmp_path / "bad.yml"
    bad.write_text("models:\n  bert-pretrain:\n    no_such_key: 1\n")
    with pytest.raises(KeyError, match="no_such_key"):
        cli(["bert-pretrain", "--device", "cpu", "--config-file", str(bad)])


def test_task_init_defaults_to_the_card():
    import inspect

    for cls in (BertPretrainTask,):
        assert inspect.signature(cls.init).parameters["device"].default == "cuda"
    model = BertPretrainTask(BertConfig(**SMALL)).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert float(model.cls.predictions.bias.detach().abs().max()) == 0.0
    assert dataclasses.is_dataclass(BertPretrainTask)
