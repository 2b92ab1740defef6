"""Port parity: BERT fine-tuning (SQuAD, GLUE, SWAG) in torch against the JAX
package.

A tiny config (2 layers, hidden 64 over 4 heads, S=32 with padded rows) with
both dropout rates at 0: hidden and classifier dropout bits cannot match
between jax.random and torch.Generator. Weights are made by the JAX
initialisers and carried over with the port's bridge, which also carries JAX
gradients across. The JAX side runs under jax.jit with its Pallas kernels in
interpret mode and matmuls at "highest"; the torch side runs in fp32 with the
plain versions of its kernels. Only the order of the sums differs, so fp32
values agree to about 1e-5 of the largest entry.
"""

import csv
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearningexamples_tpu.cli.main import SquadCliConfig as JaxSquadCliConfig
from deeplearningexamples_tpu.cli.main import _bert_finetune_tx as jax_finetune_tx
from deeplearningexamples_tpu.core import optimizers as jopt
from deeplearningexamples_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertForMultipleChoice as JaxMC
from deeplearningexamples_tpu.models.bert import BertSquadTask as JaxSquadTask
from deeplearningexamples_tpu.models.bert import glue as jglue
from deeplearningexamples_tpu.models.bert import read_squad_references as jax_refs
from deeplearningexamples_tpu.utils.torch_import import (
    load_bert_encoder as jax_load_bert_encoder,
)
from deeplearningexamples_tpu_torch.cli import main as cli_main
from deeplearningexamples_tpu_torch.cli.main import (
    SquadCliConfig,
    _bert_finetune_tx,
    cli,
    featurize_swag,
    read_swag,
)
from deeplearningexamples_tpu_torch.core.logging import Logger
from deeplearningexamples_tpu_torch.core.loop import LoopConfig, train_loop
from deeplearningexamples_tpu_torch.core.optimizers import (
    adamw,
    bert_adam,
    lr_poly_warmup,
)
from deeplearningexamples_tpu_torch.core.train import (
    create_train_state,
    make_train_step,
)
from deeplearningexamples_tpu_torch.data.tokenization import BertTokenizer
from deeplearningexamples_tpu_torch.models.bert import (
    BertConfig,
    BertForMultipleChoice,
    BertForQuestionAnswering,
    BertForSequenceClassification,
    BertSquadTask,
    read_squad_references,
)
from deeplearningexamples_tpu_torch.models.bert import glue
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_classifier_state_dict_from_jax,
    bert_qa_state_dict_from_jax,
)
from deeplearningexamples_tpu_torch.utils.torch_import import load_bert_encoder
from torch_threads import torch_one_thread  # noqa: F401

TINY = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=64,
            hidden_dropout=0.0, attention_dropout=0.0)
B, S, C = 4, 32, 4
LENGTHS = (S, S - 7, S - 13, S)
# fp32 on both sides, JAX matmuls at "highest": only the order of the sums
# differs. Gradients: each tensor's max abs error against 1e-5 of the largest
# entry of every gradient (a key bias's true gradient is 0, so its own scale
# is rounding noise).
TOL_GRAD = 1e-5
TOL_LOSS = 1e-5  # relative
SCHEDULES = ["warmup_linear", "warmup_constant", "warmup_poly", "warmup_cosine"]


@pytest.fixture(scope="module")
def qa_params():
    task = JaxSquadTask(JaxBertConfig(**TINY), dtype=jnp.float32)
    params = jax.jit(lambda key: task.init(key, seq_len=S, batch=1)[0])(
        jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def squad_value_and_grad():
    """JAX's SQuAD loss and its gradient, one compile for the module's calls
    (each under ``jax.default_matmul_precision("highest")``)."""
    jtask = JaxSquadTask(JaxBertConfig(**TINY), dtype=jnp.float32)

    @jax.jit
    def value_and_grad(params, batch):
        return jax.value_and_grad(lambda p: jtask.loss_fn(
            p, {}, batch, jax.random.key(1))[0])(params)

    return value_and_grad


def _head_params(qa_params, n_out: int) -> dict:
    """The QA tree's encoder with a fresh classifier of ``n_out`` outputs."""
    rng = np.random.default_rng(n_out)
    return {"bert": qa_params["bert"], "classifier": {
        "kernel": (0.02 * rng.standard_normal((TINY["hidden_size"], n_out))
                   ).astype(np.float32),
        "bias": np.zeros(n_out, np.float32)}}


def _inputs(seed: int, shape=(B,)) -> dict[str, np.ndarray]:
    """ids, mask and segments of shape ``shape + (S,)``, rows padded to
    LENGTHS (cycled over the leading dims)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    lengths = np.resize(np.asarray(LENGTHS), n)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, TINY["vocab_size"], size=(n, S)).astype(np.int32) * mask
    types = ((np.arange(S)[None, :] >= lengths[:, None] // 2) * mask).astype(np.int32)
    return {k: v.reshape(*shape, S) for k, v in
            (("input_ids", ids), ("attention_mask", mask),
             ("token_type_ids", types))}


def _squad_batch(seed: int) -> dict[str, np.ndarray]:
    # positions out of range on both sides: clipped to [0, S - 1]
    return {**_inputs(seed),
            "start_positions": np.array([3, S + 5, -2, 10], np.int32),
            "end_positions": np.array([5, S + 9, 4, S - 1], np.int32)}


def _t(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _load(model, sd):
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def _qa_model(params, dtype=torch.float32) -> BertForQuestionAnswering:
    return _load(BertForQuestionAnswering(BertConfig(**TINY), dtype),
                 bert_qa_state_dict_from_jax(params))


def _check_grads(model, want: dict) -> None:
    """Each parameter's gradient against JAX's (the QA head leaves the
    pooler without one: JAX's is zero)."""
    got = {n: np.zeros(p.shape, np.float32) if p.grad is None
           else p.grad.numpy() for n, p in model.named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for name, g in got.items():
        err = float(np.abs(g - want[name]).max())
        assert err <= TOL_GRAD * scale, (name, err, scale)


# -- optimizers --------------------------------------------------------------


def _opt_problem(steps: int = 5):
    """Three tensors and five steps of gradients: "dense" (norm about 11) and
    "table" (about 1.9) are clipped by bert_adam, "bias" (about 0.04) is
    not; the mask decays the 2-d ones."""
    rng = np.random.default_rng(7)
    shapes = {"dense": ((16, 8), 1.0), "bias": ((16,), 0.01), "table": ((10, 4), 0.3)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, (s, _) in shapes.items()}
    grads = [{n: (k * rng.standard_normal(s)).astype(np.float32)
              for n, (s, k) in shapes.items()} for _ in range(steps)]
    return params, grads


def _trajectories(jax_tx, port_tx, params, grads):
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jstate = jax_tx.init(jp)
    jupdate = jax.jit(jax_tx.update)
    tp = {n: torch.tensor(p) for n, p in params.items()}
    tstate = port_tx.init(tp)
    out = []
    for g in grads:
        upd, jstate = jupdate({n: jnp.asarray(x) for n, x in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = port_tx.update({n: torch.tensor(x) for n, x in g.items()},
                                      tstate, tp)
        tp = {n: tp[n] + tupd[n] for n in tp}
        out.append(({n: np.asarray(x) for n, x in jp.items()},
                    {n: x.numpy() for n, x in tp.items()}))
    return out


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bert_adam_trajectory_matches_jax(schedule):
    params, grads = _opt_problem()
    assert np.linalg.norm(grads[0]["dense"]) > 1 > np.linalg.norm(grads[0]["bias"])
    mask = {n: p.ndim > 1 for n, p in params.items()}
    kw = dict(warmup=0.2, t_total=10, schedule=schedule)
    steps = _trajectories(jopt.bert_adam(1e-2, mask=mask, **kw),
                          bert_adam(1e-2, mask=mask, **kw), params, grads)
    for want, got in steps:
        for n in params:
            # fp32 sums in another order (the CPU's norms are fp64 across
            # chunks): about an ulp of each update
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6,
                                       err_msg=f"{schedule} {n}")
    # the schedule is read at count 0, where every warmup gives 0
    for n in params:
        np.testing.assert_array_equal(steps[0][1][n], params[n])
    assert any(np.abs(steps[-1][1][n] - params[n]).max() > 1e-3 for n in params)


def test_adamw_trajectory_matches_optax():
    params, grads = _opt_problem()
    jax_tx = optax.adamw(jopt.lr_poly_warmup(1e-2, 1, 5, power=1.0),
                         weight_decay=0.01)
    port_tx = adamw(lr_poly_warmup(1e-2, 1, 5, power=1.0), weight_decay=0.01)
    for want, got in _trajectories(jax_tx, port_tx, params, grads):
        for n in params:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-6,
                                       err_msg=n)


def test_adamw_decays_every_tensor_and_schedules_the_decay():
    """optax.adamw without a mask: a zero gradient still moves every tensor,
    1-d ones too, by -lr * wd * p."""
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    tx = adamw(lambda count: 0.5, weight_decay=0.1)
    upd, _ = tx.update({n: torch.zeros_like(x) for n, x in p.items()},
                       tx.init(p), p)
    for n in p:
        torch.testing.assert_close(upd[n], torch.full_like(p[n], -0.05))


# -- SQuAD ------------------------------------------------------------------


def test_squad_loss_and_every_gradient_match_jax(qa_params,
                                                 squad_value_and_grad):
    batch = _squad_batch(1)
    with jax.default_matmul_precision("highest"):
        want_loss, jgrads = squad_value_and_grad(qa_params, batch)
    model = _qa_model(qa_params)
    task = BertSquadTask(BertConfig(**TINY), torch.float32)
    loss, _ = task.loss_fn(model, {}, _t(batch), torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL_LOSS)
    _check_grads(model, bert_qa_state_dict_from_jax(
                     jax.tree_util.tree_map(np.asarray, jgrads)))


def _jax_squad_curve(value_and_grad, params, optimizer, steps, lr):
    """JAX's train step (accum_steps 1): the loss's gradient, the update,
    ``optax.apply_updates``; the losses and the final weights."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    if optimizer == "bert_adam":
        tx = jax_finetune_tx("bert_adam", lr, steps, params)
    else:  # the JAX runner's adamw line, spelled out (see ROADMAP Queue 3)
        tx = optax.adamw(jopt.lr_poly_warmup(lr, max(int(steps * 0.1), 1),
                                             steps, power=1.0),
                         weight_decay=0.01)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    batch = _squad_batch(2)
    losses = []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            loss, grads = value_and_grad(params, batch)
            updates, opt_state = update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
    return losses, bert_qa_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


# Tensors whose true gradient is 0 under the SQuAD loss, since the softmax
# over positions ignores a shift shared by every position: the span head's
# bias, the last layer's output LayerNorm bias (it adds one vector to every
# token) and the key biases (one shift to every score of a row). Their
# gradients are rounding noise, which Adam turns into steps of about lr in
# any direction, so their weights are not compared.
SHIFT_INVARIANT = ("qa_outputs.bias", f"layer.{TINY['num_layers'] - 1}.output.LayerNorm.bias",
                   "attention.self.key.bias")


@pytest.mark.parametrize("optimizer", ["bert_adam", "adamw"])
def test_squad_loss_curve_matches_jax(qa_params, squad_value_and_grad,
                                      optimizer):
    steps, lr = 5, 1e-2
    want, want_params = _jax_squad_curve(squad_value_and_grad, qa_params,
                                         optimizer, steps, lr)
    model = _qa_model(qa_params)
    task = BertSquadTask(BertConfig(**TINY), torch.float32)
    params = dict(model.named_parameters())
    tx = _bert_finetune_tx(optimizer, lr, steps, params)
    state = create_train_state(model, tx, 1, params=params)
    step = make_train_step(task.loss_fn, tx)
    batch = _t(_squad_batch(2))
    got = []
    for _ in range(steps):
        state, m = step(state, batch)
        got.append(float(m["loss"]))
        if len(got) == 1:
            top = max(float(p.grad.abs().max()) for p in params.values()
                      if p.grad is not None)
            for name, p in params.items():
                if name.endswith(SHIFT_INVARIANT):
                    assert float(p.grad.abs().max()) <= 1e-6 * top, name
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    if optimizer == "bert_adam":
        assert got[1] == got[0]  # warmup_linear's first update is 0
    assert got[-1] < got[0]
    for name, p in model.named_parameters():
        if name.endswith(SHIFT_INVARIANT):
            continue
        # Adam's steps move each weight by about lr * m / sqrt(v), which for
        # a small gradient entry turns the sums' rounding into a visible
        # share of the step: the bound is 1% of one step of lr
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   rtol=0, atol=1e-2 * lr, err_msg=name)


# -- GLUE and SWAG ------------------------------------------------------------


@pytest.mark.parametrize("head", ["glue", "swag"])
def test_glue_and_swag_logits_loss_and_gradients_match_jax(qa_params, head):
    if head == "glue":
        jmodel = jglue.GlueTask(JaxBertConfig(**TINY), 2, jnp.float32).model
        params, batch = _head_params(qa_params, 2), _inputs(3)
        model = BertForSequenceClassification(BertConfig(**TINY), 2,
                                              torch.float32)
        labels = np.array([0, 1, 1, 0], np.int32)
    else:
        jmodel = JaxMC(JaxBertConfig(**TINY), num_choices=C, dtype=jnp.float32)
        params, batch = _head_params(qa_params, 1), _inputs(4, (B, C))
        model = BertForMultipleChoice(BertConfig(**TINY), torch.float32)
        labels = np.array([0, 3, 1, 2], np.int32)
    batch = {**batch, "label": labels}

    @jax.jit
    def jax_side(p):
        def loss(q):
            logits = jmodel.apply(
                {"params": q}, batch["input_ids"], batch["attention_mask"],
                batch["token_type_ids"], deterministic=False,
                rngs={"dropout": jax.random.key(1)})
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["label"])), logits
        return jax.value_and_grad(loss, has_aux=True)(p)

    with jax.default_matmul_precision("highest"):
        (want_loss, want_logits), jgrads = jax_side(params)
    _load(model, bert_classifier_state_dict_from_jax(params))
    tb = _t(batch)
    logits = model(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"])
    assert logits.dtype == torch.float32 and logits.shape == want_logits.shape
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=0, atol=TOL_GRAD)
    loss, _ = glue.classification_loss(model, {}, tb, torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL_LOSS)
    _check_grads(model, bert_classifier_state_dict_from_jax(
                     jax.tree_util.tree_map(np.asarray, jgrads)))
    if head == "glue":
        acc = glue.GlueTask(BertConfig(**TINY)).metric_fn(model, {}, tb)
        want_acc = (np.argmax(np.asarray(want_logits), -1) == labels).mean()
        assert float(acc["accuracy"]) == pytest.approx(want_acc)


WORDS = ("the cat sat on a mat dog ran far away it was red blue green "
         "normandy is in france rollo led raiders king charles").split()


def _vocab_file(path) -> str:
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(WORDS))
    path.write_text("\n".join(vocab) + "\n")
    return str(path)


def _write_glue(data_dir, n: int, seed: int) -> None:
    """CoLA-layout train.tsv and dev.tsv (text in column 3, label in 1)."""
    rng = np.random.default_rng(seed)
    data_dir.mkdir(exist_ok=True)
    for split in ("train", "dev"):
        lines = ["source\tlabel\tmark\tsentence"]
        for i in range(n):
            words = rng.choice(WORDS, size=rng.integers(3, 9))
            lines.append(f"s{i}\t{int(rng.integers(0, 2))}\t*\t{' '.join(words)}")
        (data_dir / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def test_glue_readers_and_mcc_match_jax(tmp_path):
    vocab = _vocab_file(tmp_path / "vocab.txt")
    path = tmp_path / "train.tsv"
    rows = ["Quality\t#1 ID\t#2 ID\t#1 String\t#2 String"]
    rng = np.random.default_rng(0)
    for i in range(6):  # pairs, one long enough to be truncated at S=16
        a = " ".join(rng.choice(WORDS, size=rng.integers(2, 14)))
        b = " ".join(rng.choice(WORDS, size=rng.integers(1, 6)))
        rows.append(f"{i % 2}\t{i}\t{i + 100}\t{a}\t{b}")
    path.write_text("\n".join(rows) + "\n")
    cols = dict(text_a_col=3, text_b_col=4, label_col=0)
    got = glue.read_tsv(str(path), **cols)
    assert got == jglue.read_tsv(str(path), **cols)
    feats = glue.convert_pair_features(got, BertTokenizer(vocab), 16)
    want = jglue.convert_pair_features(got, JaxTokenizer(vocab), 16)
    assert set(feats) == set(want)
    for k in want:
        np.testing.assert_array_equal(feats[k], want[k], err_msg=k)
    assert feats["attention_mask"].sum(1).max() == 16  # truncated
    for seed in range(3):
        r = np.random.default_rng(seed)
        p, y = r.integers(0, 2, 40), r.integers(0, 2, 40)
        assert glue.matthews_corrcoef(p, y) == jglue.matthews_corrcoef(p, y)
    assert glue.matthews_corrcoef(np.ones(5), np.ones(5)) == 0.0


def test_swag_reader_and_features(tmp_path):
    path = tmp_path / "train.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video-id", "sent1", "sent2", "ending0", "ending1",
                    "ending2", "ending3", "label"])
        w.writerow(["v0", "the cat sat", "on a", "mat", "dog", "red mat",
                    "far away it was", "2"])
    rows = read_swag(str(path))
    assert rows == [("the cat sat on a", ["mat", "dog", "red mat",
                                          "far away it was"], 2)]
    f = featurize_swag(rows, BertTokenizer(_vocab_file(tmp_path / "v.txt")), 8)
    assert f["input_ids"].shape == (1, 4, 8) and f["label"].tolist() == [2]
    # [CLS] the cat sat on [SEP] mat [SEP]: the context trimmed from its end
    assert f["attention_mask"][0, 0].tolist() == [1] * 8
    assert f["token_type_ids"][0, 0].tolist() == [0] * 6 + [1] * 2
    assert f["attention_mask"][0, 1].sum() == 8


# -- --init-checkpoint --------------------------------------------------------


def test_init_checkpoint_loads_the_encoder_as_jax_does(qa_params, tmp_path):
    src = BertForQuestionAnswering(BertConfig(**TINY))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    # an NVIDIA/HF file: bert.-prefixed, the unpadded vocabulary, a head
    sd = {f"bert.{k}": v for k, v in src.bert.state_dict().items()}
    sd["bert.embeddings.word_embeddings.weight"] = \
        sd["bert.embeddings.word_embeddings.weight"][:TINY["vocab_size"]].clone()
    sd["cls.predictions.bias"] = torch.ones(TINY["vocab_size"])
    path = tmp_path / "bert.pt"
    torch.save(sd, path)
    cfg = JaxBertConfig(**TINY)
    jparams = dict(qa_params)
    jparams["bert"] = jax_load_bert_encoder(str(path), cfg.padded_vocab,
                                            cfg.num_layers)
    model = _qa_model(qa_params)
    load_bert_encoder(model.bert, str(path))
    word = model.bert.embeddings.word_embeddings.weight.detach()
    assert float(word[TINY["vocab_size"]:].abs().max()) == 0.0  # padded rows
    torch.testing.assert_close(model.qa_outputs.weight.detach(),
                               torch.tensor(qa_params["qa_outputs"]["kernel"].T))
    batch = _inputs(6)
    jtask = JaxSquadTask(cfg, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p: jtask.predict_fn(p, batch))(
            jax.tree_util.tree_map(jnp.asarray, jparams))
    with torch.no_grad():
        got = model(*_t(batch).values())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL_GRAD * float(np.abs(w).max()))
    # the NVIDIA checkpoint layout, {"model": state_dict}, loads the same
    torch.save({"model": sd, "epoch": 1}, tmp_path / "wrapped.pt")
    again = _qa_model(qa_params)
    load_bert_encoder(again.bert, str(tmp_path / "wrapped.pt"))
    for (n, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    del sd["bert.pooler.dense.bias"]
    torch.save(sd, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="pooler.dense.bias"):
        load_bert_encoder(again.bert, str(tmp_path / "short.pt"))


# -- the CLI on the CPU -------------------------------------------------------


def _raport(path) -> list[dict]:
    recs = [json.loads(line.split(" ", 1)[1])
            for line in path.read_text().splitlines()]
    return [r.get("data", {}) for r in recs if r.get("type") == "LOG"]


def _losses(path) -> list[float]:
    return [d["train.loss"] for d in _raport(path) if "train.loss" in d]


TINY_FLAGS = ["--bert-model", "tiny", "--device", "cpu", "--lr", "1e-3"]


@pytest.mark.parametrize("command, key", [
    ("bert-squad", None), ("bert-glue", "dev.accuracy"),
    ("bert-swag", "val.accuracy")])
@pytest.mark.parametrize("optimizer", ["bert_adam", "adamw"])
def test_cli_fine_tunes_synthetic_data_on_the_cpu(tmp_path, command, key,
                                                  optimizer):
    state, out = cli([command, *TINY_FLAGS, "--batch-size", "4",
                      "--max-seq-length", "32", "--steps-per-epoch", "4",
                      "--optimizer", optimizer, "--workspace", str(tmp_path)])
    assert state.step == 4
    name = command.replace("-", "_")
    losses = _losses(tmp_path / f"{name}_raport.json")
    assert len(losses) == 4 and all(np.isfinite(losses))
    if key:
        assert 0.0 <= out[key] <= 1.0
        assert any(key in d for d in _raport(tmp_path / f"{name}_raport.json"))
    assert (tmp_path / f"{name}_ckpt" / "ckpt_4.pt").exists()


CONTEXT = ("The Normans gave their name to Normandy, a region in France. "
           "Rollo led the raiders.")
SQUAD = {"version": "1.1", "data": [{"title": "t", "paragraphs": [
    {"context": CONTEXT,
     "qas": [{"id": f"q{i}", "question": q,
              "answers": [{"text": a, "answer_start": CONTEXT.index(a)}]}
             for i, (q, a) in enumerate([
                 ("Where is Normandy?", "France"),
                 ("Who led the raiders?", "Rollo"),
                 ("What is Normandy?", "a region"),
                 ("Who gave their name to Normandy?", "The Normans")])]},
]}]}


@pytest.mark.parametrize("v2", [False, True])
def test_cli_squad_files_give_em_and_f1(tmp_path, v2):
    qas = SQUAD["data"][0]["paragraphs"][0]["qas"]
    words = sorted({w for text in [CONTEXT] + [qa["question"] for qa in qas]
                    for w in BertTokenizer({}).basic.tokenize(text)})
    (tmp_path / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    (tmp_path / "train.json").write_text(json.dumps(SQUAD))
    assert read_squad_references(str(tmp_path / "train.json")) == \
        jax_refs(str(tmp_path / "train.json"))
    flags = [*TINY_FLAGS, "--batch-size", "2", "--max-seq-length", "64",
             "--doc-stride", "32", "--train-file", str(tmp_path / "train.json"),
             "--predict-file", str(tmp_path / "train.json"), "--vocab-file",
             str(tmp_path / "vocab.txt"), "--workspace", str(tmp_path),
             "--epochs", "2"]
    if v2:
        flags += ["--version-2-with-negative", "--null-score-diff-threshold",
                  "0.5"]
    state, best = cli(["bert-squad", *flags])
    assert state.step == 4  # 4 features, batch 2, 2 epochs
    vals = [d for d in _raport(tmp_path / "bert_squad_raport.json")
            if "val.f1" in d]
    assert len(vals) == 2 and best == max(d["val.f1"] for d in vals)
    for d in vals:
        assert 0.0 <= d["val.exact_match"] <= d["val.f1"] <= 100.0
        assert ("val.best_f1" in d) == v2
    preds = json.loads((tmp_path / "predictions.json").read_text())
    assert set(preds) == {"q0", "q1", "q2", "q3"}


def test_cli_squad_resume_and_accum_steps(tmp_path):
    flags = ["bert-squad", *TINY_FLAGS, "--batch-size", "4",
             "--max-seq-length", "32", "--steps-per-epoch", "2",
             "--epochs", "2"]
    ws = tmp_path / "run"
    state, _ = cli([*flags, "--workspace", str(ws)])
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    # as if stopped after the first epoch: --resume restores its checkpoint
    # (weights, moments, step, dropout generator) and runs the second
    (ws / "bert_squad_ckpt" / "ckpt_4.pt").unlink()
    state, _ = cli([*flags, "--workspace", str(ws), "--resume"])
    assert state.step == 4
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=0, msg=n)
    # two microbatches of 2: fp32 grads summed and halved, close to one step
    state, _ = cli([*flags, "--workspace", str(tmp_path / "accum"),
                    "--accum-steps", "2", "--amp", "false"])
    assert state.step == 4


def test_cli_glue_and_swag_files(tmp_path):
    vocab = _vocab_file(tmp_path / "vocab.txt")
    _write_glue(tmp_path / "cola", 10, 0)
    state, out = cli(["bert-glue", *TINY_FLAGS, "--task-name", "cola",
                      "--batch-size", "4", "--data-dir", str(tmp_path / "cola"),
                      "--vocab-file", vocab, "--workspace", str(tmp_path)])
    assert state.step == 2  # 10 rows, whole batches of 4
    assert set(out) == {"dev.accuracy", "dev.mcc"} and -1 <= out["dev.mcc"] <= 1
    swag = tmp_path / "swag"
    swag.mkdir()
    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("val", 5)):
        with open(swag / f"{split}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["sent1", "sent2", *(f"ending{i}" for i in range(4)),
                        "label"])
            for _ in range(n):
                w.writerow([" ".join(rng.choice(WORDS, size=4)) for _ in range(6)]
                           + [int(rng.integers(0, 4))])
    state, out = cli(["bert-swag", *TINY_FLAGS, "--batch-size", "4",
                      "--data-dir", str(swag), "--vocab-file", vocab,
                      "--workspace", str(tmp_path)])
    assert state.step == 2 and 0.0 <= out["val.accuracy"] <= 1.0


def test_cli_finetune_lr_never_falls_back_and_flags_refused(tmp_path):
    """``cfg.lr or 3e-5`` (JAX cli/main.py) never falls back: CommonConfig's
    lr is 0.1, in both packages, so bert-squad without --lr tunes at 0.1."""
    assert SquadCliConfig().lr == JaxSquadCliConfig().lr == 0.1
    with mock.patch.object(cli_main, "bert_adam", wraps=bert_adam) as spy:
        cli(["bert-squad", "--bert-model", "tiny", "--device", "cpu",
             "--batch-size", "2", "--max-seq-length", "32",
             "--steps-per-epoch", "1", "--workspace", str(tmp_path)])
    assert spy.call_args.args[0] == 0.1
    # --mesh-* is ported: 2 data ranks in one process is JAX's mesh error
    with pytest.raises(ValueError, match="!= 1 devices"):
        cli(["bert-squad", *TINY_FLAGS, "--mesh-data", "2"])
    (tmp_path / "model.ckpt.index").write_text("")
    with pytest.raises(SystemExit, match="TF checkpoint"):
        cli(["bert-glue", *TINY_FLAGS, "--init-checkpoint",
             str(tmp_path / "model.ckpt"), "--workspace", str(tmp_path)])
    with pytest.raises(SystemExit, match="bert_adam or adamw"):
        cli(["bert-swag", *TINY_FLAGS, "--optimizer", "sgd",
             "--workspace", str(tmp_path), "--steps-per-epoch", "1",
             "--batch-size", "2", "--max-seq-length", "32"])
    with pytest.raises(SystemExit):  # not a flag of dlx-train's bert-squad
        cli(["bert-squad", *TINY_FLAGS, "--zero"])


def test_eval_fn_keeps_the_dropout_bits_and_the_mode(qa_params):
    """An eval_fn that draws from the generator and switches the model to
    eval mode changes nothing of the training: the weights after two epochs
    equal a run without it, bit for bit."""
    cfg = dict(TINY, hidden_dropout=0.1, attention_dropout=0.1)
    batch = _t(_squad_batch(8))
    seen = []

    def eval_fn(state):
        torch.randint(0, 10, (4,), generator=state.generator)
        state.model.eval()
        seen.append(state.step)
        return {"f1": 1.0}

    out = []
    for fn in (None, eval_fn):
        model = _load(BertForQuestionAnswering(BertConfig(**cfg), torch.float32),
                      bert_qa_state_dict_from_jax(qa_params)).train()
        task = BertSquadTask(BertConfig(**cfg), torch.float32)
        params = dict(model.named_parameters())
        tx = _bert_finetune_tx("adamw", 1e-2, 4, params)
        state = create_train_state(model, tx, 1, params=params)
        state, best = train_loop(
            state, make_train_step(task.loss_fn, tx), lambda: [batch] * 2,
            cfg=LoopConfig(epochs=2, watch_metric="f1", watch_mode="max"),
            logger=Logger(backends=[]), eval_fn=fn)
        assert state.model.training
        out.append({n: p.detach().clone() for n, p in model.named_parameters()})
    assert seen == [2, 4] and best == 1.0
    for n, p in out[0].items():
        torch.testing.assert_close(out[1][n], p, rtol=0, atol=0, msg=n)


def test_predict_squad_runs_on_the_training_model():
    """The training model (fp32 weights, bf16 compute) and the serving model
    made from the same seed give logits a bf16 rounding apart."""
    task = BertSquadTask(BertConfig(**TINY), torch.bfloat16)
    train = task.init_train(torch.Generator().manual_seed(0), device="cpu")
    serve = task.init(torch.Generator().manual_seed(0), device="cpu")
    assert train.training and all(p.dtype == torch.float32
                                  for p in train.parameters())
    assert serve.bert.embeddings.word_embeddings.weight.dtype == torch.bfloat16
    batch = _t(_inputs(9))
    for got, want in zip(task.predict_fn(train, batch),
                         task.predict_fn(serve, batch)):
        assert got.dtype == torch.float32
        # bf16 rounds the weights on both sides, at other points
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2)
