"""Port parity: BERT pretraining on a tokenized corpus, ``--remat``,
``--attention-impl xla`` and distillation, against the JAX package.

A corpus and a vocabulary that the test writes go through both packages'
``prepare_corpus`` into identical shard files; both packages' loaders
(plain and binned) give the same batches bit for bit from the same seed;
``build_bert_pretrain`` on that corpus, with JAX's weights through the
bridge and dropout off, gives JAX's first-batch loss in fp32, with flash
attention and with the plain ("xla") path. ``--remat`` keeps the gradients
of a step with dropout on bit for bit. The distillation losses and their
gradients match JAX's with a 4-layer teacher and a 2-layer student of
another width (head dim 24, through ``distill_proj``). The JAX side runs
its Pallas kernels in interpret mode, under ``jax.jit``; torch runs on one
thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.data import bert_prep as jax_prep
from deeplearningexamples_tpu.data import bert_pretrain as jax_pretrain
from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertModel as JaxBertModel
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.models.bert.distillation import (
    DistillationTask as JaxDistillationTask,
)
from deeplearningexamples_tpu_torch.cli.main import BertCliConfig, build_bert_pretrain, cli
from deeplearningexamples_tpu_torch.data import bert_prep, bert_pretrain
from deeplearningexamples_tpu_torch.models.bert import BERT_CONFIGS, BertConfig, BertPretrainTask
from deeplearningexamples_tpu_torch.models.bert.distillation import (
    STUDENT_CONFIGS,
    DistillationTask,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_model_state_dict_from_jax,
    bert_pretrain_state_dict_from_jax,
    distill_student_state_dict_from_jax,
)

# the tiny config without dropout: jax.random's bits cannot be matched
TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=512,
            hidden_dropout=0.0, attention_dropout=0.0)
B, P = 4, 5


@pytest.fixture(autouse=True)
def _exact_fp32_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _write_corpus(root):
    """Two text files of blank-line-separated documents (capitalised
    sentences of 2 to 24 words, so pairs fill both 64-token bins) and a
    vocabulary holding every word: ids below the tiny config's 1024."""
    rng = np.random.default_rng(0)
    syll = ["ka", "lo", "mi", "ne", "tu", "ra", "si", "vo", "de", "pa"]
    words = sorted({"".join(rng.choice(syll, size=rng.integers(1, 4)))
                    for _ in range(400)})
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","] + words)
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    for f in range(2):
        docs = []
        for _ in range(14):
            sents = []
            for _ in range(rng.integers(3, 12)):
                ws = list(rng.choice(words, size=rng.integers(2, 25)))
                sents.append(" ".join(ws).capitalize() + ".")
            # several sentences on a line, and a line per few sentences
            lines = [" ".join(sents[i:i + 3]) for i in range(0, len(sents), 3)]
            docs.append("\n".join(lines))
        (root / f"part_{f}.txt").write_text("\n\n".join(docs) + "\n")
    return str(root / "vocab.txt")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus written by both packages' ``prepare_corpus``; returns
    (the port's shard directory, its documents)."""
    root = tmp_path_factory.mktemp("corpus")
    vocab = _write_corpus(root)
    for name, mod in (("jax", jax_prep), ("port", bert_prep)):
        n = mod.prepare_corpus(str(root / "part_*.txt"), vocab,
                               str(root / name), n_shards=2)
        assert n == 28
    return str(root / "port"), bert_prep.load_corpus_shards(str(root / "port"))


def test_shards_and_documents_are_jax_bit_for_bit(corpus):
    out_dir, docs = corpus
    root = out_dir.rsplit("/", 1)[0]
    for shard in ("shard_0000.npz", "shard_0001.npz"):
        with np.load(f"{root}/jax/{shard}") as a, np.load(f"{root}/port/{shard}") as b:
            assert sorted(a.files) == sorted(b.files) == [
                "doc_offsets", "sent_offsets", "tokens"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jdocs = jax_prep.load_corpus_shards(f"{root}/jax")
    assert len(docs) == len(jdocs) == 28
    for d, jd in zip(docs, jdocs):
        assert len(d) == len(jd)
        for s, js in zip(d, jd):
            np.testing.assert_array_equal(s, js)
    text = 'He said "Go." Then J. K. left! Is it 3 p.m.? (Yes.) 42 went.'
    assert bert_prep.segment_sentences(text) == jax_prep.segment_sentences(text)


@pytest.mark.parametrize("binned", [False, True])
def test_loaders_give_jax_batches_bit_for_bit(corpus, binned):
    """Two epochs of three batches: [CLS] A [SEP] B [SEP], NSP 50/50 and the
    80/10/10 masking from the same numpy draws; the binned loader pads each
    batch to its 64-multiple bucket."""
    _, docs = corpus
    cfg = dict(vocab_size=1024, max_predictions_per_seq=P)
    mine = (bert_pretrain.BinnedBertPretrainLoader if binned
            else bert_pretrain.BertPretrainLoader)(
        docs, B, 128, bert_pretrain.MaskingConfig(**cfg), seed=3,
        steps_per_epoch=3)
    theirs = (jax_pretrain.BinnedBertPretrainLoader if binned
              else jax_pretrain.BertPretrainLoader)(
        docs, B, 128, jax_pretrain.MaskingConfig(**cfg), seed=3,
        steps_per_epoch=3)
    lengths = set()
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            lengths.add(g["input_ids"].shape[1])
            assert ((g["mlm_labels"] >= 0).sum(1) <= P).all()
    assert lengths == ({64, 128} if binned else {128})


def _jax_loss(task, params, batch):
    return jax.jit(lambda p, b: task.loss_fn(p, {}, b, jax.random.key(1))[0])(
        params, batch)


@pytest.mark.parametrize("mode", ["flash", "binned", "xla"])
def test_bert_pretrain_on_the_corpus_matches_jax(corpus, mode, monkeypatch, tmp_path):
    """``build_bert_pretrain`` with ``--data-backend corpus`` (``--binned``,
    ``--attention-impl xla``): the held-out split, the first batch equal to
    JAX's loader's, and its fp32 loss on JAX's weights equal to JAX's."""
    data_dir, docs = corpus
    monkeypatch.setitem(BERT_CONFIGS, "tiny", BertConfig(**TINY))
    impl = "xla" if mode == "xla" else "flash"
    cfg = BertCliConfig(bert_model="tiny", data_backend="corpus",
                        data_dir=data_dir, batch_size=B, seq_len=128,
                        max_predictions=P, binned=mode == "binned",
                        attention_impl=impl, amp=False, device="cpu",
                        workspace=str(tmp_path))
    run = build_bert_pretrain(cfg)
    n_eval = 2  # max(2, 28 // 100)
    assert len(run.val_loader) == 10
    assert len(run.loader) == sum(len(d) for d in docs[:-n_eval]) // B
    loader_cls = (jax_pretrain.BinnedBertPretrainLoader if mode == "binned"
                  else jax_pretrain.BertPretrainLoader)
    mcfg = jax_pretrain.MaskingConfig(vocab_size=1024, max_predictions_per_seq=P)
    want_batch = next(iter(loader_cls(docs[:-n_eval], B, 128, mcfg, seed=0)))
    batch = next(iter(run.loader))
    for k in want_batch:
        np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
    val = next(iter(run.val_loader))
    want_val = next(iter(jax_pretrain.BertPretrainLoader(
        docs[-n_eval:], B, 128, mcfg, seed=7, steps_per_epoch=10)))
    np.testing.assert_array_equal(val["input_ids"], want_val["input_ids"])

    jtask = JaxPretrainTask(JaxBertConfig(**TINY, attention_impl=impl),
                            dtype=jnp.float32, max_predictions=P)
    params = jax.jit(lambda k: jtask.init(k, seq_len=128, batch=1)[0])(
        jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = run.state.model
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           bert_pretrain_state_dict_from_jax(params).items()})
    want = _jax_loss(jtask, params, want_batch)
    with torch.no_grad():
        got, _ = run.task.loss_fn(
            model, {}, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("attention_impl", ["flash", "xla"])
def test_remat_keeps_the_gradients_bit_for_bit_with_dropout_on(corpus,
                                                                attention_impl):
    """Each checkpointed layer replays its dropout seeds in the recompute
    (the kernel's seed under "flash", the probabilities' mask under "xla"),
    so a step with dropout on gives the same loss, gradients and generator
    state as without remat."""
    _, docs = corpus
    cfg = dataclasses.replace(BERT_CONFIGS["tiny"], attention_impl=attention_impl)
    assert cfg.hidden_dropout > 0 and cfg.attention_dropout > 0
    batch = next(iter(bert_pretrain.BinnedBertPretrainLoader(
        docs, B, 128, bert_pretrain.MaskingConfig(vocab_size=1024,
                                                  max_predictions_per_seq=P),
        steps_per_epoch=1)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def step(c):
        task = BertPretrainTask(c, torch.float32, max_predictions=P)
        model = task.init(torch.Generator().manual_seed(0), device="cpu")
        gen = torch.Generator().manual_seed(11)
        loss, _ = task.loss_fn(model, {}, batch, gen)
        loss.backward()
        return (loss.detach(), gen.get_state(),
                {n: p.grad for n, p in model.named_parameters()})

    loss, state, grads = step(cfg)
    r_loss, r_state, r_grads = step(dataclasses.replace(
        cfg, remat=True))
    assert torch.equal(loss, r_loss) and torch.equal(state, r_state)
    for n, g in grads.items():
        assert torch.equal(g, r_grads[n]), n


def test_cli_trains_on_the_corpus_and_refuses_what_is_not_ported(corpus, tmp_path):
    """``--phase2 --binned``: 76 predictions a row at buckets of 64 and up
    (the task takes min(76, S) positions), with ``--remat`` and the plain
    attention path."""
    data_dir, docs = corpus
    shapes = {b["input_ids"].shape[1] for b in bert_pretrain.BinnedBertPretrainLoader(
        docs[:-2], B, 512, bert_pretrain.MaskingConfig(
            vocab_size=1024, max_predictions_per_seq=76), steps_per_epoch=3)}
    assert min(shapes) == 64
    state, best = cli([
        "bert-pretrain", "--bert-model", "tiny", "--data-backend", "corpus",
        "--data-dir", data_dir, "--phase2", "--binned", "--remat",
        "--attention-impl", "xla", "--mode", "benchmark-training",
        "--steps-per-epoch", "3", "--batch-size", str(B), "--lr", "0.01",
        "--device", "cpu", "--workspace", str(tmp_path)])
    assert state.step == 3 and np.isfinite(best)
    # --zero, --mesh-* and the ring are ported: --zero refuses --flat-lamb
    # as JAX does, and a mesh of 2 ranks in one process is JAX's mesh error
    for flags, error, match in (
            (["--zero", "--flat-lamb"], SystemExit, "mutually exclusive"),
            (["--attention-impl", "ring", "--mesh-sequence", "2"], ValueError,
             "1 devices not divisible by 2"),
            (["--mesh-data", "2"], ValueError, "!= 1 devices")):
        with pytest.raises(error, match=match):
            cli(["bert-pretrain", "--device", "cpu", "--workspace",
                 str(tmp_path), *flags])


def test_distillation_losses_and_gradients_match_jax():
    """A 4-layer teacher, a 2-layer student of width 48 (head dim 24) with
    ``distill_proj``: the layer map, the hidden MSE and its gradient, and
    ``task_distill_loss``."""
    tcfg = dict(TINY, num_layers=4, max_position_embeddings=64)
    scfg = dict(tcfg, hidden_size=48, num_layers=2, intermediate_size=96)
    jtask = JaxDistillationTask(JaxBertConfig(**tcfg), JaxBertConfig(**scfg),
                                dtype=jnp.float32)
    task = DistillationTask(BertConfig(**tcfg), BertConfig(**scfg),
                            torch.float32)
    assert task.layer_map == jtask.layer_map == [(0, 1), (1, 3)]
    s = 32
    ids = jnp.zeros((1, s), jnp.int32)
    t_params = jax.jit(lambda k: JaxBertModel(JaxBertConfig(**tcfg), jnp.float32)
                       .init(k, ids, ids, ids)["params"])(jax.random.key(0))
    s_params, _ = jtask.init(jax.random.key(1), t_params, seq_len=s)
    t_params, s_params = (jax.tree_util.tree_map(np.asarray, p)
                          for p in (t_params, s_params))
    rng = np.random.default_rng(0)
    mask = (np.arange(s)[None] < np.array([[s], [s - 9], [s - 20]])).astype(np.int32)
    batch = {"input_ids": rng.integers(1, 1024, (3, s)).astype(np.int32) * mask,
             "attention_mask": mask,
             "token_type_ids": (np.arange(s)[None] >= 12).astype(np.int32) * mask}
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(t_params)(p, {}, batch, jax.random.key(2)),
        has_aux=True))(s_params)
    want_grads = distill_student_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads))

    teacher = task.teacher("cpu")
    teacher.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                             bert_model_state_dict_from_jax(t_params).items()})
    student = task.init(torch.Generator().manual_seed(0), device="cpu")
    sd = distill_student_state_dict_from_jax(s_params)
    assert set(sd) == {n for n, _ in student.named_parameters()}
    assert student.distill_proj.shape == (48, 64)
    student.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    loss, (_, m) = task.loss_fn(teacher)(
        student, {}, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert float(m["hidden_mse"]) == float(loss)
    assert all(p.grad is None for p in teacher.parameters())
    top = max(float(np.abs(g).max()) for g in want_grads.values())
    for name, p in student.named_parameters():
        # the pooler reaches no layer output: no gradient here, zeros in JAX
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        assert (p.grad is None) == name.startswith("bert.pooler."), name
        np.testing.assert_allclose(got, want_grads[name],
                                   atol=1e-5 * top, rtol=1e-4, err_msg=name)

    logits = rng.normal(size=(2, 6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, (6,)).astype(np.int32)
    for t, alpha in ((1.0, 0.5), (2.0, 0.7)):
        want = JaxDistillationTask.task_distill_loss(
            logits[0], logits[1], labels, temperature=t, alpha=alpha)
        got = DistillationTask.task_distill_loss(
            torch.from_numpy(logits[0]), torch.from_numpy(logits[1]),
            torch.from_numpy(labels), temperature=t, alpha=alpha)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert STUDENT_CONFIGS["4l-312"].head_dim == 26
