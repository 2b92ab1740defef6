"""The port's serving path on the CPU: the batcher and HTTP server around a
small BERT QA model, and ``predict_squad`` against the JAX package's."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertSquadTask as JaxSquadTask
from deeplearningexamples_tpu.models.bert import predict_squad as jax_predict_squad
from deeplearningexamples_tpu_torch.data.squad import (
    convert_examples_to_features,
    read_squad_examples,
)
from deeplearningexamples_tpu_torch.data.tokenization import BertTokenizer
from deeplearningexamples_tpu_torch.models.bert import (
    BertConfig,
    BertForQuestionAnswering,
    BertSquadTask,
    predict_squad,
)
from deeplearningexamples_tpu_torch.serving import (
    ContinuousBatcher,
    InferenceServer,
    ModelEndpoint,
    http_infer,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_qa_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

SMALL = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position_embeddings=64)
S = 64
INPUTS = ("input_ids", "attention_mask", "token_type_ids")
# fp32 on the CPU: a request served in a batch of 4 and the same request in
# a batch of its own differ only in the GEMMs' blocking
ATOL_SERVED = 1e-5


def _request(rng):
    n = int(rng.integers(20, S + 1))
    ids = np.zeros(S, np.int32)
    ids[:n] = rng.integers(5, SMALL["vocab_size"], size=n)
    mask = (np.arange(S) < n).astype(np.int32)
    seg = ((np.arange(S) >= n // 2) & (mask > 0)).astype(np.int32)
    return dict(zip(INPUTS, (ids, mask, seg)))


@pytest.fixture(scope="module")
def served():
    task = BertSquadTask(BertConfig(**SMALL), dtype=torch.float32)
    model = task.init(torch.Generator().manual_seed(0), device="cpu")

    def infer(batch):
        start, end = task.predict_fn(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
        return {"start_logits": start, "end_logits": end}

    batcher = ContinuousBatcher(infer, batch_buckets=(1, 2, 4),
                                max_delay_s=0.05)
    batcher.warmup(_request(np.random.default_rng(9)))
    srv = InferenceServer(port=0)
    srv.register(ModelEndpoint(
        name="bert_qa", batcher=batcher,
        input_spec={k: ((S,), "int32") for k in INPUTS},
        output_names=("start_logits", "end_logits")))
    srv.start()
    yield srv, infer
    srv.stop()


def test_http_json_and_binary_match_direct_forward(served):
    srv, infer = served
    rng = np.random.default_rng(0)
    reqs = [_request(rng) for _ in range(6)]
    results = [None] * len(reqs)

    def client(i):
        results[i] = http_infer(srv.addr, "bert_qa", reqs[i], binary=i % 2 == 1)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    direct = infer({k: np.stack([r[k] for r in reqs]) for k in INPUTS})
    for i, res in enumerate(results):
        for name in ("start_logits", "end_logits"):
            got = np.asarray(res["outputs"][name], np.float32)
            assert got.shape == (S,)
            np.testing.assert_allclose(got, direct[name][i].numpy(),
                                       atol=ATOL_SERVED, rtol=ATOL_SERVED)
    base = f"http://{srv.addr[0]}:{srv.addr[1]}/v2"
    with urllib.request.urlopen(f"{base}/health/ready") as r:
        assert json.loads(r.read())["ready"]
    with urllib.request.urlopen(f"{base}/models/bert_qa/stats") as r:
        stats = json.loads(r.read())
    assert stats["dispatches"] >= 1 and 1 <= stats["mean_batch"] <= 4
    assert stats["device_ms_p95"] >= stats["device_ms_p50"] > 0


def test_http_errors(served):
    srv, _ = served
    bad = _request(np.random.default_rng(1))
    bad["input_ids"] = bad["input_ids"][:10]
    with pytest.raises(urllib.error.HTTPError) as exc:
        http_infer(srv.addr, "bert_qa", bad)
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        http_infer(srv.addr, "nosuch", _request(np.random.default_rng(2)))
    assert exc.value.code == 404


def test_batcher_pads_to_buckets_and_propagates_errors():
    sizes = []

    def double(batch):
        sizes.append(batch["x"].shape[0])
        return {"y": torch.from_numpy(batch["x"]) * 2.0}

    b = ContinuousBatcher(double, batch_buckets=(1, 2, 4), max_delay_s=0.05)
    try:
        futs = [b.submit({"x": np.full((3,), i, np.float32)}) for i in range(3)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(10)["y"], 2.0 * i)
        assert all(n in (1, 2, 4) for n in sizes)
    finally:
        b.close()

    def fail(batch):
        raise RuntimeError("kaboom")

    b = ContinuousBatcher(fail, batch_buckets=(1, 2))
    try:
        with pytest.raises(RuntimeError, match="kaboom"):
            b.infer({"x": np.ones(2, np.float32)}, timeout=10)
    finally:
        b.close()


DEV = {"data": [{"paragraphs": [{
    "context": "The cat sat on the mat. A dog ran fast. "
               "Birds sing in the morning light.",
    "qas": [
        {"id": "q1", "question": "What sat on the mat?",
         "answers": [{"text": "cat", "answer_start": 4}]},
        {"id": "q2", "question": "What ran fast?",
         "answers": [{"text": "A dog", "answer_start": 24}]},
        {"id": "q3", "question": "When do birds sing?",
         "answers": [{"text": "morning", "answer_start": 58}]},
    ],
}]}]}


def test_predict_squad_matches_jax(tmp_path):
    path = tmp_path / "dev.json"
    path.write_text(json.dumps(DEV))
    words = sorted({w for t in (DEV["data"][0]["paragraphs"][0]["context"],
                                *(q["question"] for q in
                                  DEV["data"][0]["paragraphs"][0]["qas"]))
                    for w in BertTokenizer({}).basic.tokenize(t)})
    vocab = {w: i for i, w in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)}
    feats = convert_examples_to_features(
        read_squad_examples(str(path), is_training=False), BertTokenizer(vocab),
        max_seq_length=S, doc_stride=16, is_training=False)
    assert len(feats) >= 3

    cfg = dict(SMALL, vocab_size=len(vocab))
    jtask = JaxSquadTask(JaxBertConfig(**cfg), dtype=jnp.float32)
    params, _ = jtask.init(jax.random.key(1), seq_len=S, batch=1)
    with jax.default_matmul_precision("highest"):
        want = jax_predict_squad(jtask, params, feats, batch_size=2)

    task = BertSquadTask(BertConfig(**cfg), dtype=torch.float32)
    model = BertForQuestionAnswering(BertConfig(**cfg))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           bert_qa_state_dict_from_jax(params).items()})
    got = predict_squad(task, task.place(model, "cpu"), feats, batch_size=2)
    assert got == want
    context = DEV["data"][0]["paragraphs"][0]["context"]
    assert set(got) == {"q1", "q2", "q3"}
    assert all(text and text in context for text in got.values())
