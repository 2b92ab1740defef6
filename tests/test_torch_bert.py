"""Port parity: BERT question answering in torch against the JAX package.

Weights are made by the JAX initialisers and carried over with the port's
bridge; inputs come from a numpy seed. The JAX side runs its flash kernel in
interpret mode on the CPU; the torch side runs its plain attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningexamples_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearningexamples_tpu.models.bert import BertSquadTask as JaxSquadTask
from deeplearningexamples_tpu.utils.torch_import import convert_bert
from deeplearningexamples_tpu_torch.models.bert import (
    BertConfig,
    BertForQuestionAnswering,
    BertSquadTask,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import (
    bert_qa_state_dict_from_jax,
)
from torch_threads import torch_one_thread  # noqa: F401

# hidden 128 over 2 heads gives D=64, which reaches the JAX bshd kernel
SMALL = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position_embeddings=64)
B, S = 2, 64
# fp32 on both sides, JAX matmuls at "highest": only summation order differs
ATOL_F32 = 1e-4
# bf16 on both sides: flax and torch round activations to bf16 at different
# points (LayerNorm output, dense epilogues, P before PV)
ATOL_BF16 = 5e-2


@pytest.fixture(scope="module")
def jax_params():
    task = JaxSquadTask(JaxBertConfig(**SMALL), dtype=jnp.float32)
    params, _ = task.init(jax.random.key(0), seq_len=S, batch=1)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL["vocab_size"], size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    seg = np.zeros((B, S), np.int32)
    seg[:, 20:] = 1
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": seg}


def _port_model(params) -> BertForQuestionAnswering:
    model = BertForQuestionAnswering(BertConfig(**SMALL))
    sd = bert_qa_state_dict_from_jax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def test_bridge_both_ways(jax_params):
    cfg = BertConfig(**SMALL)
    model = _port_model(jax_params)
    assert model.bert.embeddings.word_embeddings.weight.shape == (
        cfg.padded_vocab, cfg.hidden_size)
    port_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_bert(port_sd, cfg.padded_vocab, cfg.num_layers)
    want = jax_params["bert"]
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(port_sd["qa_outputs.weight"].T,
                                  jax_params["qa_outputs"]["kernel"])
    np.testing.assert_array_equal(port_sd["qa_outputs.bias"],
                                  jax_params["qa_outputs"]["bias"])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_qa_forward_matches_jax(jax_params, batch, precision):
    jdtype, tdtype, atol = {
        "fp32": (jnp.float32, torch.float32, ATOL_F32),
        "bf16": (jnp.bfloat16, torch.bfloat16, ATOL_BF16),
    }[precision]
    jtask = JaxSquadTask(JaxBertConfig(**SMALL), dtype=jdtype)
    with jax.default_matmul_precision("highest"):
        want = jtask.predict_fn(jax_params, batch)
    task = BertSquadTask(BertConfig(**SMALL), dtype=tdtype)
    model = task.place(_port_model(jax_params), "cpu")
    got = task.predict_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, S)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=atol)


def test_init_follows_the_jax_initialisers():
    cfg = BertConfig(**SMALL)
    task = BertSquadTask(cfg, dtype=torch.float32)
    a = task.init(torch.Generator().manual_seed(3), device="cpu")
    b = task.init(torch.Generator().manual_seed(3), device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    layer = a.bert.encoder.layer[0]
    w = layer.intermediate.dense.weight.detach()
    assert abs(float(w.std()) - cfg.initializer_range) < 2e-3
    assert float(layer.intermediate.dense.bias.detach().abs().max()) == 0.0
    assert bool((layer.output.LayerNorm.weight == 1).all())
    assert abs(float(a.bert.embeddings.word_embeddings.weight.detach().std())
               - cfg.initializer_range) < 2e-3
    bf16 = BertSquadTask(cfg).init(torch.Generator().manual_seed(3),
                                 device="cpu")
    assert bf16.bert.pooler.dense.weight.dtype == torch.bfloat16
    assert bf16.qa_outputs.weight.dtype == torch.float32
