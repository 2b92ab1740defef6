"""Does the first LAMB step raise BERT's pretraining loss in the JAX package
as it does in the PyTorch port?

Both packages take the same weights (made by the JAX initialisers, carried
across with ``deeplearningexamples_tpu_torch.utils.jax_bridge``), the same
synthetic batch at B=64 S=128 (20 predictions) and the same optimizer as
``bert-pretrain``'s default: the tree NVLAMB with bf16 moments, weight decay
0.01, global-norm clip 1.0, ``lr_poly_warmup(0.006, 1, 10)`` (the CLI's
schedule over a 10-step run), bf16 compute. Each package takes two steps on
the one batch and prints the loss before each. Dropout is off on both sides
(jax.random's bits cannot be matched), and attention runs in plain ops
(``attention_impl="xla"``) so that the JAX side does not run its Pallas
kernels in interpret mode on the CPU.

It runs on the CPU (the JAX package does not run on the card's machine).
BERT-Large's width is kept and its depth is cut with ``--layers`` (default
2): a full 24-layer step of each package at B=64 needs tens of GB of host
memory. Run from the repository root:

    JAX_PLATFORMS=cpu python -m scripts.lamb_first_step [--layers 2] [--steps 2]

It prints one JSON line: each package's losses, and the rise of the second
over the first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearningexamples_tpu.core.optimizers import lr_poly_warmup as jax_poly
from deeplearningexamples_tpu.core.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from deeplearningexamples_tpu.models.bert import BERT_CONFIGS as JAX_CONFIGS
from deeplearningexamples_tpu.models.bert import BertPretrainTask as JaxPretrainTask
from deeplearningexamples_tpu.ops.lamb import lamb as jax_lamb
from deeplearningexamples_tpu_torch.core.optimizers import lr_poly_warmup
from deeplearningexamples_tpu_torch.core.train import create_train_state, make_train_step
from deeplearningexamples_tpu_torch.data.synthetic import SyntheticBertLoader
from deeplearningexamples_tpu_torch.models.bert import BERT_CONFIGS, BertForPreTraining, BertPretrainTask
from deeplearningexamples_tpu_torch.ops.lamb import lamb
from deeplearningexamples_tpu_torch.utils.jax_bridge import bert_pretrain_state_dict_from_jax

B, S, P, LR = 64, 128, 20, 0.006


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    over = dict(num_layers=args.layers, hidden_dropout=0.0,
                attention_dropout=0.0, attention_impl="xla")
    jcfg = dataclasses.replace(JAX_CONFIGS["large"], **over)
    tcfg = dataclasses.replace(BERT_CONFIGS["large"], **over)
    batch = next(iter(SyntheticBertLoader(B, S, tcfg.vocab_size, P, steps=1)))
    out = {"config": f"BERT-Large width, {args.layers} layers, B={B} S={S} "
                     f"P={P}, bf16 compute, tree NVLAMB bf16 moments, lr "
                     f"poly_warmup({LR}, 1, 10)"}

    t0 = time.perf_counter()
    jtask = JaxPretrainTask(jcfg, dtype=jnp.bfloat16, max_predictions=P)
    params = jax.jit(lambda k: jtask.init(k, seq_len=S, batch=1)[0])(
        jax.random.key(0))
    tx = jax_lamb(jax_poly(LR, 1, 10), weight_decay=0.01,
                  moment_dtype=jnp.bfloat16,
                  mask=jax.tree_util.tree_map(lambda p: p.ndim > 1, params))
    state = jax_create_train_state(params, tx, jax.random.key(1))
    step = jax_make_train_step(jtask.loss_fn, tx, donate=False)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    losses = []
    for _ in range(args.steps):
        state, m = step(state, jbatch)
        losses.append(float(m["loss"]))
    out["jax"] = losses
    out["jax_s"] = time.perf_counter() - t0
    del state, step

    t0 = time.perf_counter()
    torch.set_num_threads(8)
    model = BertForPreTraining(tcfg, torch.bfloat16)
    sd = bert_pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    task = BertPretrainTask(tcfg, torch.bfloat16, max_predictions=P)
    tparams = dict(model.named_parameters())
    ttx = lamb(lr_poly_warmup(LR, 1, 10), weight_decay=0.01,
               moment_dtype=torch.bfloat16,
               mask={n: p.ndim > 1 for n, p in tparams.items()})
    tstate = create_train_state(model, ttx, 1, params=tparams)
    tstep = make_train_step(task.loss_fn, ttx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(args.steps):
        tstate, m = tstep(tstate, tbatch)
        losses.append(float(m["loss"]))
    out["port"] = losses
    out["port_s"] = time.perf_counter() - t0
    out["rise"] = {k: out[k][1] - out[k][0] for k in ("jax", "port")}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
