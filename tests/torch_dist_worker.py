"""A rank of the port's multi-process CPU checks (``tests/test_torch_parallel.py``).

``python tests/torch_dist_worker.py RANK WORLD PORT DIR`` joins a gloo group
of WORLD ranks at ``127.0.0.1:PORT`` through ``initialize_distributed``'s
explicit arguments, reads the inputs the test wrote to ``DIR/inputs.pt``,
runs every check on the meshes the checks name, and writes what it measured
to ``DIR/rank{RANK}.pt``. It imports torch and the port only, never JAX: the
test holds the results against JAX's single-device run of the global batch,
and against the port's own run in one process. The functions that build and
train each model are the same ones the test runs in one process.
"""

from __future__ import annotations

import itertools
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from deeplearningexamples_tpu_torch.core import optimizers as opt  # noqa: E402
from deeplearningexamples_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from deeplearningexamples_tpu_torch.core.flat import flatten_train  # noqa: E402
from deeplearningexamples_tpu_torch.core.optimizers import lr_poly_warmup  # noqa: E402
from deeplearningexamples_tpu_torch.core.train import (  # noqa: E402
    create_train_state, make_train_step,
)
from deeplearningexamples_tpu_torch.models.bert import (  # noqa: E402
    BertConfig, BertForPreTraining, BertPretrainTask, modeling,
)
from deeplearningexamples_tpu_torch.models.convnets import (  # noqa: E402
    ClassificationTask, ResNet, ResNetArch,
)
from deeplearningexamples_tpu_torch.models.dlrm import (  # noqa: E402
    Dlrm, DlrmConfig, DlrmTask, make_dlrm_optimizer,
)
from deeplearningexamples_tpu_torch.ops.lamb import lamb  # noqa: E402
from deeplearningexamples_tpu_torch.parallel import mesh  # noqa: E402
from deeplearningexamples_tpu_torch.parallel.dist import (  # noqa: E402
    initialize_distributed,
)
from deeplearningexamples_tpu_torch.parallel.zero import ZeroPlan  # noqa: E402
from deeplearningexamples_tpu_torch.utils.jax_bridge import (  # noqa: E402
    bert_pretrain_jax_order,
)

# -- the models, as the test builds them too ---------------------------------


def _load(model, sd) -> None:
    """A whole state dict into a model whose sharded tensors hold rows."""
    with torch.no_grad():
        for name, t in {**dict(model.named_parameters()),
                        **dict(model.named_buffers())}.items():
            if name in sd:
                t.copy_(mesh.shard_rows_of(t, torch.tensor(sd[name])))


def patch_attention_seeds(seeds) -> None:
    """K1's dropout seed per layer, the same every step and microbatch, as
    the test's patched JAX trace gives them."""
    cycle = itertools.cycle(seeds)
    modeling.attention_seed = lambda generator: int(next(cycle))


BERT_TOTAL = 4  # the LR schedule's length: 3 steps, then a resumed fourth


def run_bert(cfg: dict, sd: dict, batch: dict, predictions: int, *,
             steps: int, lr: float, flat: bool = False, accum: int = 1,
             zero: bool = False, seed: int = 1):
    """``steps`` LAMB steps (bf16 moments; the poly schedule over
    ``BERT_TOTAL``) on the global ``batch``, fp32: (losses, state,
    (train_step, this rank's batch))."""
    model = BertForPreTraining(BertConfig(**cfg), torch.float32)
    _load(model, sd)
    task = BertPretrainTask(BertConfig(**cfg), torch.float32,
                            max_predictions=predictions)
    sched = lr_poly_warmup(lr, 1, BERT_TOTAL)
    if flat:
        tx, params, _ = flatten_train(
            model, lr=sched, weight_decay=0.01, moment_dtype=torch.bfloat16,
            order=bert_pretrain_jax_order(cfg["num_layers"]))
    else:
        params = dict(model.named_parameters())
        tx = lamb(sched, weight_decay=0.01, moment_dtype=torch.bfloat16,
                  mask={n: p.ndim > 1 for n, p in params.items()},
                  zero=ZeroPlan(params) if zero else None)
    state = create_train_state(model, tx, seed, params=params)
    step = make_train_step(task.loss_fn, tx, accum_steps=accum)
    tb = mesh.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                          accum)
    losses = []
    for _ in range(steps):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    return losses, state, (step, tb)


def bert_params(state) -> dict:
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def run_resnet(arch: dict, classes: int, sd: dict, images, labels):
    """One SGD step at rate 0 on the global batch: (the data axis's mean
    gradients, the BN buffers after the step)."""
    model = ResNet(ResNetArch(**arch), classes, torch.float32)
    _load(model, sd)
    model.train()
    task = ClassificationTask("resnet50", torch.float32, num_classes=classes)
    tx = opt.sgd(0.0, 0.0)
    state = create_train_state(model, tx, 1)
    step = make_train_step(task.loss_fn, tx)
    batch = mesh.shard_batch({"image": torch.as_tensor(images),
                              "label": torch.as_tensor(labels)})
    state, _ = step(state, batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return grads, {n: b.clone() for n, b in model.named_buffers()}


def run_dlrm(cfg: dict, sd: dict, batch: dict, steps: int):
    """``steps`` dual-SGD steps on the global batch: (losses, the whole
    parameters, this rank's table rows, the steps' ``grad_norm``)."""
    model = Dlrm(DlrmConfig(**cfg), torch.float32)
    _load(model, sd)
    task = DlrmTask(DlrmConfig(**cfg), torch.float32)
    tx = make_dlrm_optimizer(mlp_lr=0.05, embedding_lr=0.7)
    state = create_train_state(model, tx, 1)
    step = make_train_step(task.loss_fn, tx)
    tb = mesh.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()})
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = {n: mesh.gather_sharded(p).detach().clone()
             for n, p in model.named_parameters()}
    return losses, whole, model.embedding_table.shape[0], norms


# -- the checks ----------------------------------------------------------------


def _check_transposes() -> dict:
    """The two differentiable sums' backward on rank-dependent inputs."""
    r = float(mesh.current_mesh().index(mesh.DATA_AXIS) + 1)
    out = {}
    for name, fn in (("over_ranks", mesh.sum_over_ranks),
                     ("partials", lambda x: mesh.sum_partials(x, mesh.DATA_AXIS))):
        x = torch.full((3,), r, requires_grad=True)
        (fn(x) * r).sum().backward()
        out[name] = x.grad.clone()
    return out


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    info = initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                  device="cpu")
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res: dict = {"info": info}
    data2 = mesh.MeshSpec(data=2)
    model2 = mesh.MeshSpec(data=1, model=2)

    m = mesh.build_mesh(data2)
    res["coords"] = dict(m.coords)
    res["transposes"] = _check_transposes()
    b = inp["bert"]
    drawn = modeling.attention_seed
    patch_attention_seeds(b["seeds"])
    for name, kw in (("tree", {}), ("accum", dict(accum=2)),
                     ("flat", dict(flat=True)), ("zero", dict(zero=True))):
        losses, state, (step, tb) = run_bert(
            b["cfg"], b["sd"], b["batch"], b["p"], steps=3, lr=b["lr"], **kw)
        res[f"bert_{name}"] = {"losses": losses, "params": bert_params(state)}
        if name == "zero":
            res["zero_mu_rows"] = {n: t.shape[0]
                                   for n, t in state.opt_state.mu.items()}
            ckpt = CheckpointManager(os.path.join(out_dir, "zero_ckpt"))
            ckpt.save(int(state.step), state)
            state, m4 = step(state, tb)  # the step a resumed run takes next
            res["zero_step4"] = {"loss": float(m4["loss"]),
                                 "params": bert_params(state)}
    modeling.attention_seed = drawn  # hidden dropout on, seeds drawn
    losses, state, _ = run_bert(inp["hidden_cfg"], b["sd"], b["batch"],
                                b["p"], steps=2, lr=b["lr"])
    res["bert_hidden"] = {"losses": losses, "params": bert_params(state)}

    r = inp["resnet"]
    res["resnet"] = run_resnet(r["arch"], r["classes"], r["sd"], r["images"],
                               r["labels"])
    d = inp["dlrm"]
    res["dlrm_data"] = run_dlrm(d["cfg"], d["sd"], d["batch"], 3)

    from deeplearningexamples_tpu_torch.cli.main import cli

    state, best = cli([*inp["cli_dlrm"], "--mesh-data", "2", "--workspace",
                       os.path.join(out_dir, f"cli_dlrm_{rank}")])
    res["cli_dlrm"] = {"auc": best, "params": {
        n: p.detach().clone() for n, p in state.model.named_parameters()}}
    # a training batch that does not split evenly over the data ranks
    for name, args in (
            ("odd", [*inp["cli_dlrm"], "--batch-size", "63"]),
            ("odd_accum", ["resnet50", "--device", "cpu", "--batch-size",
                           "6", "--accum-steps", "2"])):
        try:
            cli([*args, "--mesh-data", "2", "--workspace",
                 os.path.join(out_dir, f"cli_{name}_{rank}")])
            res[f"cli_{name}"] = None
        except ValueError as e:
            res[f"cli_{name}"] = str(e)

    mesh.build_mesh(model2)
    res["dlrm_model"] = run_dlrm(d["cfg"], d["sd"], d["batch"], 3)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
