"""A rank of the port's sequence-axis, MoE and pipeline checks on the CPU
(``tests/test_torch_ring_attention.py``, ``test_torch_moe.py``,
``test_torch_pipeline.py``).

``python tests/torch_mesh_worker.py MODE RANK WORLD PORT DIR`` joins a gloo
group of WORLD ranks at ``127.0.0.1:PORT`` through
``initialize_distributed``'s explicit arguments, reads the inputs the test
wrote to ``DIR/inputs.pt``, runs MODE's checks (``ring``, ``moe`` or
``pipeline``) on the meshes they name, and writes what it measured to
``DIR/rank{RANK}.pt``. It imports torch and the port only, never JAX. A test
module starts its ranks once with ``spawn`` and reads them with ``collect``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from deeplearningexamples_tpu_torch.models.bert import modeling  # noqa: E402
from deeplearningexamples_tpu_torch.ops.moe import MoEConfig, MoEFeedForward  # noqa: E402
from deeplearningexamples_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from deeplearningexamples_tpu_torch.parallel import mesh  # noqa: E402
from deeplearningexamples_tpu_torch.parallel.dist import initialize_distributed  # noqa: E402
from deeplearningexamples_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from torch_dist_worker import bert_params, patch_attention_seeds, run_bert  # noqa: E402

# -- spawning ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, inputs: dict, out: Path, world: int = 4) -> list:
    """Write ``inputs`` and start ``world`` ranks of ``mode`` (torch on one
    thread each)."""
    torch.save(inputs, out / "inputs.pt")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__)), mode, str(r), str(world),
         str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(procs: list, out: Path, timeout: float = 240) -> list[dict]:
    """Each rank's results, once every rank has exited 0."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


# -- the checks ----------------------------------------------------------------


def _ring_cases(inp: dict) -> dict:
    """Each case's output and the gradients of ``sum(out * g)`` on a
    ``sequence=4`` line."""
    mesh.build_mesh(mesh.MeshSpec(data=1, sequence=4))
    res = {}
    for name, kw in inp["cases"].items():
        kw = dict(kw)
        q, k, v = (inp[n].clone().requires_grad_() for n in "qkv")
        mask = inp["mask"] if kw.pop("masked", False) else None
        out = ring_attention(q, k, v, mask, **kw)
        (out * inp["g"]).sum().backward()
        res[name] = {"out": out.detach(), "dq": q.grad, "dk": k.grad,
                     "dv": v.grad}
    return res


def _ring_bert(inp: dict) -> dict:
    """Tiny BERT with the ring at (data 2, sequence 2): one LAMB step with
    K1's seeds handed in (the gradients are the step's, after the data
    axis's mean), then two steps with hidden dropout on and the seeds drawn
    from the generator."""
    b = inp["bert"]
    mesh.build_mesh(mesh.MeshSpec(data=2, sequence=2))
    drawn = modeling.attention_seed
    patch_attention_seeds(b["seeds"])
    try:
        losses, state, _ = run_bert(b["cfg"], b["sd"], b["batch"], b["p"],
                                    steps=1, lr=b["lr"])
    finally:
        modeling.attention_seed = drawn
    res = {"losses": losses, "params": bert_params(state),
           "grads": {n: p.grad.clone()
                     for n, p in state.model.named_parameters()}}
    losses, state, _ = run_bert(b["hidden_cfg"], b["sd"], b["batch"], b["p"],
                                steps=2, lr=b["lr"])
    res["hidden"] = {"losses": losses, "params": bert_params(state)}
    return res


def _moe(inp: dict) -> dict:
    """The layer on a (data 2, model 2) mesh, 4 experts a rank, every rank
    on the whole batch: its output, aux and the gradients of ``mean(y^2) +
    0.01 aux`` (the experts' gathered whole)."""
    mesh.build_mesh(mesh.MeshSpec(data=2, model=2))
    res = {}
    for name, c in inp["cases"].items():
        cfg = MoEConfig(**c["cfg"])
        layer = MoEFeedForward(cfg)
        layer.load_state_dict({n: mesh.shard_rows_of(t, c["sd"][n])
                               for n, t in layer.named_parameters()})
        x = c["x"].clone().requires_grad_()
        y, aux = layer(x)
        ((y ** 2).mean() + 0.01 * aux).backward()
        res[name] = {"y": y.detach(), "aux": aux.detach(), "dx": x.grad,
                     "experts": layer.wi.shape[0],
                     "grads": {n: mesh.all_gather_rows(p.grad, mesh.MODEL_AXIS)
                               if n in ("wi", "wo") else p.grad
                               for n, p in layer.named_parameters()}}
    return res


def stage_fn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """JAX's test stage: a residual tanh-GELU dense layer."""
    return x + F.gelu(x @ p["w"] + p["b"], approximate="tanh")


def _pipeline(inp: dict) -> dict:
    """4 stages on a model=4 line (M of 1, 4 and 13, remat off and on: the
    output and the gradients of ``mean((y - tgt)^2)``, each stage's slice
    summed over the line), then DPxPP at (data 2, model 2) on the first two
    stages' halves of the batch."""
    mesh.build_mesh(mesh.MeshSpec(data=1, model=4))
    res = {}
    for name, c in inp["cases"].items():
        params = {k: v.clone().requires_grad_() for k, v in inp["stacked"].items()}
        x = c["x"].clone().requires_grad_()
        y = pipeline_apply(stage_fn, params, x, remat=c["remat"])
        ((y - c["tgt"]) ** 2).mean().backward()
        grads = {k: mesh.all_reduce_(p.grad.clone(), mesh.MODEL_AXIS)
                 for k, p in params.items()}
        res[name] = {"y": y.detach(), "grads": grads, "dx": x.grad}
    try:
        pipeline_apply(stage_fn, {k: v[:2] for k, v in inp["stacked"].items()},
                       inp["cases"]["m4"]["x"])
    except ValueError as e:
        res["mismatch"] = str(e)
    m = mesh.build_mesh(mesh.MeshSpec(data=2, model=2))
    two = {k: v[:2].clone().requires_grad_() for k, v in inp["stacked"].items()}
    y = pipeline_apply(stage_fn, two, inp["dp"]["x"], batch_axis="data")
    (y ** 2).sum().backward()
    res["dp"] = {"y": y.detach(), "data": m.index(mesh.DATA_AXIS),
                 "grads": {k: mesh.all_reduce_(mesh.all_reduce_(
                     p.grad.clone(), mesh.MODEL_AXIS), mesh.DATA_AXIS)
                           for k, p in two.items()}}
    return res


def _ring(inp: dict) -> dict:
    return {"cases": _ring_cases(inp), "bert": _ring_bert(inp)}


CHECKS = {"ring": _ring, "moe": _moe, "pipeline": _pipeline}


def main(mode: str, rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res = {"coords": dict(mesh.build_mesh(mesh.MeshSpec(data=-1)).coords),
           **CHECKS[mode](inp)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
