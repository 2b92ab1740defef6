"""The port's GPipe ``pipeline_apply`` at four stages against the JAX
package's on its CPU mesh and against the stages run one after another.

JAX's test stage (a residual tanh-GELU dense layer of width 16), 4 stages
with their parameters drawn from numpy and stacked by JAX's
``stack_stage_params``, carried into the port by ``stacked_stages_from_jax``.
One spawn of four ranks (``tests/torch_mesh_worker.py``) runs the pipe on a
``model=4`` line at M of 1, 4 and 13 microbatches of 4 rows (13 with remat
too), and DPxPP on a (data 2, model 2) mesh (two stages, 8 rows a
microbatch split over the data ranks), while this process runs JAX's side (a
``model=4`` mesh; DPxPP on four of its devices). fp32 on both sides
(JAX's einsums at "highest"): outputs within 1e-5 of JAX's, gradients of
``mean((y - tgt)^2)`` within 1e-5 of each tensor's largest entry; against
the port's own sequential run, which is the same arithmetic, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from torch import nn

from deeplearningexamples_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearningexamples_tpu.parallel import build_mesh as jax_build_mesh
from deeplearningexamples_tpu.parallel.pipeline import (
    pipeline_apply as jax_pipeline_apply,
    stack_stage_params as jax_stack_stage_params,
)
from deeplearningexamples_tpu_torch.parallel import mesh
from deeplearningexamples_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from deeplearningexamples_tpu_torch.utils.jax_bridge import stacked_stages_from_jax
from torch_mesh_worker import collect, spawn, stage_fn
from torch_threads import torch_one_thread  # noqa: F401

DIM, STAGES, MB = 16, 4, 4
CASES = {"m1": (1, False), "m4": (4, False), "m13": (13, False),
         "m13_remat": (13, True)}


def _jax_stage(p, x):
    h = jnp.einsum("...d,de->...e", x, p["w"],
                   preferred_element_type=jnp.float32).astype(x.dtype)
    return x + jax.nn.gelu(h + p["b"])


def _stacked() -> dict:
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(np.asarray, jax_stack_stage_params([
        {"w": (rng.standard_normal((DIM, DIM)) * 0.2).astype(np.float32),
         "b": (rng.standard_normal(DIM) * 0.1).astype(np.float32)}
        for _ in range(STAGES)]))


def _draw(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _sequential(stacked: dict, x: torch.Tensor) -> torch.Tensor:
    """The stages one after another on each microbatch."""
    n = next(iter(stacked.values())).shape[0]
    out = []
    for xe in x:
        for s in range(n):
            xe = stage_fn({k: v[s] for k, v in stacked.items()}, xe)
        out.append(xe)
    return torch.stack(out)


def _jax_side(stacked: dict, cases: dict, dp_x: np.ndarray) -> dict:
    pipe = jax_build_mesh(JaxMeshSpec(data=-1, model=STAGES))
    params = jax.tree_util.tree_map(jnp.asarray, stacked)
    out = {}
    with jax.default_matmul_precision("highest"):
        for name, c in cases.items():
            def loss(p, x, tgt=c["tgt"], remat=c["remat"]):
                y = jax_pipeline_apply(_jax_stage, p, x, mesh=pipe,
                                       remat=remat)
                return jnp.mean((y - tgt) ** 2), y

            (_, y), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, c["x"])
            out[name] = {"y": np.asarray(y), "dx": np.asarray(grads[1]),
                         "grads": stacked_stages_from_jax(
                             jax.tree_util.tree_map(np.asarray, grads[0]))}
        dp = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2, 1),
                     ("data", "model", "sequence"))
        two = jax.tree_util.tree_map(lambda a: a[:2], params)

        def dp_loss(p, x):
            y = jax_pipeline_apply(_jax_stage, p, x, mesh=dp,
                                   batch_axis="data")
            return jnp.sum(y ** 2), y

        (_, y), grads = jax.jit(jax.value_and_grad(dp_loss, has_aux=True))(
            two, dp_x)
    out["dp"] = {"y": np.asarray(y), "grads": stacked_stages_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    stacked = _stacked()
    cases = {name: {"x": _draw(m, (m, MB, DIM)),
                    "tgt": _draw(100 + m, (m, MB, DIM)), "remat": remat}
             for name, (m, remat) in CASES.items()}
    dp_x = _draw(7, (4, 8, DIM))
    out = tmp_path_factory.mktemp("pipeline")
    torch_stacked = {k: torch.tensor(v)
                     for k, v in stacked_stages_from_jax(stacked).items()}
    procs = spawn("pipeline", {
        "stacked": torch_stacked,
        "cases": {n: {k: torch.tensor(v) if k != "remat" else v
                      for k, v in c.items()} for n, c in cases.items()},
        "dp": {"x": torch.tensor(dp_x)}}, out)
    try:
        jax_side = _jax_side(stacked, cases, dp_x)
    finally:
        ranks = collect(procs, out)
    return {"ranks": ranks, "jax": jax_side, "stacked": torch_stacked,
            "cases": cases, "dp_x": dp_x}


def _scaled(got, want, tol: float, name: str) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _sequential_grads(stacked: dict, c: dict):
    params = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    x = torch.tensor(c["x"], requires_grad=True)
    y = _sequential(params, x)
    ((y - torch.tensor(c["tgt"])) ** 2).mean().backward()
    return y.detach(), {k: p.grad for k, p in params.items()}, x.grad


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_and_the_sequential_run(run, name):
    want = run["jax"][name]
    y, grads, dx = _sequential_grads(run["stacked"], run["cases"][name])
    for res in run["ranks"]:  # every rank of the line holds the output
        got = res[name]
        np.testing.assert_allclose(got["y"].numpy(), want["y"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["y"].numpy(), y.numpy(), rtol=0,
                                   atol=1e-6)
        for k, g in got["grads"].items():
            _scaled(g.numpy(), want["grads"][k], 1e-5, k)
            _scaled(g.numpy(), grads[k].numpy(), 1e-6, k)
        _scaled(got["dx"].numpy(), want["dx"], 1e-5, "x")
        _scaled(got["dx"].numpy(), dx.numpy(), 1e-6, "x")


def test_dp_x_pp_matches_jax(run):
    """Each data rank's rows of every microbatch through its pipe; the
    gradients summed over both axes are the global batch's."""
    want = run["jax"]["dp"]
    x = torch.tensor(run["dp_x"])
    seq = _sequential({k: v[:2] for k, v in run["stacked"].items()}, x)
    for res in run["ranks"]:
        got = res["dp"]
        rows = slice(4 * got["data"], 4 * got["data"] + 4)
        np.testing.assert_allclose(got["y"].numpy(), want["y"][:, rows],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["y"].numpy(), seq[:, rows].numpy(),
                                   rtol=0, atol=1e-6)
        for k, g in got["grads"].items():
            _scaled(g.numpy(), want["grads"][k], 1e-5, k)


def test_stage_count_mismatch_raises(run):
    for res in run["ranks"]:
        assert "stacked_params stage axis 2 != mesh axis model=4" in \
            res["mismatch"]
    with pytest.raises(ValueError, match="stage axis"):
        pipeline_apply(stage_fn, run["stacked"], torch.zeros(2, 2, DIM))
    bad = {k: v[:2] for k, v in jax.tree_util.tree_map(
        jnp.asarray, _stacked()).items()}
    with pytest.raises(ValueError, match="stage axis"):
        jax_pipeline_apply(_jax_stage, bad, jnp.zeros((2, 2, DIM)),
                           mesh=jax_build_mesh(JaxMeshSpec(data=-1,
                                                           model=STAGES)))


class _Stage(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(DIM, DIM)

    def forward(self, x):
        return x + torch.nn.functional.gelu(self.dense(x), approximate="tanh")


@pytest.mark.parametrize("remat", [False, True])
def test_one_stage_module_through_functional_call(remat):
    """An ``nn.Module`` stage on the one-rank mesh: each microbatch through
    the module with the stacked stage's parameters, gradients included."""
    stage = _Stage()
    stacked = stack_stage_params([dict(stage.named_parameters())])
    stacked = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    x = torch.tensor(_draw(3, (3, 2, DIM)))
    y = pipeline_apply(stage, stacked, x, remat=remat)
    y.square().sum().backward()
    want = torch.stack([stage(xe) for xe in x])
    want.square().sum().backward()
    torch.testing.assert_close(y, want.detach(), rtol=0, atol=0)
    for name, p in stage.named_parameters():
        torch.testing.assert_close(stacked[name].grad[0], p.grad, rtol=0,
                                   atol=0)
    assert mesh.current_mesh().world == 1
