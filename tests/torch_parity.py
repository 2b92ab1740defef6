"""Helpers the port's parity tests of NCF, TFT, the U-Nets, Transformer-XL
and MoFlow share: JAX's variables drawn in numpy, a quickly compiled
``jax.jit``, and the error measures of the tolerances."""

import json

import jax
import numpy as np
import torch


def jit(f):
    """``jax.jit`` with XLA's quick CPU code generation: these functions run
    once or twice, so compiling dominates."""
    return jax.jit(f, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def rel(a, b) -> float:
    """The largest difference over the largest entry of ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def worst(got: dict, want: dict, skip=()) -> tuple[tuple, tuple]:
    """The worst (error, name) over each tensor's largest entry and over the
    largest entry of all, for every tensor of ``got`` (``want`` may hold
    more: an LSTM's ``bias_ih`` buffers); names in ``skip`` (gradients that
    are rounding noise) count against the largest of all only."""
    assert set(got) <= set(want), set(got) - set(want)
    want = {n: want[n] for n in got}
    top = max(float(np.abs(w).max()) for w in want.values())
    return (max((rel(got[n], w), n) for n, w in want.items() if n not in skip),
            max((float(np.abs(np.asarray(got[n], np.float64) - w).max()) / top,
                 n) for n, w in want.items()))


def draw(shapes, seed: int):
    """Variables of the JAX model's shapes, drawn in numpy: scales 1 + 0.2
    N(0, 1), biases and running means 0.1 N(0, 1), running variances U(0.5,
    1.5), every other leaf N(0, 1 / fan_in) (a vector: N(0, 0.1))."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name in ("scale",) or (name or "").startswith("in_scale"):
            out = 1.0 + 0.2 * rng.normal(size=x.shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("bias", "mean", "loc") or (name or "").startswith(
                "in_bias") or len(x.shape) <= 1:
            out = 0.1 * rng.normal(size=x.shape)
        else:
            out = rng.normal(size=x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """``sd`` (numpy) into ``model``, every entry and no other."""
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return model


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads(model: torch.nn.Module) -> dict:
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def sd_numpy(model: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def tb(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def assert_round_trip(back, want) -> None:
    """A tree carried to the port and back is JAX's, exactly."""
    got, want = flat(back), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def raport_losses(path, key: str = "train.loss") -> list[float]:
    """The values of ``key`` in a run's raport, in order."""
    rows = [json.loads(line.removeprefix("DLLL "))
            for line in path.read_text().splitlines() if line.strip()]
    return [r["data"][key] for r in rows if key in r.get("data", {})]
