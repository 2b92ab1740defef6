"""Multi-process start-up: one process per card, joined by a process group.

Port of ``deeplearningexamples_tpu/parallel/dist.py``. JAX drives every
local chip from one process and joins hosts with ``jax.distributed``; the
PyTorch idiom, and the reference's own (``multiproc.py``, ``bind_pyt.py``),
is one process per card started by ``torchrun``. ``initialize_distributed``
joins the processes in one of three ways, as JAX's does:

- explicit arguments (coordinator ``host:port``, process count and index);
- SLURM autodetect (``SLURM_*``, the coordinator on the step's first node at
  ``COORDINATOR_PORT``, default 12345);
- ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``).

With none of them it creates no process group: one process, one card. The
backend is NCCL for ``cuda`` and gloo for the CPU, or the one
``DLX_DIST_BACKEND`` names (gloo on the card runs two ranks on one device,
which NCCL refuses). A failed start-up raises; it never falls back to one
process.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Mapping

import torch
import torch.distributed as dist

__all__ = ["device_for_rank", "initialize_distributed", "slurm_coordinator"]


def slurm_coordinator(env: Mapping[str, str]) -> tuple[str, int, int] | None:
    """``(coordinator, process count, process index)`` from a SLURM job's
    environment, or None outside SLURM or on one node (JAX's rule: the
    first host of ``SLURM_STEP_NODELIST``, port ``COORDINATOR_PORT``). The
    port runs a process per card, so the count is ``SLURM_NTASKS`` where
    SLURM gives it, else a process per node as in JAX."""
    if "SLURM_JOB_NUM_NODES" not in env:
        return None
    nodes = int(env["SLURM_JOB_NUM_NODES"])
    if nodes <= 1:
        return None
    head = env.get("SLURM_STEP_NODELIST", "").split(",")[0]
    head = head.replace("[", "").split("-")[0]
    port = int(env.get("COORDINATOR_PORT", "12345"))
    count = int(env.get("SLURM_NTASKS", nodes))
    return f"{head}:{port}", count, int(env.get("SLURM_PROCID", 0))


def device_for_rank(device: str) -> torch.device:
    """The card this process computes on: ``cuda:LOCAL_RANK`` (modulo the
    cards there are, so that ranks may share one), or ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device cuda asked for, but no card is visible")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)
    return dev


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: str = "cuda",
                           env: Mapping[str, str] | None = None) -> dict:
    """Join the process group (see the module docstring); returns
    ``{"process_index", "process_count", "device_count"}``: this rank, the
    world size and the cards in the world (one a process)."""
    env = os.environ if env is None else env
    if not dist.is_initialized():
        init_method = None
        if coordinator is None:
            found = slurm_coordinator(env)
            if found is not None:
                coordinator, num_processes, process_id = found
        if coordinator is not None:
            init_method = f"tcp://{coordinator}"
        elif "WORLD_SIZE" in env:
            init_method = "env://"
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env.get("RANK", 0))
        if init_method is not None:
            dev = device_for_rank(device)
            backend = env.get("DLX_DIST_BACKEND") or (
                "nccl" if dev.type == "cuda" else "gloo")
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                backend, init_method=init_method, world_size=num_processes,
                rank=process_id, timeout=timedelta(minutes=10),
                **({"device_id": dev} if backend == "nccl" else {}))
            # a first collective, so that a broken group fails here
            dist.barrier()
    if dist.is_initialized():
        world = dist.get_world_size()
        return {"process_index": dist.get_rank(), "process_count": world,
                "device_count": world}
    return {"process_index": 0, "process_count": 1, "device_count": 1}
