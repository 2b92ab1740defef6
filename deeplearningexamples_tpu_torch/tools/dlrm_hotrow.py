"""DLRM hot-row gather probe: does a hot buffer beat a plain gather?

Port of ``perf/dlrm_hotrow.py``'s ``main``. For B=65,536 x 26 lookups
(1,703,936 rows) from a 26 x 100,000 x 128 fp32 joint table, whose ids are
frequency-ranked so that the head of each table is its hot set, it times:

  1. ``F.embedding`` with uniform ids (the probe's ``jnp.take``)
  2. ``F.embedding`` with zipf(1.15) ids
  3. ``hot_gather`` (K6) with zipf ids, the first 256 rows of each table
     read from a separate 3.4 MB ``hot`` buffer

and K4 (``gather_rows``) on the same uniform and zipf ids, since on this
card L2 (50 MB) already keeps zipf's hot rows of the table itself. Times are
CUDA events over 10 calls on the card, the host clock with ``--device cpu``
(where ``--batch-size`` and ``--rows-per-table`` make it small). The table
and the ids come from numpy's ``default_rng(0)`` in the probe's order of
draws.

    python -m deeplearningexamples_tpu_torch.tools.dlrm_hotrow [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..ops import embedding as emb

N_TABLES = 26
ROWS_PER_TABLE = 100_000
D = 128
BS = 65_536
K_HOT = 256  # hot rows per table (26 x 256 x 128 x 4 B = 3.4 MB)


def flat_ids(rng: np.random.Generator, skew: str, batch: int = BS,
             n_tables: int = N_TABLES,
             rows_per_table: int = ROWS_PER_TABLE) -> np.ndarray:
    """(batch * n_tables,) int32 joint-table ids, uniform or zipf(1.15)
    within each table, row-major over (batch, table)."""
    if skew == "uniform":
        within = rng.integers(0, rows_per_table, (batch, n_tables))
    else:
        within = np.minimum(rng.zipf(1.15, (batch, n_tables)) - 1,
                            rows_per_table - 1)
    offs = np.arange(n_tables)[None, :] * rows_per_table
    return (within + offs).reshape(-1).astype(np.int32)


def hot_head(table: torch.Tensor, rows_per_table: int = ROWS_PER_TABLE,
             k_hot: int = K_HOT) -> torch.Tensor:
    """The first ``k_hot`` rows of each table, stacked: the probe's ``hot``."""
    n_tables = table.shape[0] // rows_per_table
    return table.view(n_tables, rows_per_table, -1)[:, :k_hot].reshape(
        n_tables * k_hot, -1).contiguous()


def _time_ms(fn, device: torch.device, iters: int = 10) -> float:
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch-size", type=int, default=BS)
    ap.add_argument("--rows-per-table", type=int, default=ROWS_PER_TABLE)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card (pass --device cpu to run the "
                               "plain versions on the CPU)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    rpt = args.rows_per_table
    rng = np.random.default_rng(0)
    v = N_TABLES * rpt
    table = torch.from_numpy(
        rng.standard_normal((v, D)).astype(np.float32)).to(device)
    hot = hot_head(table, rpt)
    ids_u = flat_ids(rng, "uniform", args.batch_size, rows_per_table=rpt)
    ids_z = flat_ids(rng, "zipf", args.batch_size, rows_per_table=rpt)
    hot_frac = float(np.mean((ids_z % rpt) < K_HOT))
    print(f"zipf(1.15) hot coverage at K={K_HOT}: {hot_frac:.3f}")

    ids = {k: torch.from_numpy(a).to(device) for k, a in
           (("uniform", ids_u), ("zipf", ids_z))}
    times = {}
    for skew in ("uniform", "zipf"):
        times[f"embedding {skew}"] = _time_ms(
            lambda: torch.nn.functional.embedding(ids[skew], table), device)
        print(f"F.embedding, {skew}:{' ' * (8 - len(skew))}"
              f"{times[f'embedding {skew}']:.4f} ms")
    times["hot_gather zipf"] = _time_ms(
        lambda: emb.hot_gather(table, hot, ids["zipf"], rpt, K_HOT), device)
    print(f"hot_gather (K6), zipf: {times['hot_gather zipf']:.4f} ms "
          f"(hot {hot_frac:.0%} from the hot buffer)")
    for skew in ("uniform", "zipf"):
        times[f"gather_rows {skew}"] = _time_ms(
            lambda: emb.gather_rows(table, ids[skew]), device)
        print(f"gather_rows (K4), {skew}: {times[f'gather_rows {skew}']:.4f} ms")

    # correctness spot check, as the probe's: the first block of zipf ids
    first = ids["zipf"][:1024]
    ref = torch.nn.functional.embedding(first, table)
    got = emb.hot_gather(table, hot, first, rpt, K_HOT)
    err = float((ref - got).abs().max())
    print(f"hot_gather max abs err vs embedding (first block): {err:.2e}")
    return {**times, "hot_frac": hot_frac, "max_abs_err": err}


if __name__ == "__main__":
    main()
