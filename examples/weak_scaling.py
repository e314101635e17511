#!/usr/bin/env python
"""Weak-scaling harness (BASELINE north star: >70% weak-scaling nnz/s
efficiency at 512³ on ≥2 hosts).

Grows the grid with the device count (fixed work per device) and reports
per-device smoother throughput and cycle time vs the 1-device run::

    python examples/weak_scaling.py [--base 32] [--max-devices 8]

By default the harness runs on virtual CPU devices — it validates the
*harness* and the distributed code path; absolute numbers are CPU
numbers.  On GPUs run it with ``--backend gpu`` (one process per host;
``initialize_distributed()`` takes the coordinator address, process count
and process id where no cluster environment provides them).

Output: one JSON line per device count with nnz/s/device and efficiency.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def run_weak_scaling(
    base: int = 32,
    ny: int = 32,
    nz: int = 32,
    max_devices: int = 8,
    cfg=None,
    on_record=None,
):
    """The harness core (importable — tests/test_parallel.py pins the
    record schema and the efficiency formula): grow axis 0 with the device
    count, solve, and return one record per device count.

    ``weak_scaling_efficiency`` is per-device smoother throughput relative
    to the 1-device run — the BASELINE north-star metric
    (>70% at 512³ on ≥2 hosts).
    """
    from openmg_tpu import (
        MeshConfig,
        SolverConfig,
        distributed_setup,
        initialize_distributed,
        setup,
    )
    from openmg_tpu.models.poisson import rhs_random

    initialize_distributed()
    cfg = cfg or SolverConfig(
        smoother="rbgs", transfer="linear", gridlevels=3,
        max_dense_coarse=1 << 20, cycles=60,
    )

    records = []
    base_nnz_per_s = None
    n = 1
    while n <= max_devices:
        shape = (base * n, ny, nz)
        solver = (
            setup(shape, cfg)
            if n == 1
            else distributed_setup(shape, cfg, MeshConfig(n_devices=n))
        )
        b = rhs_random(shape, seed=0)
        b = b / np.linalg.norm(b.ravel())
        solver.solve(b)  # warm
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        dt = time.perf_counter() - t0
        nnz = (
            solver.hierarchy.stats[0][2]
            if n == 1
            else solver.stats[0][2]
        )
        sweeps = (cfg.pre_iterations + cfg.post_iterations) * info["cycles"]
        nnz_per_s_dev = nnz * sweeps / dt / n
        if base_nnz_per_s is None:
            base_nnz_per_s = nnz_per_s_dev
        rec = {
            "devices": n,
            "shape": list(shape),
            "fine_nnz": int(nnz),
            "cycles": info["cycles"],
            "converged": info["converged"],
            "solve_s": dt,
            "smoother_nnz_per_s_per_device": nnz_per_s_dev,
            "weak_scaling_efficiency": nnz_per_s_dev / base_nnz_per_s,
        }
        records.append(rec)
        if on_record is not None:
            on_record(rec)
        n *= 2
    return records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=int, default=32,
                    help="axis-0 extent per device (other axes fixed)")
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--nz", type=int, default=32)
    ap.add_argument("--max-devices", type=int, default=8)
    ap.add_argument("--backend", choices=["cpu", "gpu"], default="cpu")
    args = ap.parse_args()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.max_devices)

    def emit(rec):
        print(json.dumps(rec), flush=True)
        log(
            f"n={rec['devices']} shape={tuple(rec['shape'])} "
            f"eff={rec['weak_scaling_efficiency']:.2f}"
        )

    run_weak_scaling(
        args.base, args.ny, args.nz, args.max_devices, on_record=emit
    )


if __name__ == "__main__":
    main()
