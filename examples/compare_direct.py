#!/usr/bin/env python
"""Timing comparison: openmg_tpu vs direct sparse solve on growing Poisson
problems (component R12 — the reference ships timing scripts whose figures
compare openmg against direct solves and PyAMG on growing 3D problems;
SURVEY.md R12/§4.1).

Usage:
    python examples/compare_direct.py [--max-dim 64] [--dims 1 2 3]

Prints one human table to stderr and one JSON line per (dim, N) to stdout::

    {"dim": 3, "shape": [32,32,32], "n": 32768, "mg_s": ..., "direct_s": ...,
     "mg_cycles": ..., "mg_final_norm": ..., "err_vs_direct": ...}

PyAMG is not installed in this environment; the direct solver
(scipy.sparse.linalg.spsolve) is the comparison oracle, as in the
reference's tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_case(shape):
    import scipy.sparse.linalg as spla

    from openmg_tpu import SolverConfig, setup
    from openmg_tpu.models.poisson import poisson, rhs_random

    shape = tuple(shape)
    n = int(np.prod(shape))
    b = rhs_random(shape, seed=0)
    b = b / np.linalg.norm(b.ravel())

    cfg = SolverConfig(smoother="rbgs", transfer="linear")
    t0 = time.perf_counter()
    solver = setup(shape, cfg)
    setup_s = time.perf_counter() - t0
    solver.solve(b)  # warm (compile)
    t0 = time.perf_counter()
    x_mg, info = solver.solve(b)
    mg_s = time.perf_counter() - t0

    A = poisson(shape)
    t0 = time.perf_counter()
    x_dir = spla.spsolve(A.tocsc(), np.asarray(b, dtype=np.float64).ravel())
    direct_s = time.perf_counter() - t0

    err = float(
        np.linalg.norm(np.asarray(x_mg).ravel() - x_dir)
        / max(np.linalg.norm(x_dir), 1e-300)
    )
    return {
        "dim": len(shape),
        "shape": list(shape),
        "n": n,
        "setup_s": setup_s,
        "mg_s": mg_s,
        "direct_s": direct_s,
        "mg_cycles": info["cycles"],
        "mg_final_norm": info["final_norm"],
        "mg_converged": info["converged"],
        "err_vs_direct": err,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-dim", type=int, default=64)
    ap.add_argument("--dims", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--backend", choices=["cpu", "gpu"],
                    help="force backend (must be set before first device use)")
    args = ap.parse_args()

    if args.backend:
        import jax

        jax.config.update("jax_platforms", args.backend)

    log(f"{'shape':>18} {'n':>9} {'setup':>8} {'mg':>8} {'direct':>8} "
        f"{'cyc':>4} {'err':>9}")
    for d in args.dims:
        N = 32
        while N ** d <= args.max_dim ** 3 and N <= 1024:
            rec = run_case((N,) * d)
            print(json.dumps(rec), flush=True)
            log(
                f"{str(tuple(rec['shape'])):>18} {rec['n']:>9} "
                f"{rec['setup_s']:>7.2f}s {rec['mg_s']:>7.3f}s "
                f"{rec['direct_s']:>7.3f}s {rec['mg_cycles']:>4} "
                f"{rec['err_vs_direct']:>9.2e}"
            )
            N *= 2


if __name__ == "__main__":
    main()
