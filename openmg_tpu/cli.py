"""Benchmark / solve CLI (T13 metric surface + §5.6 JSON configs).

Usage::

    python -m openmg_tpu --shape 64 64 64 [--config cfg.json] [--report out.json]
    python -m openmg_tpu --shape 256 256 256 --smoother rbgs --transfer linear
    python -m openmg_tpu --shape 64 64 --devices 8 --backend cpu   # distributed

Compiled programs are kept in JAX's persistent cache
(:mod:`openmg_tpu.utils.cache`).

``--config`` loads a :class:`SolverConfig` from JSON (the same
serialization ``SolverConfig.to_json`` writes); explicit flags override
it.  The structured report (config, level stats, residual history,
convergence factor, throughput) prints to stdout or ``--report``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    ap = argparse.ArgumentParser(
        prog="openmg_tpu", description="geometric multigrid solver"
    )
    ap.add_argument("--shape", type=int, nargs="+", required=True,
                    help="grid shape, e.g. --shape 256 256 256")
    ap.add_argument("--config", help="SolverConfig JSON file")
    ap.add_argument("--smoother", choices=["jacobi", "rbgs", "chebyshev"])
    ap.add_argument("--transfer", choices=["aggregate", "linear"])
    ap.add_argument("--cycle-type", choices=["v", "w", "f"])
    ap.add_argument("--cycles", type=int)
    ap.add_argument("--threshold", type=float)
    ap.add_argument("--gridlevels", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--krylov", choices=["none", "pcg"],
                    help="MG-preconditioned CG outer steps (stencil engine)")
    ap.add_argument("--krylov-iters", type=int)
    ap.add_argument("--devices", type=int, default=0,
                    help=">1: distributed solve over an n-device mesh")
    ap.add_argument("--mesh-shape", type=int, nargs=2, metavar=("HOSTS", "CHIPS"),
                    help="2-axis (host, chip) mesh for the distributed solve")
    ap.add_argument("--backend", choices=["cpu", "gpu"],
                    help="force backend (cpu enables virtual multi-device)")
    ap.add_argument("--levels", action="store_true",
                    help="include measured per-level smoother breakdown")
    ap.add_argument("--report", help="write the JSON report here")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    n_mesh = (
        args.mesh_shape[0] * args.mesh_shape[1] if args.mesh_shape else 0
    )
    if args.backend:
        jax.config.update("jax_platforms", args.backend)
        if args.backend == "cpu" and max(args.devices, n_mesh) > 1:
            jax.config.update(
                "jax_num_cpu_devices", max(args.devices, n_mesh)
            )

    import numpy as np

    from openmg_tpu.utils.cache import use_compile_cache

    use_compile_cache()

    from openmg_tpu import MeshConfig, SolverConfig, distributed_setup, setup
    from openmg_tpu.models.poisson import rhs_random
    from openmg_tpu.utils.observe import level_breakdown, solve_report

    if args.config:
        with open(args.config) as f:
            cfg = SolverConfig.from_json(f.read())
    else:
        cfg = SolverConfig()
    overrides = {
        k: v
        for k, v in {
            "smoother": args.smoother,
            "transfer": args.transfer,
            "cycle_type": args.cycle_type,
            "cycles": args.cycles,
            "threshold": args.threshold,
            "gridlevels": args.gridlevels,
            "krylov": args.krylov,
            "krylov_iters": args.krylov_iters,
            "verbose": args.verbose or None,
        }.items()
        if v is not None
    }
    if overrides:
        import dataclasses

        cfg = dataclasses.replace(cfg, **overrides)

    shape = tuple(args.shape)
    print(f"# setup {shape} ...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    distributed = args.mesh_shape is not None or args.devices > 1
    if args.mesh_shape is not None:
        solver = distributed_setup(
            shape, cfg, MeshConfig(mesh_shape=tuple(args.mesh_shape))
        )
    elif args.devices > 1:
        solver = distributed_setup(shape, cfg, MeshConfig(n_devices=args.devices))
    else:
        solver = setup(shape, cfg)
    setup_s = time.perf_counter() - t0

    b = rhs_random(shape, seed=args.seed)
    b = b / np.linalg.norm(b.ravel())
    print("# solving ...", file=sys.stderr, flush=True)
    x, info = solver.solve(b)
    x, info = solver.solve(b)  # steady-state timing (first call compiles)

    rep = solve_report(solver, info)
    rep["setup_s"] = setup_s
    rep["shape"] = list(shape)
    if args.levels and not distributed:
        rep["levels"] = level_breakdown(solver)
    out = json.dumps(rep, indent=2, sort_keys=True, default=float)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out)
        print(f"# report -> {args.report}", file=sys.stderr)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
