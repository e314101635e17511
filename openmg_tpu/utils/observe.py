"""Observability: profiler traces, per-level breakdowns, structured reports
(component T15; SURVEY.md §5.1/§5.5).

The reference's entire observability story is ``verbose`` prints of
per-cycle residual norms (SURVEY.md R10).  The build keeps that (the
``verbose`` config flag and the ``info`` dict returned by every solve) and
adds:

* :func:`trace` — ``jax.profiler`` trace context around jitted cycles;
  the XLA/TensorBoard timeline shows the fused kernels and collectives.
* :func:`level_breakdown` — measured per-level smoother cost and achieved
  nnz/s (the BASELINE T13 metric, resolved per level).
* :func:`solve_report` — one JSON-able record combining config, hierarchy
  statistics, convergence history, and throughput; this is the structured
  per-cycle record surface of SURVEY.md §5.5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "trace",
    "level_breakdown",
    "solve_report",
    "convergence_factor",
    "pack_solve_meta",
    "unpack_solve_meta",
]


def pack_solve_meta(k, hist, done):
    """Pack a device solve's ``(cycle count, residual history, converged)``
    into ONE f32 vector *inside* the jitted program.

    Fetching them separately costs three small device-to-host transfers;
    one packed vector → one transfer."""
    head = jnp.stack(
        [k.astype(jnp.float32), done.astype(jnp.float32)]
    )
    return jnp.concatenate([head, hist.astype(jnp.float32)])


def unpack_solve_meta(packed):
    """Host side of :func:`pack_solve_meta`: one ``np.asarray`` readback →
    ``(k, history list, converged)``."""
    arr = np.asarray(packed)
    k = int(arr[0])
    done = bool(arr[1] != 0.0)
    return k, [float(v) for v in arr[2 : 2 + k]], done


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context into ``logdir``.

    View with TensorBoard (or xprof) pointed at ``logdir``; each V-cycle
    level's kernels carry the ``level<k>`` name scope, and collectives
    appear as ppermute/all-gather thunks on the device timeline.
    """
    with jax.profiler.trace(str(logdir)):
        yield


def _timeit(f, *args, reps: int = 5):
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def level_breakdown(solver, sweeps: int = 4, reps: int = 5):
    """Measure per-level smoother cost of a stencil :class:`Solver`.

    Returns a list of per-level dicts: shape, nnz, ms per smoother sweep,
    achieved smoother nnz/s (the T13 metric per level).  Runs the same
    jitted smoother the V-cycle uses.
    """
    from openmg_tpu.ops.smoothers import smooth

    cfg = solver.config
    h = solver.hierarchy
    records = []
    smoother_fn = jax.jit(
        lambda A, inv_d, bb, xx: smooth(
            cfg.smoother, A, inv_d, bb, xx, sweeps, cfg.omega
        )
    )
    for lvl in range(h.num_levels):
        L = h.levels[lvl]
        shape, _, nnz = h.stats[lvl]
        b = jnp.zeros(shape, dtype=solver.dtype)
        x = jnp.ones(shape, dtype=solver.dtype)
        dt = _timeit(smoother_fn, L.A, L.inv_diag, b, x, reps=reps) / sweeps
        records.append(
            {
                "level": lvl,
                "shape": list(shape),
                "nnz": int(nnz),
                "constant": bool(L.A.is_constant),
                "smoother_ms_per_sweep": dt * 1e3,
                "smoother_nnz_per_s": nnz / dt,
            }
        )
    return records


def convergence_factor(residual_norms) -> float:
    """Geometric-mean per-cycle residual contraction ρ (excludes the first
    cycle, which reflects the initial guess rather than the cycle operator).
    ‖r_k‖ ≈ ρ^k ‖r_0‖; lower is better (ρ ≈ 0.1 ⇒ one digit per cycle)."""
    r = np.asarray([float(v) for v in residual_norms], dtype=np.float64)
    r = r[r > 0]
    if len(r) < 3:
        return float("nan")
    return float((r[-1] / r[1]) ** (1.0 / (len(r) - 2)))


def solve_report(solver, info: dict, include_levels: bool = False) -> dict:
    """One structured JSON-able record for a completed solve (T13/T15)."""
    cfg = solver.config
    stats = info.get("level_stats", ())
    fine_nnz = int(stats[0][2]) if stats else None
    mean_cycle = info.get("mean_cycle_time_s")
    if mean_cycle is None or not np.isfinite(mean_cycle):
        cycle_times = info.get("cycle_times_s", [])
        steady = cycle_times[1:] or cycle_times
        mean_cycle = float(np.mean(steady)) if steady else None
    rec = {
        "config": dataclasses.asdict(cfg),
        "gridlevels": info.get("gridlevels"),
        "level_stats": [
            {"shape": list(s), "offsets": int(k), "nnz": int(n)}
            for (s, k, n) in stats
        ],
        "cycles": info.get("cycles"),
        "converged": info.get("converged"),
        "final_norm": info.get("final_norm"),
        "residual_norms": [float(v) for v in info.get("residual_norms", [])],
        "convergence_factor": convergence_factor(
            info.get("residual_norms", [])
        ),
        "residual_mode": info.get("residual_mode"),
        "mean_cycle_time_s": mean_cycle,
        "solve_time_s": info.get("solve_time_s"),
        "backend": jax.default_backend(),
    }
    if fine_nnz and mean_cycle:
        # smoother work per cycle on the fine level alone (a lower bound on
        # cycle throughput; the full-hierarchy sum adds ≤ 1/7 in 3D)
        sweeps = cfg.pre_iterations + cfg.post_iterations
        rec["fine_nnz"] = fine_nnz
        rec["cycle_smoother_nnz_per_s"] = fine_nnz * sweeps / mean_cycle
    # distributed solves carry their mesh facts through (T13 surface)
    if "partition_plan" in info:
        rec["partition_plan"] = [bool(p) for p in info["partition_plan"]]
    if "n_devices" in info:
        rec["n_devices"] = int(info["n_devices"])
    if "outer_loop" in info:
        rec["outer_loop"] = info["outer_loop"]
    if include_levels:
        rec["levels"] = level_breakdown(solver)
    return rec


def dump_report(path, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
