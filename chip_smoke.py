"""End-to-end check of the multigrid solve on one NVIDIA GPU.

Run from the root of a checkout::

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the partitioned solves only

Phases, in order (any failure raises, so the script exits non-zero and
prints no result line):

1. device check — the first JAX device must be a GPU; prints its kind, the
   device count and ``nvidia-smi``'s name and power limit of each card;
2. main path — 3D Poisson 256³ and 512³ (RB-GS 2+2, linear transfers,
   ‖b‖ = 1 from a seed, absolute threshold 1e-10) as plain V solves, and
   MG-PCG at 256³; each solution's residual is recomputed in float64 on the
   host from the 7-point stencil, and cycle counts must equal the CPU run;
3. engines — a 2D 1024² solve, ``solve_many`` at (64, 64, 128) with K = 8
   against K scalar solves, the ELL engine on 3D Poisson 128³, and the BSR
   engine on 2D elasticity 128² (B = 2), each checked in float64 on the host;
4. the double-float against the native-float64 outer residual at 256³;
5. ``--four-cards`` only, and then no other phase: ``distributed_setup`` at
   512³ and ``setup_sparse_distributed`` on 2D Poisson 2048² over four
   cards, each against the one-card solve of the same ``b`` on device 0.

Every result line starts with the card's name and power limit.  The last
line of standard output is the JSON result.  The phase functions take their
sizes as arguments, so the tests run them on the CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# host float64 residual bound: the 1e-10 threshold plus the margin the
# float64 merge of the (hi, lo) pair and the host's own rounding need
HOST_RESIDUAL_TOL = 2e-10

# Outer cycles the same configurations take on the CPU backend
# (JAX_PLATFORMS=cpu, jax_enable_x64, residual_dtype="doublefloat").
EXPECTED_CYCLES = {
    "poisson_v_256": 7,
    "poisson_v_512": 7,
    "poisson_pcg_256": 3,
}

SEED = 0


def main_config(**overrides):
    from openmg_tpu import SolverConfig

    kw = dict(
        smoother="rbgs",
        transfer="linear",
        residual_dtype="doublefloat",
        threshold=1e-10,
        cycles=100,
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def card_names() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_check(jax, platform: str = "gpu") -> dict:
    """The JAX device description; raises unless it is a ``platform``."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != platform:
        raise RuntimeError(
            f"no {platform} device: JAX found {d.platform} ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def unit_rhs(shape, seed: int = SEED, batch: int | None = None):
    """Seeded f32 right-hand side(s) on the default device, ‖b‖ = 1 each."""
    import jax
    import jax.numpy as jnp

    full = tuple(shape) if batch is None else (batch,) + tuple(shape)
    b = jax.random.normal(jax.random.PRNGKey(seed), full, jnp.float32)
    axes = tuple(range(b.ndim - len(shape), b.ndim))
    nrm = jnp.sqrt(jnp.sum(b.astype(jnp.float64) ** 2, axis=axes,
                           keepdims=True))
    return (b / nrm).astype(jnp.float32)


def poisson_residual(b, x) -> float:
    """‖b − A x‖₂ in float64 on the host, A the (2d+1)-point Dirichlet
    Poisson stencil (diagonal 2d, neighbours −1)."""
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    r = b - 2.0 * x.ndim * x
    for a in range(x.ndim):
        lo = [slice(None)] * x.ndim
        hi = [slice(None)] * x.ndim
        lo[a] = slice(0, -1)
        hi[a] = slice(1, None)
        r[tuple(lo)] += x[tuple(hi)]
        r[tuple(hi)] += x[tuple(lo)]
    return float(np.linalg.norm(r.ravel()))


def merged(x, info) -> np.ndarray:
    """Host float64 solution from a solve's result (the (hi, lo) pair when
    the solve ran in double-float)."""
    if "x_df" in info:
        hi, lo = info["x_df"]
        return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    return np.asarray(x, np.float64)


def _block(x, info):
    import jax

    jax.block_until_ready(info.get("x_df", x))


def timed_solves(solve, reps: int = 3):
    """First call (compiles) + ``reps`` warm calls; returns
    ``(x, info, first_s, median_warm_s)``."""
    t0 = time.perf_counter()
    x, info = solve()
    _block(x, info)
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x, info = solve()
        _block(x, info)
        warm.append(time.perf_counter() - t0)
    return x, info, first, float(np.median(warm)) if warm else None


def peak_bytes(jax) -> int | None:
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _check_cycles(name, cycles, expect):
    if expect is not None and cycles != expect:
        raise AssertionError(
            f"{name}: {cycles} cycles, the CPU run takes {expect}"
        )


def _check_residual(name, res):
    if not res <= HOST_RESIDUAL_TOL:
        raise AssertionError(
            f"{name}: host float64 residual {res:.3e} > {HOST_RESIDUAL_TOL}"
        )


def phase_poisson(name, shape, *, krylov="none", expect=None, reps=3,
                  residual_dtype="doublefloat"):
    """Stencil-engine Poisson solve: setup + compile time, warm solve
    time, cycles, and the host float64 residual of the returned x."""
    import jax

    from openmg_tpu import setup

    cfg = main_config(krylov=krylov, krylov_iters=2,
                      residual_dtype=residual_dtype)
    b = unit_rhs(shape)
    t0 = time.perf_counter()
    solver = setup(tuple(shape), cfg)
    setup_s = time.perf_counter() - t0
    x, info, first_s, warm_s = timed_solves(lambda: solver.solve(b), reps)
    res = poisson_residual(b, merged(x, info))
    if not info["converged"]:
        raise AssertionError(f"{name}: not converged ({info['final_norm']})")
    _check_residual(name, res)
    _check_cycles(name, info["cycles"], expect)
    return {
        "phase": name,
        "shape": list(shape),
        "cycles": info["cycles"],
        "final_norm": info["final_norm"],
        "host_f64_residual": res,
        "solve_s": warm_s,
        "setup_plus_compile_s": setup_s + first_s,
        "peak_bytes_in_use": peak_bytes(jax),
    }


def phase_solve_many(shape, k: int, reps=3):
    """``solve_many`` of K right-hand sides against K scalar solves."""
    import jax

    from openmg_tpu import setup

    solver = setup(tuple(shape), main_config())
    bs = unit_rhs(shape, seed=SEED + 1, batch=k)
    xb, ib, first_s, warm_s = timed_solves(lambda: solver.solve_many(bs),
                                           reps)
    xs_batch = merged(xb, ib)
    t_scalar = 0.0
    worst_res, worst_rel = 0.0, 0.0
    for j in range(k):
        x, info, _, t = timed_solves(lambda: solver.solve(bs[j]), 1)
        t_scalar += t
        xs = merged(x, info)
        if info["cycles"] != ib["cycles"][j]:
            raise AssertionError(
                f"solve_many rhs {j}: {ib['cycles'][j]} cycles, "
                f"scalar solve {info['cycles']}"
            )
        res = poisson_residual(bs[j], xs_batch[j])
        _check_residual(f"solve_many rhs {j}", res)
        rel = float(np.linalg.norm(xs_batch[j] - xs) / np.linalg.norm(xs))
        if not rel <= 1e-6:
            raise AssertionError(f"solve_many rhs {j}: rel. diff {rel:.2e}")
        worst_res, worst_rel = max(worst_res, res), max(worst_rel, rel)
    return {
        "phase": "solve_many",
        "shape": list(shape),
        "batch": k,
        "cycles": ib["cycles"],
        "host_f64_residual_max": worst_res,
        "max_rel_diff_vs_scalar": worst_rel,
        "solve_many_s": warm_s,
        "per_rhs_s": warm_s / k,
        "scalar_per_rhs_s": t_scalar / k,
        "setup_plus_compile_s": first_s,
        "peak_bytes_in_use": peak_bytes(jax),
    }


def phase_sparse(name, A, shape, cfg, dofs: int = 1, reps=3):
    """General-sparse engine solve, residual checked with scipy ``A @ x``
    in float64."""
    import jax
    import jax.numpy as jnp

    from openmg_tpu import setup_sparse

    n = A.shape[0]
    b = jax.random.normal(jax.random.PRNGKey(SEED + 2), (n,), jnp.float32)
    b = b / jnp.linalg.norm(b.astype(jnp.float64)).astype(jnp.float32)
    t0 = time.perf_counter()
    solver = setup_sparse(A, tuple(shape), cfg, dofs=dofs)
    setup_s = time.perf_counter() - t0
    x, info, first_s, warm_s = timed_solves(lambda: solver.solve(b), reps)
    x64 = merged(x, info)
    res = float(np.linalg.norm(np.asarray(b, np.float64) - A @ x64))
    if not info["converged"]:
        raise AssertionError(f"{name}: not converged ({info['final_norm']})")
    _check_residual(name, res)
    return {
        "phase": name,
        "shape": list(shape),
        "rows": n,
        "nnz": int(A.nnz),
        "cycles": info["cycles"],
        "final_norm": info["final_norm"],
        "host_f64_residual": res,
        "solve_s": warm_s,
        "setup_plus_compile_s": setup_s + first_s,
        "peak_bytes_in_use": peak_bytes(jax),
    }


def phase_ell(shape):
    from openmg_tpu.models.poisson import poisson

    return phase_sparse("ell_poisson", poisson(shape), shape,
                        main_config(format="ell"))


def phase_bsr(shape):
    from openmg_tpu import elasticity

    cfg = main_config(format="bsr", blocksize=2, cycles=300)
    return phase_sparse("bsr_elasticity", elasticity(shape), shape, cfg,
                        dofs=2)


def phase_residual_modes(shape):
    """Double-float against native float64 for the outer residual."""
    return [
        phase_poisson(f"residual_{mode}", shape, residual_dtype=mode)
        for mode in ("doublefloat", "float64")
    ]


def _compare(name, x_one, i_one, x_many, i_many):
    a, b = merged(x_one, i_one), merged(x_many, i_many)
    rel = float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(a.ravel()))
    if i_one["cycles"] != i_many["cycles"]:
        raise AssertionError(
            f"{name}: {i_many['cycles']} cycles over the mesh, "
            f"{i_one['cycles']} on one device"
        )
    if not rel <= 1e-6:
        raise AssertionError(f"{name}: relative difference {rel:.2e}")
    return rel


def phase_distributed(shape, n_dev: int, reps=3):
    """``distributed_setup`` over ``n_dev`` devices against the one-device
    solve of the same ``b`` on device 0."""
    from openmg_tpu import MeshConfig, distributed_setup, setup

    cfg = main_config()
    b = unit_rhs(shape)
    one = setup(tuple(shape), cfg)
    x1, i1, _, t1 = timed_solves(lambda: one.solve(b), reps)
    t0 = time.perf_counter()
    many = distributed_setup(tuple(shape), cfg, MeshConfig(n_devices=n_dev))
    setup_s = time.perf_counter() - t0
    xn, i_n, first_s, tn = timed_solves(lambda: many.solve(b), reps)
    rel = _compare("distributed", x1, i1, xn, i_n)
    res = poisson_residual(b, merged(xn, i_n))
    _check_residual("distributed", res)
    return {
        "phase": "distributed_stencil",
        "shape": list(shape),
        "devices": n_dev,
        "partition_plan": list(i_n["partition_plan"]),
        "cycles": i_n["cycles"],
        "rel_diff_vs_one_device": rel,
        "host_f64_residual": res,
        "solve_s": tn,
        "one_device_solve_s": t1,
        "setup_plus_compile_s": setup_s + first_s,
    }


def phase_distributed_sparse(shape, n_dev: int, reps=3):
    """``setup_sparse_distributed`` on 2D Poisson over ``n_dev`` devices
    against the one-device ELL solve of the same ``b``."""
    import jax
    import jax.numpy as jnp

    from openmg_tpu import MeshConfig, setup_sparse, setup_sparse_distributed
    from openmg_tpu.models.poisson import poisson

    A = poisson(shape)
    cfg = main_config(format="ell")
    n = A.shape[0]
    b = jax.random.normal(jax.random.PRNGKey(SEED + 3), (n,), jnp.float32)
    b = b / jnp.linalg.norm(b.astype(jnp.float64)).astype(jnp.float32)
    one = setup_sparse(A, tuple(shape), cfg)
    x1, i1, _, t1 = timed_solves(lambda: one.solve(b), reps)
    t0 = time.perf_counter()
    many = setup_sparse_distributed(A, tuple(shape), cfg,
                                    MeshConfig(n_devices=n_dev))
    setup_s = time.perf_counter() - t0
    xn, i_n, first_s, tn = timed_solves(lambda: many.solve(b), reps)
    rel = _compare("distributed_sparse", x1, i1, xn, i_n)
    res = float(
        np.linalg.norm(np.asarray(b, np.float64) - A @ merged(xn, i_n))
    )
    _check_residual("distributed_sparse", res)
    return {
        "phase": "distributed_sparse",
        "shape": list(shape),
        "devices": n_dev,
        "cycles": i_n["cycles"],
        "rel_diff_vs_one_device": rel,
        "host_f64_residual": res,
        "solve_s": tn,
        "one_device_solve_s": t1,
        "setup_plus_compile_s": setup_s + first_s,
    }


def one_card_phases():
    """Phases 2-4 at their full sizes, in order."""
    yield phase_poisson("poisson_v_256", (256,) * 3,
                        expect=EXPECTED_CYCLES["poisson_v_256"])
    yield phase_poisson("poisson_v_512", (512,) * 3,
                        expect=EXPECTED_CYCLES["poisson_v_512"])
    yield phase_poisson("poisson_pcg_256", (256,) * 3, krylov="pcg",
                        expect=EXPECTED_CYCLES["poisson_pcg_256"])
    yield phase_poisson("poisson_2d_1024", (1024, 1024))
    yield phase_solve_many((64, 64, 128), 8)
    yield phase_ell((128, 128, 128))
    yield phase_bsr((128, 128))
    yield from phase_residual_modes((256,) * 3)


def four_card_phases():
    yield phase_distributed((512,) * 3, 4)
    yield phase_distributed_sparse((2048, 2048), 4)


def _import_checkout_package():
    """Import ``openmg_tpu`` from this script's own checkout, never from
    somewhere else on the path."""
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import openmg_tpu

    src = Path(openmg_tpu.__file__).resolve().parents[1]
    if src != here:
        raise RuntimeError(f"openmg_tpu imported from {src}, not {here}")
    return openmg_tpu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card partitioned solves")
    args = ap.parse_args(argv)

    import jax

    device = device_check(jax)
    if args.four_cards and device["count"] < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {device['count']}")
    cards = card_names()
    tag = cards.splitlines()[0]
    print(f"device kind={device['kind']} count={device['count']}", flush=True)
    print(cards, flush=True)

    _import_checkout_package()
    from openmg_tpu.utils.cache import use_compile_cache

    jax.config.update("jax_enable_x64", True)
    print(f"compile cache: {use_compile_cache()}", flush=True)

    phases = four_card_phases() if args.four_cards else one_card_phases()
    for rec in phases:
        print(f"[{tag}] {json.dumps(rec, default=float)}", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
