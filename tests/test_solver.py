"""End-to-end solver: BASELINE configs 1–3 (CPU-sized), oracle parity
(T7/T12, SURVEY.md §4.2-1) and the reference-compat API surface."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from openmg_tpu import SolverConfig, mg_solve, setup, solve
from openmg_tpu.models.poisson import poisson, poisson_stencil, rhs_random
from openmg_tpu.utils.oracle import reference_mg_solve


def _direct(shape, b):
    A = poisson(shape)
    return spla.spsolve(sp.csc_matrix(A), b.ravel())


@pytest.mark.parametrize(
    "shape,cfg",
    [
        # BASELINE config 1: 1D N=64, 2-level, weighted Jacobi
        ((64,), SolverConfig(gridlevels=2, smoother="jacobi", pre_iterations=2,
                             post_iterations=2, cycles=400, max_dense_coarse=64)),
        # BASELINE config 2 (shrunk): 2D, 5-level, red–black GS
        ((32, 32), SolverConfig(gridlevels=5, smoother="rbgs", cycles=100,
                                max_dense_coarse=16)),
        # BASELINE config 3 (shrunk): 3D full depth, Galerkin RAP
        ((16, 16, 16), SolverConfig(smoother="rbgs", cycles=100)),
    ],
)
def test_converges_to_direct_solve(shape, cfg):
    b = rhs_random(shape, seed=0)
    x, info = solve(shape, b, cfg)
    assert info["converged"], info["residual_norms"]
    assert info["final_norm"] < cfg.threshold
    np.testing.assert_allclose(
        np.asarray(x).ravel(), _direct(shape, b), atol=1e-7
    )


def test_trajectory_matches_oracle_jacobi():
    """Same smoother + same hierarchy ⇒ same per-cycle residual trajectory
    as the numpy mirror (behavioral parity, not just the fixed point)."""
    shape = (64,)
    b = rhs_random(shape, seed=1)
    cfg = SolverConfig(
        gridlevels=3,
        smoother="jacobi",
        pre_iterations=2,
        post_iterations=1,
        cycles=40,
        threshold=1e-9,
        dtype="float64",
        residual_dtype="float64",
        max_dense_coarse=64,
    )
    x, info = solve(shape, b, cfg)
    A = poisson(shape)
    x_ref, info_ref = reference_mg_solve(
        A,
        b.ravel(),
        {
            "problemshape": shape,
            "gridlevels": 3,
            "iterations": 2,
            "post_iterations": 1,
            "cycles": 40,
            "threshold": 1e-9,
            "smoother": "jacobi",
        },
    )
    assert info["cycles"] == info_ref["cycles"]
    n = min(len(info["residual_norms"]), len(info_ref["residual_norms"]))
    np.testing.assert_allclose(
        info["residual_norms"][:n], info_ref["residual_norms"][:n], rtol=1e-6
    )


def test_mixed_precision_refinement_reaches_1e10():
    """f32 cycle + f64 outer residual reaches the reference's 1e-10
    absolute tolerance (SURVEY.md §7 mixed-precision plan A)."""
    shape = (32, 32)
    b = rhs_random(shape, seed=2)
    cfg = SolverConfig(
        smoother="rbgs", dtype="float32", residual_dtype="float64", cycles=200
    )
    x, info = solve(shape, b, cfg)
    assert info["converged"]
    assert info["final_norm"] < 1e-10


def test_doublefloat_refinement_reaches_1e10():
    """Accelerator default: f32 cycle + two-f32 compensated residual
    reaches 1e-10 with no float64 on device (identical on every backend)."""
    shape = (32, 32)
    b = rhs_random(shape, seed=6)
    cfg = SolverConfig(
        smoother="rbgs",
        dtype="float32",
        residual_dtype="doublefloat",
        cycles=300,
        gridlevels=4,
        max_dense_coarse=64,
    )
    x, info = solve(shape, b, cfg)
    assert info["residual_mode"] == "doublefloat"
    assert info["converged"], info["residual_norms"][-3:]
    assert info["final_norm"] < 1e-10
    np.testing.assert_allclose(np.asarray(x).ravel(), _direct(shape, b), atol=1e-8)


@pytest.mark.parametrize("shape", [(64, 64), (16, 16, 16)])
def test_linear_transfer_converges_much_faster(shape):
    b = rhs_random(shape, seed=7)
    kw = dict(
        smoother="rbgs",
        cycles=300,
        gridlevels=4,
        max_dense_coarse=2048,
        residual_dtype="doublefloat",
    )
    _, info_agg = solve(shape, b, SolverConfig(transfer="aggregate", **kw))
    _, info_lin = solve(shape, b, SolverConfig(transfer="linear", **kw))
    assert info_lin["converged"]
    assert info_lin["cycles"] <= 30
    assert info_lin["cycles"] * 3 < info_agg["cycles"]


def test_unknown_transfer_rejected():
    with pytest.raises(ValueError):
        solve((8, 8), rhs_random((8, 8)), SolverConfig(transfer="cubic"))


def test_mg_solve_reference_api():
    """Reference-style call: scipy A + parameters dict, flat x out."""
    shape = (16, 16)
    A = poisson(shape)
    b = rhs_random(shape, seed=3).ravel()
    x, info = mg_solve(
        A,
        b,
        {
            "problemshape": shape,
            "gridlevels": 3,
            "iterations": 2,
            "cycles": 100,
            "threshold": 1e-10,
            "verbose": False,
        },
    )
    assert x.shape == (256,)
    assert info["converged"]
    np.testing.assert_allclose(x, _direct(shape, b), atol=1e-7)


def test_mg_solve_assembles_poisson_when_A_none():
    shape = (16,)
    b = rhs_random(shape, seed=4).ravel()
    x, info = mg_solve(None, b, {"problemshape": shape, "cycles": 100})
    assert info["converged"]


def test_mg_solve_rejects_unknown_parameters():
    with pytest.raises(ValueError):
        mg_solve(None, np.ones(4), {"problemshape": (4,), "bogus": 1})


def test_solver_reuse_multiple_rhs():
    shape = (16, 16)
    solver = setup(shape, SolverConfig(cycles=100))
    for seed in (0, 1):
        b = rhs_random(shape, seed=seed)
        x, info = solver.solve(b)
        assert info["converged"]


def test_nonconvergence_reported_honestly():
    shape = (16, 16)
    cfg = SolverConfig(cycles=1, threshold=1e-14)
    x, info = solve(shape, rhs_random(shape, seed=5), cfg)
    assert not info["converged"]
    assert len(info["residual_norms"]) == 2


@pytest.mark.parametrize(
    "shape,cfg",
    [
        # BASELINE config 2 at FULL size: 2D 256², 5-level, red–black GS.
        # The reference's aggregation transfer has ρ≈0.92 at this scale
        # (piecewise-constant P does not reproduce linears — compounding
        # over 5 levels); it converges, slowly, cycles=400 covers it.
        ((256, 256), SolverConfig(gridlevels=5, smoother="rbgs", cycles=400,
                                  max_dense_coarse=4096)),
        # same config with the linear transfer: ~8 cycles
        ((256, 256), SolverConfig(gridlevels=5, smoother="rbgs", cycles=100,
                                  transfer="linear", max_dense_coarse=4096)),
        # BASELINE config 3 at FULL size: 3D 64³ full depth, Galerkin RAP
        ((64, 64, 64), SolverConfig(smoother="rbgs", cycles=100)),
    ],
)
def test_baseline_configs_full_size(shape, cfg):
    b = rhs_random(shape, seed=0)
    b = b / np.linalg.norm(b.ravel())  # scale-invariant absolute threshold
    x, info = solve(shape, b, cfg)
    assert info["converged"], info["residual_norms"][-3:]
    assert info["final_norm"] < cfg.threshold
    if int(np.prod(shape)) <= 100_000:
        x_dir = _direct(shape, b)
        err = np.linalg.norm(np.asarray(x).ravel() - x_dir) / np.linalg.norm(
            x_dir
        )
        assert err < 1e-7
    else:
        # 3D spsolve fill-in is minutes at 64³ — cross-check the converged
        # residual with an independent scipy SpMV instead
        A = poisson(shape)
        r = b.ravel() - A @ np.asarray(x, dtype=np.float64).ravel()
        assert np.linalg.norm(r) < 2 * cfg.threshold


def test_solve_many_matches_scalar_solves():
    """Batched multi-rhs solve (one vmapped device program) == per-rhs
    scalar solves bit-exactly, including per-lane cycle counts when the
    rhs magnitudes differ (lockstep loop, frozen converged lanes)."""
    import jax.numpy as jnp

    shape = (32, 32)
    cfg = SolverConfig(smoother="rbgs", transfer="linear",
                       residual_dtype="doublefloat", cycles=60)
    solver = setup(shape, cfg)
    rhs = [rhs_random(shape, seed=s) for s in range(3)]
    rhs[1] = rhs[1] * 1e-3  # converges in fewer cycles
    xs, info = solver.solve_many(rhs)
    assert info["batch"] == 3
    for k, b in enumerate(rhs):
        xk, infok = solver.solve(b)
        np.testing.assert_array_equal(np.asarray(xs[k]), np.asarray(xk))
        assert info["cycles"][k] == infok["cycles"]
        assert info["converged"][k] == infok["converged"]
    assert info["cycles"][1] < info["cycles"][0]

    # device-native f32 batch input -> f32 device output + x_df pair
    bb = jnp.asarray(np.stack(rhs), jnp.float32)
    xs2, info2 = solver.solve_many(bb)
    assert xs2.dtype == jnp.float32 and "x_df" in info2
    np.testing.assert_allclose(
        np.asarray(xs2, dtype=np.float64)
        + np.asarray(info2["x_df"][1], dtype=np.float64),
        np.stack([
            np.asarray(solver.solve(np.asarray(b, dtype=np.float64))[0])
            for b in np.asarray(bb, dtype=np.float64)
        ]),
        rtol=1e-12, atol=1e-14,
    )


def test_solve_many_float32_mode():
    shape = (16, 16)
    cfg = SolverConfig(smoother="jacobi", transfer="linear",
                       residual_dtype="float32", threshold=1e-5, cycles=80)
    solver = setup(shape, cfg)
    rhs = [rhs_random(shape, seed=s) for s in (7, 8)]
    xs, info = solver.solve_many(rhs)
    assert all(info["converged"])
    for k, b in enumerate(rhs):
        xk, _ = solver.solve(b)
        np.testing.assert_array_equal(np.asarray(xs[k]), np.asarray(xk))


def test_config_validates_enums_at_construction():
    """Bad enum values fail at SolverConfig construction, not at trace
    time hours into a run."""
    import pytest

    for field, bad in [
        ("smoother", "sor"), ("cycle_type", "q"), ("krylov", "gmres"),
        ("transfer", "cubic"), ("format", "coo"), ("outer_loop", "async"),
    ]:
        with pytest.raises(ValueError, match=field):
            SolverConfig(**{field: bad})


def test_solve_many_with_initial_guesses():
    shape = (16, 16)
    cfg = SolverConfig(smoother="rbgs", transfer="linear",
                       residual_dtype="doublefloat", cycles=60)
    solver = setup(shape, cfg)
    rhs = [rhs_random(shape, seed=s) for s in (21, 22)]
    x0s = [rhs_random(shape, seed=s) * 0.1 for s in (23, 24)]
    xs, info = solver.solve_many(rhs, x0s=x0s)
    for k in range(2):
        xk, infok = solver.solve(rhs[k], x0=x0s[k])
        np.testing.assert_array_equal(np.asarray(xs[k]), np.asarray(xk))
        assert info["cycles"][k] == infok["cycles"]


def test_uncoarsenable_grid_degrades_to_direct_solve():
    """Odd-extent grids that cannot coarsen solve directly (with a
    warning) instead of erroring — up to a hard cap that still protects
    against densifying genuinely large problems."""
    import warnings

    import pytest

    from openmg_tpu import mg_solve
    from openmg_tpu.core.algebraic import setup_sparse
    from openmg_tpu.models.poisson import poisson

    shape = (9, 9, 9)  # 729 unknowns > default max_dense_coarse=512
    b = rhs_random(shape, seed=2).ravel()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        x, info = mg_solve(
            None, b, {"problemshape": shape, "cycles": 300, "threshold": 1e-8}
        )
    assert info["converged"] and info["gridlevels"] == 1
    assert any("coarsen" in str(ww.message) for ww in w)

    # same policy on the general-sparse engine
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s = setup_sparse(poisson(shape), shape, SolverConfig(format="ell"))
    x2, info2 = s.solve(b)
    assert info2["converged"]

    # the hard cap still guards large uncoarsenable problems
    with pytest.raises(ValueError, match="max_dense_coarse"):
        mg_solve(None, rhs_random((17, 17, 17), seed=1).ravel(),
                 {"problemshape": (17, 17, 17)})
