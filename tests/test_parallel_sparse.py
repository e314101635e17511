"""Distributed general-sparse engine on the 8-fake-CPU-device mesh:
banded-ELL row partitioning, halo-local smoothing/residuals, all-gather
transfers, and partitioned-vs-single-device parity (SURVEY.md §2B
T9/T10/T11 extended to the algebraic engine — parallel/sparse_dist.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from openmg_tpu.core.algebraic import (
    AlgebraicSolver,
    build_sparse_hierarchy,
    setup_sparse,
)
from openmg_tpu.core.config import MeshConfig, SolverConfig
from openmg_tpu.models.poisson import poisson, rhs_random
from openmg_tpu.parallel.sparse_dist import (
    DistributedAlgebraicSolver,
    setup_sparse_distributed,
    sparse_partition_plan,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (fake) devices"
)


def pentadiag(n: int) -> sp.csr_matrix:
    """Symmetric diagonally-dominant pentadiagonal SPD matrix — banded but
    NOT a grid stencil the structured engine would take (offsets ±2):
    exactly the input class the banded partitioning serves."""
    return sp.diags(
        [-1.0, -2.0, 6.5, -2.0, -1.0],
        offsets=[-2, -1, 0, 1, 2],
        shape=(n, n),
        format="csr",
    )


def _cfg(**kw):
    kw.setdefault("threshold", 1e-10)
    kw.setdefault("cycles", 60)
    kw.setdefault("format", "ell")
    kw.setdefault("residual_dtype", "doublefloat")
    return SolverConfig(**kw)


def _parity(A, shape, cfg, mesh_config=None, seed=3):
    b = rhs_random(shape, seed=seed).reshape(-1)
    b = b / np.linalg.norm(b)
    xs, info_s = setup_sparse(A, shape, cfg).solve(b)
    solver_d = setup_sparse_distributed(A, shape, cfg, mesh_config)
    xd, info_d = solver_d.solve(b)
    assert info_s["converged"] and info_d["converged"]
    assert info_d["cycles"] == info_s["cycles"]
    np.testing.assert_allclose(xd, xs, rtol=0, atol=1e-8)
    # atol floor: below the double-float convergence floor (~1e-13) the
    # norms are pure fp-reassociation noise between layouts
    np.testing.assert_allclose(
        info_d["residual_norms"], info_s["residual_norms"],
        rtol=1e-3, atol=1e-13,
    )
    return solver_d, info_d


# ---------------------------------------------------------------------------
# partition plan
# ---------------------------------------------------------------------------


def test_plan_banded_levels_partition():
    h = build_sparse_hierarchy(pentadiag(4096), (4096,), fmt="ell")
    # 4096 → 2048 → 1024 → 512 (≤ max_dense_coarse stops coarsening)
    assert h.num_levels == 4
    assert all(l.A.slot_offsets is not None for l in h.levels)
    plan = sparse_partition_plan(h, 8)
    assert plan == (True, True, True, False)  # coarsest always replicated
    assert sparse_partition_plan(h, 1) == (False,) * 4
    # force=True keeps levels partitioned on a 1-device mesh (the
    # per-device partitioned-program check)
    assert sparse_partition_plan(h, 1, force=True) == (
        True, True, True, False,
    )


def _irregular_spd(n: int, seed: int = 0) -> sp.csr_matrix:
    """Pentadiagonal base + scattered long-range symmetric couplings —
    no slot offsets, so the hierarchy takes the gathered-x tier."""
    rng = np.random.default_rng(seed)
    A = pentadiag(n).tolil()
    for _ in range(5):
        i, j = rng.integers(0, n, size=2)
        A[i, j] = A[j, i] = -0.01
    return sp.csr_matrix(A + sp.eye(n))


def test_irregular_gathered_tier_matches_single():
    """Irregular (non-banded) levels partition on the gathered-x tier
    (VERDICT r4 task 7): rows/data/cols shard, SpMVs all-gather the
    source vector — parity with the single-device engine."""
    n = 1024
    A = _irregular_spd(n)
    h = build_sparse_hierarchy(A, (n,), fmt="ell")
    assert h.levels[0].A.slot_offsets is None
    plan = sparse_partition_plan(h, 8)
    assert plan[0] is True and plan[-1] is False
    solver_d, _ = _parity(A, (n,), _cfg())
    assert solver_d.offsets_per_level[0] is None  # irregular fine level
    assert solver_d.plan[0] is True


def test_irregular_gathered_tier_rbgs_and_pcg():
    """Gathered tier under multicolor GS (greedy colors — Ax per color
    re-gathers) and under distributed PCG."""
    n = 1024
    A = _irregular_spd(n, seed=4)
    _parity(A, (n,), _cfg(smoother="rbgs"))
    _parity(A, (n,), _cfg(krylov="pcg", krylov_iters=2))


def test_plan_indivisible_rows_raise():
    h = build_sparse_hierarchy(pentadiag(1004), (1004,), fmt="ell")
    with pytest.raises(ValueError, match="single-device"):
        DistributedAlgebraicSolver(h, _cfg())


def test_non_ell_format_rejected():
    h = build_sparse_hierarchy(pentadiag(1024), (1024,), fmt="csr")
    with pytest.raises(ValueError, match="ell"):
        DistributedAlgebraicSolver(h, _cfg())


def test_pcg_matches_single_device():
    """krylov="pcg" distributes: psum inner products, same trajectory as
    the single-device general-sparse PCG."""
    _parity(pentadiag(2048), (2048,), _cfg(krylov="pcg", krylov_iters=2))


# ---------------------------------------------------------------------------
# parity: distributed == single-device
# ---------------------------------------------------------------------------


def test_banded_1d_jacobi_parity():
    solver, info = _parity(pentadiag(4096), (4096,), _cfg())
    assert info["partition_plan"] == (True, True, True, False)
    assert info["band_halos"][0] == 2  # offsets ±2


def test_banded_1d_multicolor_gs_parity():
    """±2 offsets couple same-parity points → greedy coloring (>2 colors);
    the partitioned color sweeps re-exchange halos per color and must
    reproduce the single-device trajectory."""
    A = pentadiag(2048)
    solver, info = _parity(A, (2048,), _cfg(smoother="rbgs"))
    assert solver.num_colors[0] >= 3


def test_banded_1d_chebyshev_parity():
    _parity(pentadiag(2048), (2048,), _cfg(smoother="chebyshev"))


@pytest.mark.parametrize("cycle_type", ["w", "f"])
def test_banded_1d_cycle_types_parity(cycle_type):
    _parity(pentadiag(2048), (2048,), _cfg(cycle_type=cycle_type))


def test_poisson_3d_ell_parity():
    """3D Poisson under flat indexing is banded (offsets ±1, ±nx, ±nx·ny):
    the whole grid family partitions on the general engine too."""
    shape = (16, 16, 16)
    solver, info = _parity(poisson(shape), shape, _cfg())
    assert info["partition_plan"][0] is True
    assert info["band_halos"][0] == 16 * 16


def test_two_axis_mesh_matches_1d_mesh():
    A, shape = pentadiag(2048), (2048,)
    cfg = _cfg()
    b = rhs_random(shape, seed=1).reshape(-1)
    x1, i1 = setup_sparse_distributed(
        A, shape, cfg, MeshConfig(n_devices=8)
    ).solve(b)
    x2, i2 = setup_sparse_distributed(
        A, shape, cfg, MeshConfig(mesh_shape=(2, 4))
    ).solve(b)
    assert i1["cycles"] == i2["cycles"]
    np.testing.assert_array_equal(x1, x2)


def test_force_partition_single_device():
    """force_partition=True on a 1-device mesh compiles the exact
    per-device partitioned program (halo slabs degenerate to zeros) —
    pinned here for parity."""
    A, shape = pentadiag(2048), (2048,)
    cfg = _cfg()
    b = rhs_random(shape, seed=2).reshape(-1)
    xs, info_s = setup_sparse(A, shape, cfg).solve(b)
    solver = setup_sparse_distributed(
        A, shape, cfg, MeshConfig(n_devices=1, force_partition=True)
    )
    assert solver.plan == (True, True, False)  # 2048 → 1024 → 512
    xd, info_d = solver.solve(b)
    assert info_d["cycles"] == info_s["cycles"]
    np.testing.assert_allclose(xd, xs, rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# driver surface
# ---------------------------------------------------------------------------


def test_x0_warm_start_converges_immediately():
    A, shape = pentadiag(2048), (2048,)
    solver = setup_sparse_distributed(A, shape, _cfg())
    b = rhs_random(shape, seed=5).reshape(-1)
    x, info = solver.solve(b)
    x2, info2 = solver.solve(b, x0=x)
    assert info2["cycles"] == 0 and info2["converged"]


def test_device_native_path():
    A, shape = pentadiag(2048), (2048,)
    solver = setup_sparse_distributed(A, shape, _cfg())
    b = rhs_random(shape, seed=6).reshape(-1)
    bf = jnp.asarray(b, dtype=jnp.float32)
    x, info = solver.solve(bf)
    assert isinstance(x, jax.Array) and x.dtype == jnp.float32
    assert "x_df" in info
    x_full = np.asarray(info["x_df"][0], np.float64) + np.asarray(
        info["x_df"][1], np.float64
    )
    # f32 rhs quantization: compare against single-device on the same f32 b
    xs, _ = setup_sparse(A, shape, _cfg()).solve(np.asarray(bf, np.float64))
    np.testing.assert_allclose(x_full, xs, rtol=0, atol=1e-8)


def test_solve_many_matches_scalar_and_caches():
    A, shape = pentadiag(2048), (2048,)
    solver = setup_sparse_distributed(A, shape, _cfg())
    bs = [rhs_random(shape, seed=s).reshape(-1) for s in range(3)]
    xs, info = solver.solve_many(bs)
    prog = solver._solve_many_prog
    assert info["batch"] == 3 and all(info["converged"])
    for i, b in enumerate(bs):
        x1, i1 = solver.solve(b)
        assert info["cycles"][i] == i1["cycles"]
        np.testing.assert_allclose(xs[i], x1, rtol=0, atol=1e-9)
    solver.solve_many(bs)  # second call reuses the cached program
    assert solver._solve_many_prog is prog


def test_solve_many_device_batch_with_host_x0s():
    """Device-native f32 batch + host/f64 x0 list: the x0s must be
    df-split on host (mirrors AlgebraicSolver.solve_many), not reshaped
    as if they were a jax array."""
    A, shape = pentadiag(1024), (1024,)
    solver = setup_sparse_distributed(A, shape, _cfg())
    bs_np = np.stack(
        [rhs_random(shape, seed=s).reshape(-1) for s in range(2)]
    )
    bs = jnp.asarray(bs_np, dtype=jnp.float32)
    x0s = [np.zeros(shape[0]), rhs_random(shape, seed=9).reshape(-1)]
    xs, info = solver.solve_many(bs, x0s=x0s)
    assert isinstance(xs, jax.Array) and xs.dtype == jnp.float32
    xs_ref, _ = solver.solve_many(bs)  # zero x0 fixed point is the same
    np.testing.assert_allclose(
        np.asarray(xs), np.asarray(xs_ref), rtol=0, atol=1e-6
    )


def test_algebraic_solve_many_program_cached():
    """Single-device AlgebraicSolver.solve_many caches its jit(vmap)
    program too (the per-call vmap retrace trap, CLAUDE.md r4)."""
    A, shape = pentadiag(1024), (1024,)
    solver = setup_sparse(A, shape, _cfg())
    bs = [rhs_random(shape, seed=s).reshape(-1) for s in range(2)]
    xs, info = solver.solve_many(bs)
    prog = solver._solve_many_prog
    assert all(info["converged"])
    x0, i0 = solver.solve(bs[0])
    np.testing.assert_allclose(xs[0], x0, rtol=0, atol=1e-9)
    solver.solve_many(bs)
    assert solver._solve_many_prog is prog


def test_band_halo_sizes_partitioned_levels():
    """Each partitioned banded level exchanges ``H`` = its widest offset
    rows per side; a level whose local block would hold fewer than ``H``
    rows stays replicated, as does the coarsest."""
    from openmg_tpu.parallel.sparse_dist import _band_halo

    h = build_sparse_hierarchy(pentadiag(4096), (4096,), fmt="ell")
    assert [_band_halo(l.A.slot_offsets) for l in h.levels[:1]] == [2]
    shape = (16, 16, 16)
    h3 = build_sparse_hierarchy(poisson(shape), shape, fmt="ell")
    H = _band_halo(h3.levels[0].A.slot_offsets)
    assert H == 16 * 16
    plan = sparse_partition_plan(h3, 8)
    assert plan[0] is True and plan[-1] is False
    for l, part in zip(h3.levels[:-1], plan[:-1]):
        if l.A.slot_offsets is not None and part:
            assert l.n // 8 >= _band_halo(l.A.slot_offsets)
    # 16 devices would leave 256-row blocks at the fine level: still
    # one ring hop; 32 would leave 128 < H rows, so it cannot partition
    assert sparse_partition_plan(h3, 16)[0] is True
    assert sparse_partition_plan(h3, 32)[0] is False
