"""Vector-PDE generators + end-to-end BSR solves (SURVEY.md §2B T1/T3
BSR clause): dense-block operators, the case BSR exists for, running
inside a real hierarchy."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from openmg_tpu import (
    SolverConfig,
    coupled_diffusion,
    elasticity,
    setup_sparse,
)
from openmg_tpu.core.algebraic import build_sparse_hierarchy
from openmg_tpu.ops import bsr as bsr_mod
from openmg_tpu.ops.sparse import BSRMatrix


def _rhs(n, seed=0):
    b = np.random.default_rng(seed).standard_normal(n)
    return b / np.linalg.norm(b)


def test_elasticity_operator_spd():
    """Symmetric and positive-definite (the FD cross-term discretization
    preserves definiteness for lam, mu > 0)."""
    A = elasticity((8, 8), lam=1.0, mu=1.0)
    assert A.shape == (128, 128)
    assert abs(A - A.T).max() == 0.0
    w = np.linalg.eigvalsh(A.toarray())
    assert w.min() > 0.1, w.min()
    # corner blocks are purely off-diagonal coupling: u_x row, u_y col
    Ad = A.toarray()
    node = 3 * 8 + 3  # interior node (3,3)
    nbr = 4 * 8 + 4  # its (+1,+1) neighbor
    assert Ad[2 * node, 2 * nbr] == 0.0  # (0,0) entry of the corner block
    assert Ad[2 * node, 2 * nbr + 1] != 0.0  # (0,1) coupling entry


def test_elasticity_validation():
    with pytest.raises(ValueError, match="3x3"):
        elasticity((2, 8))
    with pytest.raises(ValueError, match="positive"):
        elasticity((8, 8), lam=-1.0)
    with pytest.raises(ValueError, match="ndof"):
        coupled_diffusion((8, 8), ndof=1)


def test_coupled_diffusion_spd_dense_blocks():
    A = coupled_diffusion((6, 6), ndof=4)
    assert A.shape == (144, 144)
    assert abs(A - A.T).max() < 1e-12
    w = np.linalg.eigvalsh(A.toarray())
    assert w.min() > 0.1, w.min()
    # every node-pair block is dense (the BSR win case)
    B = sp.bsr_matrix(A, blocksize=(4, 4))
    assert (np.abs(B.data) > 0).all()


def test_elasticity_bsr_hierarchy_banded():
    """Block transfers keep Galerkin levels block-banded: every level's
    BSR container detects slot offsets (the gather-free kernel path)."""
    A = elasticity((16, 16))
    h = build_sparse_hierarchy(
        A, (16, 16), gridlevels=3, fmt="bsr", transfer_name="linear",
        blocksize=2, dofs=2, max_dense_coarse=4096,
    )
    assert h.dofs == 2
    for lvl, level in enumerate(h.levels):
        assert isinstance(level.A, BSRMatrix), lvl
        assert level.A.blocksize == (2, 2), lvl
        assert level.A.slot_offsets is not None, lvl
    # the vector hierarchy must NOT take the scalar geometric transfers
    assert h.geom_transfer(0) is None


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_elasticity_bsr_solve_matches_direct(smoother):
    """2D elasticity through the algebraic engine with BSR levels,
    converged to 1e-9 and matching the scipy direct solve."""
    shape = (16, 16)
    A = elasticity(shape, lam=1.0, mu=1.0)
    cfg = SolverConfig(
        smoother=smoother, transfer="linear", format="bsr", blocksize=2,
        gridlevels=3, max_dense_coarse=4096, cycles=200, threshold=1e-9,
    )
    solver = setup_sparse(A, shape, cfg, dofs=2)
    assert solver.hierarchy.fmt == "bsr"
    b = _rhs(A.shape[0], seed=1)
    x, info = solver.solve(b)
    assert info["converged"], info["residual_norms"][-5:]
    x_dir = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, x_dir, rtol=0, atol=1e-7)


def test_coupled_diffusion_bsr_solve_3d():
    """3D 4-species coupled reaction–diffusion (B=4) solved end to end
    on the blocked-band BSR path."""
    shape = (8, 8, 8)
    A = coupled_diffusion(shape, ndof=4)
    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", format="bsr", blocksize=4,
        gridlevels=2, max_dense_coarse=4096, cycles=200, threshold=1e-9,
    )
    solver = setup_sparse(A, shape, cfg, dofs=4)
    fine = solver.hierarchy.levels[0].A
    assert isinstance(fine, BSRMatrix) and fine.slot_offsets is not None
    # the fine operator takes the gather-free blocked-band SpMV
    v = np.random.default_rng(0).standard_normal(A.shape[0])
    np.testing.assert_allclose(
        np.asarray(bsr_mod.spmv_banded_jnp(fine, jnp.asarray(v, jnp.float32))),
        A @ v, rtol=1e-5, atol=1e-5,
    )
    b = _rhs(A.shape[0], seed=2)
    x, info = solver.solve(b)
    assert info["converged"], info["residual_norms"][-5:]
    x_dir = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, x_dir, rtol=0, atol=1e-7)


def test_elasticity_bsr_vs_ell_trajectory():
    """Format is a layout choice, not an algorithm choice: BSR and ELL
    hierarchies of the same problem produce the same residual
    trajectory (same smoother ordering — jacobi is order-free)."""
    shape = (16, 16)
    A = elasticity(shape)
    base = dict(smoother="jacobi", transfer="linear", gridlevels=3,
                max_dense_coarse=4096, cycles=60, threshold=1e-8)
    b = _rhs(A.shape[0], seed=3)
    _, info_b = setup_sparse(
        A, shape, SolverConfig(format="bsr", blocksize=2, **base), dofs=2
    ).solve(b)
    _, info_e = setup_sparse(
        A, shape, SolverConfig(format="ell", **base), dofs=2
    ).solve(b)
    nb = np.asarray(info_b["residual_norms"])
    ne = np.asarray(info_e["residual_norms"])
    n = min(len(nb), len(ne))
    np.testing.assert_allclose(nb[:n], ne[:n], rtol=1e-4)


def test_elasticity_3d_spd_and_solve():
    """3D Navier–Cauchy (3 dofs/node, 27-point block stencil with
    edge-diagonal coupling blocks on all three axis pairs): SPD, and
    solves through the algebraic engine (B=3 doesn't divide the 128-lane
    row, so BSR runs the jnp banded path — the format still halves
    index traffic vs scalar layouts)."""
    shape = (6, 6, 6)
    A = elasticity(shape)
    assert A.shape == (648, 648)
    assert abs(A - A.T).max() < 1e-12
    w = np.linalg.eigvalsh(A.toarray())
    assert w.min() > 0.05, w.min()

    shape = (8, 8, 8)
    A = elasticity(shape)
    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", format="bsr", blocksize=3,
        gridlevels=2, max_dense_coarse=4096, cycles=200, threshold=1e-8,
    )
    solver = setup_sparse(A, shape, cfg, dofs=3)
    b = _rhs(A.shape[0], seed=5)
    x, info = solver.solve(b)
    assert info["converged"], info["residual_norms"][-5:]
    x_dir = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, x_dir, rtol=0, atol=1e-6)
