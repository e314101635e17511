"""Smoothers and residual on every operator representation, against an
independent numpy sweep on the scipy matrix of the same operator.

Representations: constant Dirichlet-truncated stencils (5/7-point Poisson
and a 27-point stencil), varying coefficients (diffusion), cornered and
faced boundary-corrected Galerkin levels — in 2D and 3D.  The references
apply the textbook definitions to ``A`` as a scipy CSR matrix:

* weighted Jacobi ``x ← x + ω D⁻¹ (b − A x)``;
* red-black half-sweeps: the points of one colour take
  ``D⁻¹ (b − (A − D) x)`` from the current ``x``, red first — for
  bipartite (5/7-point) operators this is classical Gauss–Seidel in the
  red-then-black ordering, checked separately with a triangular solve;
* 4th-kind Chebyshev with λmax the Gershgorin bound of ``D⁻¹ A``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from openmg_tpu import SolverConfig, setup
from openmg_tpu.core.hierarchy import detect_faced
from openmg_tpu.models.poisson import (
    diffusion_stencil,
    poisson_offsets,
    rhs_random,
    stencil_to_csr,
)
from openmg_tpu.ops.smoothers import smooth
from openmg_tpu.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    StencilOperator,
    residual,
)

KINDS = ["const", "const27", "vary", "cornered", "faced"]
SHAPES = {2: (12, 16), 3: (6, 8, 10)}
OMEGA = 2.0 / 3.0


def _const_coeffs(values, offsets, shape):
    """Dense coefficient grid of a constant Dirichlet-truncated stencil."""
    op = FacedStencilOperator(
        values=jnp.asarray(values), face_coeffs=(), offsets=offsets,
        shape=shape, face_axes=(),
    )
    return np.asarray(op.to_varying().coeffs)


def make_op(kind, dim):
    """``(op, inv_diag, A_csr)`` for one representation."""
    shape = SHAPES[dim]
    if kind == "const":
        offsets = poisson_offsets(dim)
        vals = np.array([2.0 * dim] + [-1.0] * (2 * dim))
        op = StencilOperator(None, offsets, jnp.asarray(vals), shape)
        A = stencil_to_csr(offsets, _const_coeffs(vals, offsets, shape))
        return op, jnp.asarray(1.0 / vals[0]), A
    if kind == "const27":
        offsets = tuple(
            o for o in np.ndindex(*(3,) * dim)
        )
        offsets = tuple(tuple(int(v) - 1 for v in o) for o in offsets)
        rng = np.random.default_rng(dim)
        vals = -rng.uniform(0.1, 1.0, len(offsets))
        di = offsets.index((0,) * dim)
        vals[di] = 3.0 ** dim + 3.0
        op = StencilOperator(None, offsets, jnp.asarray(vals), shape)
        A = stencil_to_csr(offsets, _const_coeffs(vals, offsets, shape))
        return op, jnp.asarray(1.0 / vals[di]), A
    if kind == "vary":
        kappa = 0.5 + np.random.default_rng(dim).random(shape)
        offsets, coeffs = diffusion_stencil(kappa)
        op = StencilOperator(jnp.asarray(coeffs), offsets)
        return op, 1.0 / op.diag(), stencil_to_csr(offsets, coeffs)
    # boundary-corrected Galerkin level 1 of a linear-transfer hierarchy
    fine = tuple(2 * s for s in shape)
    cfg = SolverConfig(transfer="linear", dtype="float64", gridlevels=3,
                       max_dense_coarse=1 << 14)
    L = setup(fine, cfg).hierarchy.levels[1]
    assert isinstance(L.A, CorneredOperator)
    varying = L.A.to_varying()
    C = np.asarray(varying.coeffs)
    A = stencil_to_csr(varying.offsets, C)
    if kind == "cornered":
        return L.A, L.inv_diag, A
    vals, face_axes, planes = detect_faced(varying.offsets, C)
    op = FacedStencilOperator(
        values=jnp.asarray(vals), face_coeffs=tuple(map(jnp.asarray, planes)),
        offsets=varying.offsets, shape=shape, face_axes=face_axes,
    )
    return op, None, A


def red_mask(shape):
    return (np.indices(shape).sum(axis=0) % 2 == 0).ravel()


def jacobi_ref(A, b, x, iters, omega):
    dinv = 1.0 / A.diagonal()
    for _ in range(iters):
        x = x + omega * dinv * (b - A @ x)
    return x


def rb_ref(A, b, x, iters, red):
    d = A.diagonal()
    for _ in range(iters):
        for m in (red, ~red):
            xn = (b - (A @ x - d * x)) / d
            x = np.where(m, xn, x)
    return x


def chebyshev_ref(A, b, x, iters):
    d = A.diagonal()
    absA = abs(A)
    lam = np.max((absA @ np.ones(A.shape[0])) / np.abs(d))
    r = b - A @ x
    dk = (4.0 / 3.0) / lam * r / d
    for k in range(1, iters + 1):
        x = x + dk
        if k == iters:
            break
        r = r - A @ dk
        dk = ((2 * k - 1) / (2 * k + 3)) * dk + (
            (8 * k + 4) / (2 * k + 3)
        ) / lam * r / d
    return x


@pytest.mark.parametrize("name", ["jacobi", "rbgs", "chebyshev"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_smoother_matches_numpy_sweep(kind, dim, name):
    op, inv_diag, A = make_op(kind, dim)
    shape = SHAPES[dim]
    b = rhs_random(shape, seed=1)
    x = rhs_random(shape, seed=2)
    iters = 3
    got = smooth(name, op, inv_diag, jnp.asarray(b), jnp.asarray(x), iters,
                 OMEGA)
    if name == "jacobi":
        want = jacobi_ref(A, b.ravel(), x.ravel(), iters, OMEGA)
    elif name == "rbgs":
        want = rb_ref(A, b.ravel(), x.ravel(), iters, red_mask(shape))
    else:
        want = chebyshev_ref(A, b.ravel(), x.ravel(), iters)
    np.testing.assert_allclose(np.asarray(got).ravel(), want,
                               rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_residual_matches_scipy(kind, dim):
    op, _, A = make_op(kind, dim)
    shape = SHAPES[dim]
    b = rhs_random(shape, seed=3)
    x = rhs_random(shape, seed=4)
    got = residual(op, jnp.asarray(b), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got).ravel(),
                               b.ravel() - A @ x.ravel(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["const", "vary"])
def test_rbgs_is_permuted_gauss_seidel(kind, dim):
    """On bipartite operators one RB-GS sweep is lexicographic
    Gauss–Seidel on the red-then-black permuted system."""
    op, inv_diag, A = make_op(kind, dim)
    shape = SHAPES[dim]
    b = rhs_random(shape, seed=5).ravel()
    x = rhs_random(shape, seed=6).ravel()
    red = red_mask(shape)
    perm = np.concatenate([np.flatnonzero(red), np.flatnonzero(~red)])
    Ap = sp.csr_matrix(A)[perm][:, perm]
    xp = x[perm]
    xp = xp + spla.spsolve_triangular(
        sp.tril(Ap, format="csr"), b[perm] - Ap @ xp, lower=True
    )
    want = np.empty_like(x)
    want[perm] = xp
    got = smooth("rbgs", op, inv_diag, jnp.asarray(b.reshape(shape)),
                 jnp.asarray(x.reshape(shape)), 1, OMEGA)
    np.testing.assert_allclose(np.asarray(got).ravel(), want,
                               rtol=1e-11, atol=1e-11)


def test_smooth_zero_iterations_is_identity():
    op, inv_diag, _ = make_op("const", 3)
    x = jnp.asarray(rhs_random(SHAPES[3], seed=7))
    for name in ("jacobi", "rbgs", "chebyshev"):
        assert smooth(name, op, inv_diag, x, x, 0, OMEGA) is x


def test_smooth_rejects_unknown_smoother():
    for kind in ("const", "cornered", "faced"):
        op, inv_diag, _ = make_op(kind, 2)
        x = jnp.zeros(SHAPES[2])
        with pytest.raises(ValueError, match="unknown smoother"):
            smooth("sor", op, inv_diag, x, x, 1, OMEGA)


# ---------------------------------------------------------------------------
# V / W / F cycles against a numpy µ-cycle on explicit Galerkin matrices
# ---------------------------------------------------------------------------

CYCLE_SHAPES = {2: (16, 16), 3: (8, 8, 8)}


def _cycle_setup(dim, transfer_name):
    from openmg_tpu.models.poisson import poisson
    from openmg_tpu.ops.transfer import TRANSFERS
    from openmg_tpu.utils.oracle import (
        weighted_prolongation,
        weighted_restriction,
    )

    shape = CYCLE_SHAPES[dim]
    cfg = SolverConfig(transfer=transfer_name, dtype="float64", gridlevels=3,
                       max_dense_coarse=1 << 14)
    h = setup(shape, cfg).hierarchy
    t = TRANSFERS[transfer_name]
    As, Rs, Ps, shapes = [poisson(shape).tocsr()], [], [], [shape]
    for _ in range(2):
        R = weighted_restriction(shapes[-1], t.r_taps)
        P = weighted_prolongation(shapes[-1], t.p_taps)
        As.append((R @ As[-1] @ P).tocsr())
        Rs.append(R)
        Ps.append(P)
        shapes.append(tuple(s // 2 for s in shapes[-1]))
    return h, As, Rs, Ps, shapes


def _smooth_ref(name, A, b, x, iters, shape):
    if name == "jacobi":
        return jacobi_ref(A, b, x, iters, OMEGA)
    return rb_ref(A, b, x, iters, red_mask(shape))


def mu_cycle_ref(As, Rs, Ps, shapes, b, x, lvl, pre, post, name, gamma):
    A = As[lvl]
    if lvl == len(As) - 1:
        return spla.spsolve(sp.csc_matrix(A), b)
    x = _smooth_ref(name, A, b, x, pre, shapes[lvl])
    bc = Rs[lvl] @ (b - A @ x)
    ec = np.zeros_like(bc)
    for _ in range(1 if lvl == len(As) - 2 else gamma):
        ec = mu_cycle_ref(As, Rs, Ps, shapes, bc, ec, lvl + 1, pre, post,
                          name, gamma)
    x = x + Ps[lvl] @ ec
    return _smooth_ref(name, A, b, x, post, shapes[lvl])


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
@pytest.mark.parametrize("transfer", ["aggregate", "linear"])
@pytest.mark.parametrize("x_zero", [True, False])
@pytest.mark.parametrize("gamma", [1, 2], ids=["V", "W"])
@pytest.mark.parametrize("dim", [2, 3])
def test_mu_cycle_matches_numpy(dim, gamma, x_zero, transfer, smoother):
    from openmg_tpu.core.cycle import v_cycle

    h, As, Rs, Ps, shapes = _cycle_setup(dim, transfer)
    b = rhs_random(shapes[0], seed=8)
    x0 = np.zeros(shapes[0]) if x_zero else rhs_random(shapes[0], seed=9)
    got = v_cycle(h, jnp.asarray(b), jnp.asarray(x0), 0, 2, 1, smoother,
                  OMEGA, gamma, x_zero=x_zero)
    want = mu_cycle_ref(As, Rs, Ps, shapes, b.ravel(), x0.ravel(), 0, 2, 1,
                        smoother, gamma)
    np.testing.assert_allclose(np.asarray(got).ravel(), want,
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("transfer", ["aggregate", "linear"])
@pytest.mark.parametrize("dim", [2, 3])
def test_fmg_cycle_matches_numpy(dim, transfer):
    from openmg_tpu.core.cycle import run_cycle

    h, As, Rs, Ps, shapes = _cycle_setup(dim, transfer)
    b = rhs_random(shapes[0], seed=10).ravel()
    bs = [b]
    for R in Rs:
        bs.append(R @ bs[-1])
    x = spla.spsolve(sp.csc_matrix(As[-1]), bs[-1])
    for lvl in (1, 0):
        x = Ps[lvl] @ x
        x = mu_cycle_ref(As, Rs, Ps, shapes, bs[lvl], x, lvl, 2, 2, "rbgs", 1)
    got = run_cycle(h, jnp.asarray(b.reshape(shapes[0])), "f", 2, 2, "rbgs",
                    OMEGA)
    np.testing.assert_allclose(np.asarray(got).ravel(), x,
                               rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("dim", [2, 3])
def test_cycle_without_presmoothing_restricts_b(dim):
    """pre = 0 from a zero start: the residual is b itself."""
    from openmg_tpu.core.cycle import v_cycle

    h, As, Rs, Ps, shapes = _cycle_setup(dim, "linear")
    b = rhs_random(shapes[0], seed=11)
    got = v_cycle(h, jnp.asarray(b), jnp.zeros(shapes[0]), 0, 0, 2, "rbgs",
                  OMEGA, 1, x_zero=True)
    want = mu_cycle_ref(As, Rs, Ps, shapes, b.ravel(), np.zeros(b.size), 0,
                        0, 2, "rbgs", 1)
    np.testing.assert_allclose(np.asarray(got).ravel(), want,
                               rtol=1e-10, atol=1e-11)
