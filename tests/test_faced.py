"""Boundary-corrected constant levels (CorneredOperator, and the legacy
FacedStencilOperator it superseded): exactness vs the varying-coefficient
representation, and solve parity.

The corrected representations must be the SAME operator (exact Galerkin),
so apply/residual/smoother sweeps must agree with the varying path to fp
round-off, and full solves must reproduce the varying-path trajectory.
The cornered form additionally collapses the corrections to (K,) vectors
per face/edge/corner region (tap depends only on {axes b: i_b=0, o_b=0} —
see ops/stencil.py::CorneredOperator), which lets the smoothers generate
every row's exact taps from iota inside one fused sweep.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from openmg_tpu import SolverConfig, setup
from openmg_tpu.core.hierarchy import detect_cornered, detect_faced
from openmg_tpu.models.poisson import rhs_random
from openmg_tpu.ops.smoothers import smooth
from openmg_tpu.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    apply,
    residual,
)


def _hierarchies(shape, transfer="linear"):
    cfg = SolverConfig(
        smoother="rbgs", transfer=transfer, residual_dtype="doublefloat"
    )
    s_f = setup(shape, cfg, faced=True)
    s_v = setup(shape, cfg, faced=False)
    return s_f, s_v, cfg


def _corrected_levels(h):
    return [
        (i, L) for i, L in enumerate(h.levels)
        if isinstance(L.A, (CorneredOperator, FacedStencilOperator))
    ]


def test_linear_transfer_produces_cornered_levels():
    s_f, s_v, _ = _hierarchies((32, 32, 32))
    corrected = _corrected_levels(s_f.hierarchy)
    assert corrected, "linear-transfer coarse levels should be corrected"
    for i, L in corrected:
        # the sharp cornered detection must win over the dense-plane faced
        # fallback on every linear-transfer Galerkin level
        assert isinstance(L.A, CorneredOperator)
        assert not s_v.hierarchy.levels[i].A.is_constant


@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 32, 16)])
def test_cornered_apply_residual_match_varying(shape):
    s_f, s_v, _ = _hierarchies(shape)
    for (i, Lf) in _corrected_levels(s_f.hierarchy):
        Lv = s_v.hierarchy.levels[i]
        gs = Lf.A.grid_shape
        x = jnp.asarray(rhs_random(gs, seed=i), dtype=jnp.float32)
        b = jnp.asarray(rhs_random(gs, seed=100 + i), dtype=jnp.float32)
        yf = np.asarray(apply(Lf.A, x))
        yv = np.asarray(apply(Lv.A, x))
        np.testing.assert_allclose(yf, yv, rtol=0, atol=1e-5)
        rf = np.asarray(residual(Lf.A, b, x))
        rv = np.asarray(residual(Lv.A, b, x))
        np.testing.assert_allclose(rf, rv, rtol=0, atol=1e-5)


def test_cornered_to_varying_roundtrip_exact():
    s_f, s_v, _ = _hierarchies((32, 32, 32))
    for (i, Lf) in _corrected_levels(s_f.hierarchy):
        Cv = np.asarray(s_v.hierarchy.levels[i].A.coeffs)
        Cf = np.asarray(Lf.A.to_varying().coeffs)
        np.testing.assert_array_equal(Cf, Cv)


@pytest.mark.parametrize("name", ["jacobi", "rbgs", "chebyshev"])
def test_cornered_smoother_matches_varying(name):
    s_f, s_v, _ = _hierarchies((32, 32, 32))
    for (i, Lf) in _corrected_levels(s_f.hierarchy):
        Lv = s_v.hierarchy.levels[i]
        gs = Lf.A.grid_shape
        x = jnp.asarray(rhs_random(gs, seed=i), dtype=jnp.float32)
        b = jnp.asarray(rhs_random(gs, seed=50 + i), dtype=jnp.float32)
        kw = {}
        if name == "chebyshev":
            # Gershgorin estimates differ between representations (both are
            # valid upper bounds); pin λmax so the iterates are comparable
            kw = {}
            from openmg_tpu.ops.smoothers import gershgorin_lambda_max
            lam = gershgorin_lambda_max(Lv.A, Lv.inv_diag)
            from openmg_tpu.ops.smoothers import chebyshev, cornered_inv_diag_full
            xf = np.asarray(
                chebyshev(Lf.A, cornered_inv_diag_full(Lf.A), b, x, 2, lam)
            )
            xv = np.asarray(chebyshev(Lv.A, Lv.inv_diag, b, x, 2, lam))
        else:
            xf = np.asarray(smooth(name, Lf.A, None, b, x, 2, 2.0 / 3.0))
            xv = np.asarray(
                smooth(name, Lv.A, Lv.inv_diag, b, x, 2, 2.0 / 3.0)
            )
        np.testing.assert_allclose(xf, xv, rtol=0, atol=1e-5)


def test_faced_representation_still_exact():
    """The legacy dense-plane faced representation (fallback when cornered
    detection fails) stays exact: build it directly from the varying
    coefficients and compare apply/residual/to_varying."""
    s_f, s_v, _ = _hierarchies((32, 32, 32))
    for (i, Lf) in _corrected_levels(s_f.hierarchy):
        Lv = s_v.hierarchy.levels[i]
        C = np.asarray(Lv.A.coeffs)
        fd = detect_faced(Lv.A.offsets, C)
        assert fd is not None
        vals, face_axes, planes = fd
        op = FacedStencilOperator(
            values=jnp.asarray(vals.astype(np.float32)),
            face_coeffs=tuple(
                jnp.asarray(p.astype(np.float32)) for p in planes
            ),
            offsets=Lv.A.offsets,
            shape=Lv.A.grid_shape,
            face_axes=face_axes,
        )
        np.testing.assert_array_equal(
            np.asarray(op.to_varying().coeffs), C.astype(np.float32)
        )
        gs = op.grid_shape
        x = jnp.asarray(rhs_random(gs, seed=i), dtype=jnp.float32)
        b = jnp.asarray(rhs_random(gs, seed=7 + i), dtype=jnp.float32)
        np.testing.assert_allclose(
            np.asarray(apply(op, x)), np.asarray(apply(Lv.A, x)),
            rtol=0, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(smooth("rbgs", op, None, b, x, 1, 2.0 / 3.0)),
            np.asarray(smooth("rbgs", Lv.A, Lv.inv_diag, b, x, 1, 2.0 / 3.0)),
            rtol=0, atol=1e-5,
        )


def test_detect_cornered_rejects_genuinely_varying():
    rng = np.random.default_rng(0)
    offsets = ((0, 0), (0, 1), (1, 0))
    coeffs = rng.normal(size=(3, 8, 8))
    assert detect_cornered(offsets, coeffs) is None
    assert detect_faced(offsets, coeffs) is None


def test_detect_cornered_rejects_exactly_constant():
    # exactly-constant operators belong to the plain constant path
    offsets = ((0, 0), (0, 1), (0, -1))
    coeffs = np.zeros((3, 8, 8))
    coeffs[0] = 2.0
    coeffs[1, :, :-1] = -1.0
    coeffs[2, :, 1:] = -1.0
    assert detect_cornered(offsets, coeffs) is None
    assert detect_faced(offsets, coeffs) is None


def test_detect_cornered_table_is_exact():
    """detect_cornered's inclusion–exclusion table rebuilds the varying
    coefficients bit-for-bit on every linear-transfer Galerkin level."""
    s_f, s_v, _ = _hierarchies((16, 32, 64))
    found = 0
    for (i, Lf) in _corrected_levels(s_f.hierarchy):
        Lv = s_v.hierarchy.levels[i]
        C = np.asarray(Lv.A.coeffs, dtype=np.float64)
        got = detect_cornered(Lv.A.offsets, C)
        assert got is not None
        vals, subsets, deltas = got
        op = CorneredOperator(
            values=jnp.asarray(vals),
            deltas=jnp.asarray(np.stack(deltas)),
            offsets=Lv.A.offsets,
            shape=Lv.A.grid_shape,
            subsets=subsets,
        )
        np.testing.assert_array_equal(np.asarray(op.to_varying().coeffs), C)
        found += 1
    assert found


def test_cornered_solve_matches_varying_trajectory():
    shape = (32, 32, 32)
    s_f, s_v, cfg = _hierarchies(shape)
    b = rhs_random(shape, seed=3)
    b /= np.linalg.norm(b.ravel())
    b = jnp.asarray(b, dtype=jnp.float32)
    xf, inf_f = s_f.solve(b)
    xv, inf_v = s_v.solve(b)
    assert inf_f["converged"] and inf_v["converged"]
    # the operator is identical, so cycle counts must match and the
    # per-cycle norms track to fp tolerance
    assert inf_f["cycles"] == inf_v["cycles"]
    a = np.asarray(inf_f["residual_norms"])
    v = np.asarray(inf_v["residual_norms"])
    np.testing.assert_allclose(a[:-1], v[:-1], rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(xf), np.asarray(xv), rtol=0, atol=1e-6
    )


def test_cornered_solve_converges_fast_128():
    """The linear-transfer convergence rate (the reason the corrected
    representations exist) must be preserved: ≤ 10 cycles to 1e-10 at 128³
    (cf. 7 at the exact-Galerkin baseline; constant-projected coarse ops
    needed 60+)."""
    shape = (128, 128, 128)
    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat"
    )
    s = setup(shape, cfg)
    assert _corrected_levels(s.hierarchy)
    b = rhs_random(shape, seed=1)
    b /= np.linalg.norm(b.ravel())
    b = jnp.asarray(b, dtype=jnp.float32)
    _, info = s.solve(b)
    assert info["converged"]
    assert info["cycles"] <= 10, info["cycles"]
