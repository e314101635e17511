"""Grid transfers: separable tap path == explicit sparse R/P oracles (T5)."""

import numpy as np
import pytest

from openmg_tpu.ops.transfer import AGGREGATE, LINEAR, coarse_shape, prolong, restrict
from openmg_tpu.utils.oracle import (
    aggregate_restriction,
    weighted_prolongation,
    weighted_restriction,
)

SHAPES = [(8,), (2,), (8, 8), (4, 2), (4, 6, 8), (2, 2, 2), (1, 4)]
# longer axes, mixed extents and odd coarse sizes
WIDE = [(64,), (32, 64), (8, 16, 32), (2, 64), (16, 6, 8), (6, 4, 10)]


@pytest.mark.parametrize("shape", SHAPES)
def test_restrict_aggregate_matches_reference_R(shape):
    rng = np.random.default_rng(0)
    v = rng.standard_normal(shape)
    R = aggregate_restriction(shape)
    expected = (R @ v.ravel()).reshape(coarse_shape(shape))
    got = np.asarray(restrict(v, AGGREGATE))
    np.testing.assert_allclose(got, expected, rtol=1e-14, atol=0)


@pytest.mark.parametrize("shape", SHAPES + WIDE)
@pytest.mark.parametrize("spec", [AGGREGATE, LINEAR], ids=lambda s: s.name)
def test_restrict_matches_weighted_R(shape, spec):
    rng = np.random.default_rng(1)
    v = rng.standard_normal(shape)
    R = weighted_restriction(shape, spec.r_taps)
    expected = (R @ v.ravel()).reshape(coarse_shape(shape))
    got = np.asarray(restrict(v, spec))
    np.testing.assert_allclose(got, expected, rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("shape", SHAPES + WIDE)
@pytest.mark.parametrize("spec", [AGGREGATE, LINEAR], ids=lambda s: s.name)
def test_prolong_matches_weighted_P(shape, spec):
    rng = np.random.default_rng(2)
    cs = coarse_shape(shape)
    u = rng.standard_normal(cs)
    P = weighted_prolongation(shape, spec.p_taps)
    expected = (P @ u.ravel()).reshape(shape)
    got = np.asarray(prolong(u, shape, spec))
    np.testing.assert_allclose(got, expected, rtol=1e-13, atol=1e-14)


def test_aggregate_P_is_R_transpose():
    shape = (8, 4)
    R = weighted_restriction(shape, AGGREGATE.r_taps)
    P = weighted_prolongation(shape, AGGREGATE.p_taps)
    assert (abs(P - R.T)).max() == 0


def test_linear_R_is_scaled_P_transpose():
    # R = Pᵀ / 2^d per construction → Galerkin RAP stays symmetric
    shape = (8, 8)
    R = weighted_restriction(shape, LINEAR.r_taps)
    P = weighted_prolongation(shape, LINEAR.p_taps)
    assert (abs(R - P.T / 4)).max() < 1e-15


def test_linear_prolong_is_exact_on_linear_functions():
    # vertex-centered: coarse point I sits at fine point 2I; interpolating
    # a linear function is exact away from the zero-filled right boundary
    n = 16
    xs_f = np.arange(n, dtype=float)
    u = 2.0 * xs_f[::2] + 1.0
    got = np.asarray(prolong(u, (n,), LINEAR))
    expected = 2.0 * xs_f + 1.0
    np.testing.assert_allclose(got[: n - 1], expected[: n - 1], rtol=1e-6)


def test_prolong_shape_mismatch_raises():
    with pytest.raises(ValueError):
        prolong(np.zeros((4,)), (12,))
