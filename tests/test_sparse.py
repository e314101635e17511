"""Sparse format layer tests (T1): CSR/ELL/BSR containers, padded static
nnz inertness, SpMV vs scipy, double-float SpMV accuracy."""

import numpy as np
import pytest
import scipy.sparse as sp

from openmg_tpu.ops.sparse import (
    bsr_from_scipy,
    csr_from_scipy,
    diagonal,
    ell_from_scipy,
    from_scipy,
    spmv,
    spmv_df,
    to_scipy,
)


def random_sparse(n, m, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng, format="csr")
    A.data = rng.standard_normal(A.nnz)
    return A


@pytest.mark.parametrize("fmt", ["csr", "ell", "bsr"])
def test_round_trip(fmt):
    n = 48
    A = random_sparse(n, n, 0.15, seed=1)
    A = A + sp.identity(n)  # ensure some structure on the diagonal
    M = from_scipy(A, fmt, dtype=np.float64)
    back = to_scipy(M)
    assert np.allclose(back.toarray(), A.toarray())


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_spmv_rectangular(fmt):
    A = random_sparse(40, 72, 0.12, seed=2)
    x = np.random.default_rng(3).standard_normal(72)
    M = from_scipy(A, fmt, dtype=np.float64)
    y = np.asarray(spmv(M, np.asarray(x)))
    assert np.allclose(y, A @ x, atol=1e-12)


def test_spmv_bsr():
    n = 64
    A = random_sparse(n, n, 0.1, seed=4) + sp.identity(n)
    x = np.random.default_rng(5).standard_normal(n)
    for bs in (1, 2, 4, 8):
        M = bsr_from_scipy(A, blocksize=(bs, bs), dtype=np.float64)
        y = np.asarray(spmv(M, np.asarray(x)))
        assert np.allclose(y, A @ x, atol=1e-12), f"blocksize {bs}"


def test_bsr_blocked_band_pallas_path():
    """Block-banded matrices (constant per-slot block-column delta) take
    the slot-major layout and the gather-free banded SpMV (ops/bsr.py),
    pinned against scipy and the general einsum/gather path."""
    from openmg_tpu.models.poisson import poisson
    from openmg_tpu.ops import bsr as bsr_mod

    A = poisson((16, 16, 16))  # n = 4096, block-banded at any square B
    for B in (2, 4, 8):
        M = bsr_from_scipy(A, blocksize=(B, B), dtype=np.float32)
        assert M.slot_offsets is not None, f"banded packing at B={B}"
        x = np.random.default_rng(B).standard_normal(A.shape[0])
        y = np.asarray(spmv(M, np.asarray(x, np.float32)))
        assert np.allclose(y, A @ x, atol=1e-3), f"B={B}"
        y_j = np.asarray(bsr_mod.spmv_banded_jnp(M, np.asarray(x, np.float32)))
        assert np.allclose(y_j, A @ x, atol=1e-3)
        # the general (gather) layout of the same matrix agrees
        G = bsr_from_scipy(A, blocksize=(B, B), kb=M.kb + 64, dtype=np.float32)
        y_g = np.asarray(spmv(G, np.asarray(x, np.float32)))
        assert np.allclose(y_g, A @ x, atol=1e-3)
        # diagonal on the slot-major layout
        d = np.asarray(diagonal(M))
        assert np.allclose(d, A.diagonal(), atol=1e-5)
        # interchange round-trip drops nothing
        assert abs(to_scipy(M) - A).max() < 1e-6


def test_bsr_banded_f64_uses_jnp_fallback():
    """f64 banded BSR is gather-free and exact in float64."""
    from openmg_tpu.models.poisson import poisson

    A = poisson((8, 8))
    M = bsr_from_scipy(A, blocksize=(4, 4), dtype=np.float64)
    assert M.slot_offsets is not None
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    y = np.asarray(spmv(M, np.asarray(x)))
    assert np.allclose(y, A @ x, atol=1e-12)


def test_padding_is_inert():
    """Extra pad slots beyond the minimum must not change any result."""
    A = random_sparse(32, 32, 0.2, seed=6)
    x = np.random.default_rng(7).standard_normal(32)
    y_ref = A @ x
    tight = ell_from_scipy(A, dtype=np.float64)
    wide = ell_from_scipy(A, k=tight.k + 5, dtype=np.float64)
    assert np.allclose(np.asarray(spmv(wide, np.asarray(x))), y_ref, atol=1e-12)
    csr_wide = csr_from_scipy(A, pad_nnz_to=257, dtype=np.float64)
    assert csr_wide.nnz_pad >= A.nnz + 1
    assert np.allclose(
        np.asarray(spmv(csr_wide, np.asarray(x))), y_ref, atol=1e-12
    )
    b_tight = bsr_from_scipy(A, blocksize=(4, 4), dtype=np.float64)
    b_wide = bsr_from_scipy(A, blocksize=(4, 4), kb=b_tight.kb + 3, dtype=np.float64)
    assert np.allclose(
        np.asarray(spmv(b_wide, np.asarray(x))), y_ref, atol=1e-12
    )


@pytest.mark.parametrize("fmt", ["csr", "ell", "bsr"])
def test_diagonal(fmt):
    n = 40
    A = random_sparse(n, n, 0.15, seed=8) + 3 * sp.identity(n)
    M = from_scipy(A, fmt, dtype=np.float64)
    d = np.asarray(diagonal(M))
    assert np.allclose(d, A.diagonal(), atol=1e-12)


def test_spmv_df_accuracy():
    """Double-float ELL SpMV must track the float64 product to ~1e-13
    relative — the precision the 1e-10 outer residual rides on."""
    import dataclasses

    import jax.numpy as jnp

    n = 128
    A = random_sparse(n, n, 0.1, seed=9) + 4 * sp.identity(n)
    x64 = np.random.default_rng(10).standard_normal(n)
    y64 = A @ x64

    ell64 = ell_from_scipy(A, dtype=np.float64)
    d64 = np.asarray(ell64.data)
    hi = d64.astype(np.float32)
    lo = (d64 - hi.astype(np.float64)).astype(np.float32)
    M_hi = dataclasses.replace(ell64, data=jnp.asarray(hi))
    M_lo = dataclasses.replace(ell64, data=jnp.asarray(lo))

    x_hi = x64.astype(np.float32)
    x_lo = (x64 - x_hi.astype(np.float64)).astype(np.float32)
    y_hi, y_lo = spmv_df(M_hi, M_lo, jnp.asarray(x_hi), jnp.asarray(x_lo))
    y = np.asarray(y_hi, dtype=np.float64) + np.asarray(y_lo, dtype=np.float64)
    err = np.abs(y - y64).max() / max(np.abs(y64).max(), 1.0)
    assert err < 1e-12, err


def test_ell_k_budget_guard():
    A = random_sparse(16, 16, 0.5, seed=11)
    tight = ell_from_scipy(A)
    with pytest.raises(ValueError):
        ell_from_scipy(A, k=tight.k - 1)


def test_bsr_requires_divisible():
    A = random_sparse(30, 30, 0.2, seed=12)
    with pytest.raises(ValueError):
        bsr_from_scipy(A, blocksize=(4, 4))


def test_ell_pallas_kernel_matches_jnp():
    """The slot-offset (banded) ELL SpMV == the gather path, including pad
    slots and boundary truncations."""
    import jax.numpy as jnp
    from openmg_tpu.models.poisson import poisson
    from openmg_tpu.ops import ell as ell_mod

    A = poisson((8, 8, 16))  # n=1024, offsets ±1, ±16, ±128
    M = ell_from_scipy(A)
    assert M.slot_offsets is not None
    x = jnp.asarray(
        np.random.default_rng(22).standard_normal(M.shape[0]), jnp.float32
    )
    got = ell_mod.spmv_banded_jnp(M.data, M.slot_offsets, x)
    want = jnp.sum(M.data * x[M.cols], axis=0)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(spmv(M, x)), A @ np.asarray(x, dtype=np.float64),
        rtol=1e-4, atol=1e-4,
    )


def test_ell_multi_tile_kernel():
    """A wide band (offsets ±1024 on n = 4096): far slots read far-shifted
    slices of the zero-padded vector."""
    import jax.numpy as jnp
    from openmg_tpu.models.poisson import poisson

    A = poisson((4, 16, 64))  # n=4096, offsets ±1, ±64, ±1024
    M = ell_from_scipy(A)
    assert max(abs(d) for d in M.slot_offsets) == 1024
    x = jnp.asarray(
        np.random.default_rng(25).standard_normal(M.shape[0]), jnp.float32
    )
    got = spmv(M, x)
    np.testing.assert_allclose(
        np.asarray(got), A @ np.asarray(x, dtype=np.float64),
        rtol=1e-4, atol=1e-4,
    )


def test_ell_poisson_3d_structured_bandwidth():
    """3D Poisson ELL: bandwidth = ny·nx (the z-neighbor), fixed offset
    slots — the structure the ELL engine runs at 128³ on the card."""
    from openmg_tpu.models.poisson import poisson
    import jax.numpy as jnp

    shape = (8, 16, 16)   # n = 2048, bandwidth 256
    A = poisson(shape)
    M = ell_from_scipy(A)
    assert M.bandwidth == 16 * 16
    assert M.slot_offsets is not None and 256 in M.slot_offsets
    x = jnp.asarray(
        np.random.default_rng(23).standard_normal(M.shape[0]), jnp.float32
    )
    got = spmv(M, x)
    np.testing.assert_allclose(
        np.asarray(got), A @ np.asarray(x, dtype=np.float64),
        rtol=1e-4, atol=1e-4,
    )


def test_ell_irregular_fallback():
    """Matrices without slot-regular offsets take the gather path; banded
    ones of any length take the shifted-slice path; both compute
    correctly."""
    import jax.numpy as jnp

    # random sparsity: many distinct deltas -> compact packing, no offsets
    n = 256
    A = random_sparse(n, n, 0.05, seed=24) + 4 * sp.identity(n)
    M = ell_from_scipy(A)
    assert M.slot_offsets is None
    x = np.random.default_rng(24).standard_normal(n)
    got = spmv(M, jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(np.asarray(got), A @ x, rtol=1e-4, atol=1e-4)

    # offset-regular with n not a multiple of anything in particular
    n = 200
    A = sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    M = ell_from_scipy(A)
    assert M.slot_offsets == (-1, 0, 1)
    got = spmv(M, jnp.asarray(x[:n], jnp.float32))
    np.testing.assert_allclose(
        np.asarray(got), A @ x[:n], rtol=1e-5, atol=1e-5
    )


# banded SpMV against scipy at the shapes the removed kernels were tested
# on: several row tiles, bands wider than one tile, blocks of 2, 3 and 4
BANDED_SHAPES = [(8, 8, 16), (4, 16, 64), (8, 16, 16), (2, 512, 512),
                 (16, 8, 128)]


@pytest.mark.parametrize("shape", BANDED_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_banded_spmv_matches_scipy(shape, dtype):
    import jax.numpy as jnp
    from openmg_tpu.models.poisson import poisson

    A = poisson(shape)
    # one slot per stencil offset (at nz = 2 no row has both z-neighbours,
    # so the default budget would fall back to compact packing)
    M = ell_from_scipy(A, k=2 * len(shape) + 1, dtype=dtype)
    assert M.slot_offsets is not None
    x = np.random.default_rng(len(shape)).standard_normal(A.shape[0])
    got = np.asarray(spmv(M, jnp.asarray(x, dtype)), np.float64)
    tol = 1e-4 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, A @ x, rtol=tol, atol=tol)


@pytest.mark.parametrize("B", [2, 3, 4])
@pytest.mark.parametrize("shape", [(24, 24), (12, 8, 8)])
def test_bsr_banded_spmv_matches_scipy(B, shape):
    """Coupled B-species operators (dense B×B blocks) through the banded
    BSR SpMV, in f32 and f64."""
    import jax.numpy as jnp
    from openmg_tpu import coupled_diffusion

    A = coupled_diffusion(shape, ndof=B)
    x = np.random.default_rng(B).standard_normal(A.shape[0])
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        M = bsr_from_scipy(A, blocksize=(B, B), dtype=dtype)
        assert M.slot_offsets is not None
        got = np.asarray(spmv(M, jnp.asarray(x, dtype)), np.float64)
        np.testing.assert_allclose(got, A @ x, rtol=tol, atol=tol)


def test_poisson_ell_device_matches_scipy():
    """Device-synthesized Poisson ELL represents the same operator as
    ell_from_scipy(poisson(shape)) (slot packing differs: fixed offset
    slots with interspersed pads vs scipy's compact per-row packing —
    both valid ELL; pads are data==0 so every consumer treats them
    identically)."""
    from openmg_tpu.models.poisson import poisson, poisson_ell_device
    import jax.numpy as jnp

    for shape in [(8, 8, 8), (16, 8), (32,)]:
        M_dev = poisson_ell_device(shape)
        M_ref = ell_from_scipy(poisson(shape))
        assert M_dev.bandwidth == M_ref.bandwidth
        assert M_dev.nnz == M_ref.nnz
        # operator equality through the round-trip
        diff = (to_scipy(M_dev) - poisson(shape)).tocoo()
        assert diff.nnz == 0 or np.abs(diff.data).max() == 0.0
        # SpMV parity between both packings (banded and gather paths)
        x = jnp.asarray(
            np.random.default_rng(31).standard_normal(M_dev.shape[0]),
            jnp.float32,
        )
        np.testing.assert_allclose(
            np.asarray(spmv(M_dev, x)), np.asarray(spmv(M_ref, x)),
            rtol=1e-6, atol=1e-6,
        )
