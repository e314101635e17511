"""Poisson problem generators (reference component R1, SURVEY.md §2A).

The reference (`tsbertalan/openmg`) assembles the d-dimensional Poisson
(negative Laplacian) operator on an N^d regular grid with homogeneous
Dirichlet boundary conditions as a scipy.sparse matrix: diagonal ``2d``,
off-diagonal ``-1`` for each in-domain face neighbor.  (Reference mount was
empty at survey time — see SURVEY.md §0 — so parity is defined against
BASELINE.json and the SciPy-2012 paper's algorithm description.)

Two representations are produced:

* ``poisson(shape)`` — scipy.sparse CSR, byte-compatible with the reference's
  assembly (kron-sum of 1D tridiagonal Laplacians; row-major grid ordering).
  This is the interchange / oracle format.
* ``poisson_stencil(shape)`` — the solver's native form: a DIA-on-grid ("stencil")
  operator, ``(offsets, coeffs)`` with ``coeffs[k]`` the per-grid-point
  coefficient of neighbor offset ``offsets[k]`` (zero where the neighbor
  falls outside the domain).  Regular-grid sparse matrices are exactly
  representable this way, and shift-multiply-add on dense grid arrays
  streams memory with no gather.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "poisson",
    "poisson_stencil",
    "poisson_offsets",
    "stencil_to_csr",
    "stencil_from_csr",
    "rhs_random",
    "rhs_ones",
]


def _lap1d(n: int) -> sp.csr_matrix:
    """1D tridiagonal (-1, 2, -1) operator (Dirichlet)."""
    return sp.diags(
        [-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
        offsets=[-1, 0, 1],
        format="csr",
    )


def poisson(shape) -> sp.csr_matrix:
    """d-dim Poisson matrix on a regular grid, row-major (C) ordering.

    Kron-sum of 1D Laplacians: diagonal ``2*d``, ``-1`` per face neighbor.
    Matches the reference's operator (SURVEY.md R1).
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or any(s < 1 for s in shape):
        raise ValueError(f"invalid problem shape {shape}")
    eyes = [sp.identity(s, format="csr") for s in shape]
    n = int(np.prod(shape))
    A = sp.csr_matrix((n, n))
    for axis in range(len(shape)):
        term = None
        for ax in range(len(shape)):
            M = _lap1d(shape[ax]) if ax == axis else eyes[ax]
            term = M if term is None else sp.kron(term, M, format="csr")
        A = A + term
    A = A.tocsr()
    A.sum_duplicates()
    return A


def poisson_offsets(ndim: int) -> tuple:
    """Stencil offsets of the (2d+1)-point Poisson operator: center first,
    then -/+ unit offsets per axis."""
    offs = [(0,) * ndim]
    for axis in range(ndim):
        for s in (-1, 1):
            o = [0] * ndim
            o[axis] = s
            offs.append(tuple(o))
    return tuple(offs)


def poisson_stencil(shape, dtype=np.float64):
    """Analytic stencil (DIA-on-grid) form of :func:`poisson`.

    Returns ``(offsets, coeffs)`` with ``coeffs`` of shape ``(K, *shape)``:
    ``coeffs[k][i] == A[i, i + offsets[k]]`` and 0 where ``i + offsets[k]``
    is outside the grid.  Exactly equals ``poisson(shape)`` entrywise
    (tested in tests/test_poisson.py).
    """
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    offsets = poisson_offsets(d)
    coeffs = np.empty((len(offsets),) + shape, dtype=dtype)
    coeffs[0] = 2.0 * d
    coeffs[1:] = -1.0
    # zero out rows whose neighbor at `off` leaves the domain (only the
    # boundary slices are touched — single full pass above, cheap fixups)
    for k, off in enumerate(offsets[1:], start=1):
        for axis, o in enumerate(off):
            if o == 0:
                continue
            idx = [slice(None)] * d
            idx[axis] = slice(0, 1) if o == -1 else slice(shape[axis] - 1, None)
            coeffs[(k,) + tuple(idx)] = 0.0
    return offsets, coeffs


def poisson_stencil_device(shape, dtype=None):
    """Device-side analytic assembly of :func:`poisson_stencil` (T2 fast
    path): builds the (2d+1)-point stencil directly in jnp — no host
    megabytes, no host→device transfer.  Bit-identical to the numpy
    assembly (tested)."""
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    offsets = poisson_offsets(d)
    ks = []
    ks.append(jnp.full(shape, 2.0 * d, dtype=dtype))
    for off in offsets[1:]:
        c = jnp.full(shape, -1.0, dtype=dtype)
        for axis, o in enumerate(off):
            if o == 0:
                continue
            idx = [slice(None)] * d
            idx[axis] = slice(0, 1) if o == -1 else slice(shape[axis] - 1, None)
            c = c.at[tuple(idx)].set(0.0)
        ks.append(c)
    return offsets, jnp.stack(ks)


def poisson_ell_device(shape, dtype=None):
    """Device-side synthesis of the Poisson operator straight into the
    slot-major ELL container (:class:`openmg_tpu.ops.sparse.ELLMatrix`) —
    benchmark/smoke path for the general-sparse engine at sizes where
    host scipy assembly is slow (at 256³ the CSR is ~1.4 GB of host work
    and upload; the device builds it directly).

    Slot order matches CSR column order (offsets ascending), pad slots
    carry ``data == 0`` at column 0 — identical conventions to
    ``ell_from_scipy(poisson(shape))`` (pinned by tests at small sizes).
    """
    import jax
    import jax.numpy as jnp

    from openmg_tpu.ops.sparse import ELLMatrix

    dtype = dtype or jnp.float32
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    n = int(np.prod(shape))
    strides = [int(np.prod(shape[a + 1 :])) for a in range(d)]
    # (axis, dir) slots sorted by signed offset, diagonal in the middle
    offs = sorted(
        [(-strides[a], a) for a in range(d)]
        + [(0, -1)]
        + [(strides[a], a) for a in range(d)]
    )

    @jax.jit
    def build():
        r = jnp.arange(n, dtype=jnp.int32)
        datas, colss = [], []
        for off, a in offs:
            if a < 0:
                datas.append(jnp.full((n,), 2.0 * d, dtype=dtype))
                colss.append(r)
                continue
            c_a = (r // strides[a]) % shape[a]
            exists = (c_a + (1 if off > 0 else -1) >= 0) & (
                c_a + (1 if off > 0 else -1) < shape[a]
            )
            datas.append(jnp.where(exists, jnp.asarray(-1.0, dtype), 0.0))
            colss.append(jnp.where(exists, r + off, 0))
        return jnp.stack(datas), jnp.stack(colss)

    data, cols = build()
    # true nnz: diagonal + per axis two off-diagonals minus boundary rows
    nnz = n + sum(2 * n * (shape[a] - 1) // shape[a] for a in range(d))
    return ELLMatrix(
        data=data,
        cols=cols,
        shape=(n, n),
        nnz=int(nnz),
        bandwidth=strides[0] if d else 0,
        # fixed offset slots by construction — the banded SpMV path
        slot_offsets=tuple(off for off, _ in offs),
    )


def stencil_to_csr(offsets, coeffs) -> sp.csr_matrix:
    """Materialize a stencil operator as scipy CSR (for oracles/tests)."""
    coeffs = np.asarray(coeffs)
    shape = coeffs.shape[1:]
    n = int(np.prod(shape))
    rows_list, cols_list, vals_list = [], [], []
    grid = np.indices(shape)  # (d, *shape)
    flat_rows = np.arange(n).reshape(shape)
    for k, off in enumerate(offsets):
        nbr = grid + np.asarray(off).reshape((-1,) + (1,) * len(shape))
        valid = np.ones(shape, dtype=bool)
        for axis, s in enumerate(shape):
            valid &= (nbr[axis] >= 0) & (nbr[axis] < s)
        vals = coeffs[k][valid]
        nz = vals != 0
        cols = np.ravel_multi_index(
            tuple(nbr[axis][valid] for axis in range(len(shape))), shape
        )
        rows_list.append(flat_rows[valid][nz])
        cols_list.append(cols[nz])
        vals_list.append(vals[nz])
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = np.concatenate(vals_list)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def stencil_from_csr(A, shape, max_offsets: int = 125):
    """Extract the exact stencil (DIA-on-grid) form of a grid-structured
    sparse matrix.

    Every sparse matrix whose row/column indices live on a regular grid of
    ``shape`` is exactly representable as a set of per-offset coefficient
    arrays; the number of distinct multi-index offsets must stay bounded
    (``max_offsets``) or a ``ValueError`` is raised — callers then fall back
    to the general CSR engine.
    """
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    A = sp.csr_matrix(A)
    if A.shape != (n, n):
        raise ValueError(f"matrix shape {A.shape} != grid size {n}")
    coo = A.tocoo()
    rc = np.stack(np.unravel_index(coo.row, shape), axis=1)  # (nnz, d)
    cc = np.stack(np.unravel_index(coo.col, shape), axis=1)
    deltas = cc - rc  # (nnz, d)
    uniq, inverse = np.unique(deltas, axis=0, return_inverse=True)
    if len(uniq) > max_offsets:
        raise ValueError(
            f"matrix has {len(uniq)} distinct grid offsets (> {max_offsets}); "
            "not stencil-representable within budget"
        )
    offsets = tuple(tuple(int(v) for v in row) for row in uniq)
    coeffs = np.zeros((len(offsets),) + shape, dtype=coo.data.dtype)
    flat = coeffs.reshape(len(offsets), n)
    # accumulate (duplicates summed, matching CSR semantics)
    np.add.at(flat, (inverse, coo.row), coo.data)
    # put the zero offset first if present (diagonal-first convention)
    zero = (0,) * len(shape)
    if zero in offsets:
        z = offsets.index(zero)
        if z != 0:
            order = [z] + [i for i in range(len(offsets)) if i != z]
            offsets = tuple(offsets[i] for i in order)
            coeffs = coeffs[order]
    return offsets, coeffs


def diffusion_stencil(kappa, harmonic: bool = True, dtype=np.float64):
    """Variable-coefficient diffusion operator ``−∇·(κ∇u)`` on a regular
    grid (Dirichlet), finite-volume form with face coefficients.

    Beyond the reference's constant-coefficient Poisson (R1): exercises
    the varying-coefficient stencil path end to end (general hierarchy
    build, non-constant Galerkin levels, grid-array inverse diagonals).

    ``kappa``: positive cell coefficient field, shape = grid shape.  Face
    coefficient between neighboring cells is the harmonic (default) or
    arithmetic mean — harmonic is the standard finite-volume choice for
    discontinuous media.  Returns ``(offsets, coeffs)`` with the diagonal
    equal to the sum of the face coefficients (an SPD M-matrix; reduces
    exactly to :func:`poisson_stencil` for ``kappa ≡ 1``).
    """
    kappa = np.asarray(kappa, dtype=dtype)
    if np.any(kappa <= 0):
        raise ValueError("kappa must be strictly positive")
    shape = kappa.shape
    d = len(shape)
    offsets = poisson_offsets(d)
    coeffs = np.zeros((len(offsets),) + shape, dtype=dtype)

    def face(a, b):
        return 2.0 * a * b / (a + b) if harmonic else 0.5 * (a + b)

    k = 1
    for axis in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[axis] = slice(0, shape[axis] - 1)
        hi[axis] = slice(1, None)
        f = face(kappa[tuple(lo)], kappa[tuple(hi)])  # interior faces
        # offsets ordered (-1) then (+1) per axis (poisson_offsets)
        coeffs[(k,) + tuple(hi)] = -f  # coupling to the −1 neighbor
        coeffs[(k + 1,) + tuple(lo)] = -f  # coupling to the +1 neighbor
        k += 2
        # boundary faces (Dirichlet): cell couples to the wall with its
        # own κ, contributing to the diagonal only
        wall_lo = [slice(None)] * d
        wall_lo[axis] = slice(0, 1)
        wall_hi = [slice(None)] * d
        wall_hi[axis] = slice(shape[axis] - 1, None)
        coeffs[0][tuple(wall_lo)] += kappa[tuple(wall_lo)]
        coeffs[0][tuple(wall_hi)] += kappa[tuple(wall_hi)]
    # diagonal = − Σ off-diagonal couplings + boundary terms
    coeffs[0] += -np.sum(coeffs[1:], axis=0)
    return offsets, coeffs


def diffusion(kappa, harmonic: bool = True) -> sp.csr_matrix:
    """CSR form of :func:`diffusion_stencil` (oracle/interchange)."""
    offsets, coeffs = diffusion_stencil(kappa, harmonic)
    return stencil_to_csr(offsets, coeffs)


def rhs_random(shape, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Reproducible random right-hand side on the grid."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(tuple(int(s) for s in shape)).astype(dtype)


def rhs_ones(shape, dtype=np.float64) -> np.ndarray:
    return np.ones(tuple(int(s) for s in shape), dtype=dtype)
