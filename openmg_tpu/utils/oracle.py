"""Pure-numpy mirror of the reference multigrid algorithm (SURVEY.md §3.2).

The reference mount was empty at survey time (SURVEY.md §0), so this module
*is* the behavioral ground truth for the build: a ~150-LoC numpy/scipy
implementation of the published openmg algorithm — geometric aggregation
restriction (each coarse point averages its 2^d fine children with weight
1/2^d), Galerkin coarsening ``A_c = R A Rᵀ``, stationary pre-smoothing
(lexicographic Gauss–Seidel or weighted Jacobi), recursive V-cycle with a
direct solve at the coarsest level, and an outer cycle loop that runs until
``‖b − A x‖₂ < threshold`` (SURVEY.md §3.1, components R2–R8).

The JAX solver is validated against this mirror for both the fixed point
(matches a direct solve) and the per-cycle residual trajectory (when using
the same smoother).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = [
    "aggregate_restriction",
    "taps_matrix_1d",
    "weighted_restriction",
    "weighted_prolongation",
    "restrictions",
    "coarsen_A",
    "max_gridlevels",
    "gauss_seidel_np",
    "jacobi_np",
    "v_cycle_np",
    "reference_mg_solve",
]


def max_gridlevels(shape) -> int:
    """Deepest hierarchy reachable by factor-2 coarsening (all dims must be
    even to halve; a dim of 1 stays 1)."""
    shape = [int(s) for s in shape]
    levels = 1
    while all(s == 1 or s % 2 == 0 for s in shape) and any(s > 1 for s in shape):
        shape = [max(1, s // 2) for s in shape]
        levels += 1
    return levels


def aggregate_restriction(shape) -> sp.csr_matrix:
    """Geometric aggregation restriction R (reference component R2).

    ``R[c, f] = 1/2^d`` for each of the ``2^d`` fine children ``f`` of coarse
    point ``c`` (per-dim children ``2c`` and ``2c+1``; dims of size 1 are not
    coarsened).  Shape ``(prod(coarse), prod(fine))``.
    """
    shape = tuple(int(s) for s in shape)
    cshape = tuple(max(1, s // 2) for s in shape)
    if any(s > 1 and s % 2 for s in shape):
        raise ValueError(f"all dims > 1 must be even to coarsen, got {shape}")
    d_eff = sum(1 for s in shape if s > 1)
    w = 1.0 / (2**d_eff)
    # children of coarse index C: fine index 2C + p per coarsened dim
    cgrid = np.indices(cshape)  # (d, *cshape)
    rows_all, cols_all = [], []
    parities = np.indices(tuple(2 if s > 1 else 1 for s in shape))
    parities = parities.reshape(len(shape), -1).T  # (2^d_eff, d)
    crow = np.ravel_multi_index(
        tuple(cgrid[a] for a in range(len(shape))), cshape
    ).ravel()
    for p in parities:
        fine = tuple(
            (2 * cgrid[a] + p[a]) if shape[a] > 1 else cgrid[a]
            for a in range(len(shape))
        )
        fcol = np.ravel_multi_index(fine, shape).ravel()
        rows_all.append(crow)
        cols_all.append(fcol)
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.full(rows.shape, w)
    R = sp.coo_matrix(
        (vals, (rows, cols)), shape=(int(np.prod(cshape)), int(np.prod(shape)))
    ).tocsr()
    return R


def taps_matrix_1d(n: int, taps) -> sp.csr_matrix:
    """1D tap operator: ``M[c, 2c + t] += w`` for each tap ``(t, w)``,
    shape ``(n/2, n)``, out-of-range taps dropped (zero-fill)."""
    m = n // 2
    rows, cols, vals = [], [], []
    for c in range(m):
        for t, w in taps:
            f = 2 * c + t
            if 0 <= f < n:
                rows.append(c)
                cols.append(f)
                vals.append(w)
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


def _kron_over_axes(shape, taps):
    M = None
    for s in shape:
        Ms = sp.identity(1, format="csr") if s == 1 else taps_matrix_1d(s, taps)
        M = Ms if M is None else sp.kron(M, Ms, format="csr")
    return M.tocsr()


def weighted_restriction(shape, r_taps) -> sp.csr_matrix:
    """Explicit separable restriction matrix (tensor product of 1D taps) —
    oracle for :func:`openmg_tpu.ops.transfer.restrict`."""
    return _kron_over_axes(tuple(int(s) for s in shape), r_taps)


def weighted_prolongation(shape, p_taps) -> sp.csr_matrix:
    """Explicit separable prolongation matrix: transpose structure of the
    taps (``P[2c+t, c] += w``) — oracle for transfer.prolong."""
    return _kron_over_axes(tuple(int(s) for s in shape), p_taps).T.tocsr()


def restrictions(shape, gridlevels: int):
    """List of per-level restriction operators R[0..gridlevels-2]
    (reference `restrictions(...)`, SURVEY.md R3)."""
    Rs, shapes = [], [tuple(int(s) for s in shape)]
    for _ in range(gridlevels - 1):
        Rs.append(aggregate_restriction(shapes[-1]))
        shapes.append(tuple(max(1, s // 2) for s in shapes[-1]))
    return Rs, shapes


def coarsen_A(A, Rs):
    """Galerkin coarse operators ``A[l+1] = R[l] A[l] R[l]ᵀ`` (R3)."""
    As = [sp.csr_matrix(A)]
    for R in Rs:
        As.append((R @ As[-1] @ R.T).tocsr())
    return As


def gauss_seidel_np(A, b, x, iterations: int) -> np.ndarray:
    """Lexicographic forward Gauss–Seidel sweeps (reference smoother R4),
    via lower-triangular solve: x += (D+L)^{-1} (b - A x)."""
    A = sp.csr_matrix(A)
    M = sp.tril(A, k=0, format="csr")
    for _ in range(iterations):
        r = b - A @ x
        x = x + spla.spsolve_triangular(M, r, lower=True)
    return x


def jacobi_np(A, b, x, iterations: int, omega: float = 2.0 / 3.0) -> np.ndarray:
    """Weighted-Jacobi sweeps: x += ω D^{-1} (b - A x)."""
    A = sp.csr_matrix(A)
    dinv = 1.0 / A.diagonal()
    for _ in range(iterations):
        x = x + omega * dinv * (b - A @ x)
    return x


def _smooth(name, A, b, x, iterations, omega):
    if name == "gauss_seidel":
        return gauss_seidel_np(A, b, x, iterations)
    if name == "jacobi":
        return jacobi_np(A, b, x, iterations, omega)
    raise ValueError(f"unknown smoother {name!r}")


def v_cycle_np(
    As, Rs, b, x, level=0, pre=1, post=0, smoother="gauss_seidel", omega=2.0 / 3.0
):
    """Recursive V-cycle (reference `mg_cycle`, SURVEY.md §3.2)."""
    A = As[level]
    if level == len(As) - 1:
        return spla.spsolve(sp.csc_matrix(A), b)  # direct coarse solve (R8)
    if pre:
        x = _smooth(smoother, A, b, x, pre, omega)
    r = b - A @ x
    bc = Rs[level] @ r
    ec = v_cycle_np(As, Rs, bc, np.zeros_like(bc), level + 1, pre, post, smoother, omega)
    x = x + Rs[level].T @ ec
    if post:
        x = _smooth(smoother, A, b, x, post, omega)
    return x


def reference_mg_solve(A, b, parameters: dict):
    """Mirror of the reference driver ``mg_solve(A_in, b, parameters)``
    (SURVEY.md §3.1, R7).

    Parameters dict vocabulary matches the reference: ``problemshape``,
    ``gridlevels``, ``iterations`` (pre-smoothing sweeps), ``cycles``
    (max V-cycles; 0 → unlimited), ``threshold`` (absolute ‖r‖₂ target),
    ``verbose``.  Extra keys (non-reference extensions): ``smoother``
    ("gauss_seidel"|"jacobi"), ``omega``, ``post_iterations``.

    Returns ``(x, info)`` with per-cycle residual-norm history.
    """
    p = dict(parameters)
    shape = tuple(int(s) for s in p["problemshape"])
    gridlevels = int(p.get("gridlevels") or max_gridlevels(shape))
    gridlevels = min(gridlevels, max_gridlevels(shape))
    pre = int(p.get("iterations", 1))
    post = int(p.get("post_iterations", 0))
    cycles = int(p.get("cycles", 100))
    threshold = float(p.get("threshold", 1e-10))
    verbose = bool(p.get("verbose", False))
    smoother = p.get("smoother", "gauss_seidel")
    omega = float(p.get("omega", 2.0 / 3.0))

    A = sp.csr_matrix(A)
    b = np.asarray(b, dtype=np.float64).ravel()
    Rs, _shapes = restrictions(shape, gridlevels)
    As = coarsen_A(A, Rs)

    x = np.zeros_like(b)
    history = []
    limit = cycles if cycles > 0 else 10_000
    converged = False
    for cycle in range(limit):
        rnorm = float(np.linalg.norm(b - A @ x))
        history.append(rnorm)
        if verbose:
            print(f"[oracle] cycle {cycle}: ‖r‖ = {rnorm:.3e}")
        if rnorm < threshold:
            converged = True
            break
        x = v_cycle_np(As, Rs, b, x, 0, pre, post, smoother, omega)
    final = float(np.linalg.norm(b - A @ x))
    history.append(final)
    info = {
        "residual_norms": history,
        "cycles": len(history) - 1,
        "converged": converged or final < threshold,
        "final_norm": final,
        "gridlevels": gridlevels,
    }
    return x, info
