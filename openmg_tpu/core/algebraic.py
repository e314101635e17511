"""General sparse-matrix multigrid — the compatibility engine (T1 + R7).

The stencil engine (:mod:`openmg_tpu.core.hierarchy`) covers every
grid-structured operator; this module covers the rest of the reference's
input domain: ``mg_solve(A, b, parameters)`` with an **arbitrary** sparse
SPD matrix over the grid named by ``problemshape`` (SURVEY.md R7 — the
reference never requires A to be a stencil, only the restriction to be
geometric).  The algorithm is exactly the reference's (SURVEY.md §3.1/3.2):

* explicit geometric restriction/prolongation matrices per level
  (tap tensor products, :mod:`openmg_tpu.utils.oracle` builders);
* Galerkin coarsening ``A[l+1] = R A P`` by scipy SpGEMM at setup (one-time,
  host — SURVEY.md T6);
* levels stored in the padded-static-nnz containers of
  :mod:`openmg_tpu.ops.sparse` (ELL / CSR / BSR per config — T1);
* smoothing by weighted Jacobi or multicolor Gauss–Seidel (a greedy host
  coloring generalizes red-black to arbitrary sparsity; on parity-bipartite
  levels it reduces to exactly two colors = RB-GS);
* V-cycle unrolled over the static level list; dense direct coarse solve;
* the same double-float defect-correction outer loop as the stencil engine
  (1e-10 absolute residuals with no f64 on device).

Multicolor GS uses the identity ``x_i ← x_i + (b − A x)_i / a_ii`` applied
one color class at a time — each colored update equals the classical GS
update because same-color points never couple, so no off-diagonal split of
A is ever materialized.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import jax
import jax.numpy as jnp

from openmg_tpu.core.config import SolverConfig
from openmg_tpu.ops.doublefloat import df_add_f32, df_merge, df_split, df_sub
from openmg_tpu.ops.sparse import (
    ELLMatrix,
    dense_matvec,
    ell_from_scipy,
    from_scipy,
    spmv,
    spmv_df,
)
from openmg_tpu.ops.transfer import TRANSFERS
from openmg_tpu.utils.oracle import (
    weighted_prolongation,
    weighted_restriction,
)

__all__ = [
    "SparseLevel",
    "SparseHierarchy",
    "build_sparse_hierarchy",
    "sparse_v_cycle",
    "sparse_fmg_cycle",
    "AlgebraicSolver",
    "setup_sparse",
    "parity_colors",
    "greedy_colors",
]


# ---------------------------------------------------------------------------
# coloring (setup-time, host)
# ---------------------------------------------------------------------------


def parity_colors(A, shape) -> np.ndarray | None:
    """Red-black coloring by grid-coordinate parity, or None if the matrix
    couples same-parity points (then RB half-sweeps would not be true GS).

    Vectorized (no per-row Python loop) — valid for all 2d+1-point
    operators, e.g. Poisson and its aggregation-Galerkin coarsenings.
    """
    import scipy.sparse as sp

    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if A.shape[0] != n:
        return None
    coo = sp.coo_matrix(A)
    par = np.zeros(n, dtype=np.int32)
    for idx in np.unravel_index(np.arange(n), shape):
        par ^= (idx & 1).astype(np.int32)
    off = coo.row != coo.col
    if np.any(par[coo.row[off]] == par[coo.col[off]]):
        return None
    return par


def greedy_colors(A) -> np.ndarray:
    """Greedy graph coloring of the (symmetrized) sparsity graph.

    Host-side Python loop over rows — O(nnz); used only at setup and only
    for levels where parity coloring fails.
    """
    import scipy.sparse as sp

    S = sp.csr_matrix(A)
    S = (S + S.T).tocsr()  # color the symmetrized adjacency
    n = S.shape[0]
    colors = np.full(n, -1, dtype=np.int32)
    indptr, indices = S.indptr, S.indices
    for i in range(n):
        neigh = indices[indptr[i] : indptr[i + 1]]
        used = set(int(c) for c in colors[neigh] if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


# ---------------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("A", "inv_diag", "R", "P", "colors", "lam_max"),
    meta_fields=("num_colors",),
)
@dataclasses.dataclass(frozen=True)
class SparseLevel:
    """One level of the general-sparse hierarchy.

    ``R``/``P`` map this level to/from the next-coarser one (None at the
    coarsest level); ``colors`` is the GS coloring (None when smoothing
    with Jacobi); ``lam_max`` is the setup-time Gershgorin bound on
    λmax(D⁻¹A) used by the Chebyshev smoother.
    """

    A: object  # ELLMatrix | CSRMatrix | BSRMatrix
    inv_diag: jax.Array  # (n,)
    R: object | None
    P: object | None
    colors: jax.Array | None  # (n,) int32
    num_colors: int
    lam_max: jax.Array | None = None  # scalar

    @property
    def n(self) -> int:
        return self.A.shape[0]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("levels", "coarse_inv", "fine_hi", "fine_lo"),
    meta_fields=("stats", "fmt", "shapes", "transfer_name", "dofs"),
)
@dataclasses.dataclass(frozen=True)
class SparseHierarchy:
    levels: tuple  # tuple[SparseLevel, ...], finest first
    coarse_inv: jax.Array  # (nc, nc)
    fine_hi: ELLMatrix  # outer-residual operator, hi part
    fine_lo: ELLMatrix | None  # lo part (doublefloat) or None
    stats: tuple  # per-level (n, k_or_kb, true_nnz)
    fmt: str
    # per-level grid shapes + the transfer spec the explicit R/P were
    # built from: factor-2 level pairs apply transfers as the separable
    # strided grid ops (ops/transfer.py — gather-free) instead of SpMV
    # with the explicit ELL matrix.  None (legacy/hand-built
    # hierarchies) keeps the SpMV path.
    shapes: tuple | None = None
    transfer_name: str | None = None
    # dofs per node (vector PDEs — models/elasticity.py): transfers are
    # node transfers ⊗ I_dofs; the separable geometric fast path below is
    # scalar-only, so dofs > 1 keeps the explicit-SpMV transfer path.
    dofs: int = 1

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def n(self) -> int:
        return self.levels[0].n

    def geom_transfer(self, level: int):
        """The ``(fine_shape, coarse_shape, Transfer)`` triple when level →
        level+1 can run the separable strided grid transfers (every axis
        either halves exactly or is a kept size-1 axis), else None."""
        if self.shapes is None or self.transfer_name is None or self.dofs != 1:
            return None
        if level >= len(self.shapes) - 1:
            return None
        fs, cs = self.shapes[level], self.shapes[level + 1]
        if not all(f == 2 * c or (f == c == 1) for f, c in zip(fs, cs)):
            return None
        from openmg_tpu.ops.transfer import TRANSFERS

        return fs, cs, TRANSFERS[self.transfer_name]


def _resolve_blocksize(n: int, want: int) -> int:
    """Largest divisor of n that is <= want (BSR needs exact tiling)."""
    b = min(max(int(want), 1), n)
    while n % b:
        b -= 1
    return b


def build_sparse_hierarchy(
    A,
    shape,
    gridlevels=None,
    fmt: str = "ell",
    transfer_name: str = "aggregate",
    dtype=np.float32,
    residual_dtype: str = "doublefloat",
    max_dense_coarse: int = 512,
    blocksize: int = 4,
    smoother: str = "jacobi",
    dofs: int = 1,
) -> SparseHierarchy:
    """Host-side setup: explicit R/P chain, scipy-SpGEMM Galerkin RAP,
    conversion to padded-static-nnz device containers (SURVEY.md T1/T6).

    ``dofs`` > 1 treats ``shape`` as the NODE grid of a vector PDE with
    that many unknowns per node (node-major, dof-minor ordering):
    transfers become the block transfers ``R_node ⊗ I_dofs``, which keep
    the Galerkin-coarsened operators block-structured with the same
    blocksize — the natural pairing with ``fmt='bsr'``
    (models/elasticity.py)."""
    import scipy.sparse as sp

    from openmg_tpu.utils.oracle import max_gridlevels

    shape = tuple(int(s) for s in shape)
    dofs = int(dofs)
    if dofs < 1:
        raise ValueError(f"dofs must be >= 1, got {dofs}")
    n = dofs * int(np.prod(shape))
    A = sp.csr_matrix(A).astype(np.float64)
    if A.shape != (n, n):
        raise ValueError(
            f"matrix shape {A.shape} != grid {shape} × {dofs} dofs ({n} rows)"
        )
    transfer = TRANSFERS[transfer_name]

    if gridlevels is None:
        gridlevels = 1
        s, cnt = list(shape), n
        while cnt > max_dense_coarse and gridlevels < max_gridlevels(shape):
            s = [max(1, v // 2) for v in s]
            cnt = dofs * int(np.prod(s))
            gridlevels += 1
    gridlevels = min(int(gridlevels), max_gridlevels(shape))

    # explicit transfer matrices + Galerkin chain (scipy SpGEMM, setup-only)
    shapes = [shape]
    As, Rs, Ps = [A], [], []
    for _ in range(gridlevels - 1):
        s = shapes[-1]
        R = weighted_restriction(s, transfer.r_taps)
        P = weighted_prolongation(s, transfer.p_taps)
        if dofs > 1:
            I = sp.eye(dofs, format="csr")
            R = sp.kron(R, I, format="csr")
            P = sp.kron(P, I, format="csr")
        Rs.append(R)
        Ps.append(P)
        As.append((R @ As[-1] @ P).tocsr())
        shapes.append(tuple(max(1, v // 2) for v in s))

    nc = As[-1].shape[0]
    if nc > max_dense_coarse:
        from openmg_tpu.core.hierarchy import _UNCOARSENABLE_DENSE_CAP

        # uncoarsenable grids degrade to the plain dense solve (bounded
        # by a hard cap) instead of erroring — same policy as the
        # stencil hierarchy (core/hierarchy.py::_coarse_inverse)
        if gridlevels == 1 and nc <= _UNCOARSENABLE_DENSE_CAP:
            import warnings

            warnings.warn(
                f"grid cannot be coarsened; solving its {nc} unknowns "
                f"directly (above max_dense_coarse={max_dense_coarse})",
                stacklevel=2,
            )
        else:
            raise ValueError(
                f"coarsest level has {nc} unknowns > max_dense_coarse="
                f"{max_dense_coarse}; increase gridlevels"
            )
    coarse_inv = np.linalg.inv(As[-1].toarray())

    levels, stats = [], []
    for lvl in range(gridlevels):
        Al = As[lvl]
        diag = Al.diagonal()
        if np.any(diag == 0):
            raise ValueError(f"level {lvl} operator has zero diagonal entries")
        if fmt == "bsr":
            bs = _resolve_blocksize(Al.shape[0], blocksize)
            Adev = from_scipy(Al, "bsr", dtype=dtype, blocksize=(bs, bs))
        elif fmt == "dense":
            if Al.shape[0] > 16384:
                raise ValueError(
                    f"format='dense' is a debug mode; level 0 has "
                    f"{Al.shape[0]} rows (> 16384) — use a sparse format"
                )
            Adev = from_scipy(Al, "dense", dtype=dtype)
        else:
            Adev = from_scipy(Al, fmt, dtype=dtype)
        colors_np = None
        if smoother == "rbgs":
            colors_np = (
                parity_colors(Al, shapes[lvl]) if dofs == 1 else None
            )
            if colors_np is None:
                colors_np = greedy_colors(Al)
        # R/P stored in ELL regardless of the cycle format (rectangular,
        # few taps per row — ELL is the natural layout)
        R = ell_from_scipy(Rs[lvl], dtype=dtype) if lvl < gridlevels - 1 else None
        P = ell_from_scipy(Ps[lvl], dtype=dtype) if lvl < gridlevels - 1 else None
        abs_off = np.asarray(np.abs(Al).sum(axis=1)).ravel() - np.abs(diag)
        lam_max = 1.0 + float(np.max(abs_off / np.abs(diag)))
        levels.append(
            SparseLevel(
                A=Adev,
                inv_diag=jnp.asarray(1.0 / diag, dtype=dtype),
                R=R,
                P=P,
                colors=(
                    jnp.asarray(colors_np) if colors_np is not None else None
                ),
                num_colors=(
                    int(colors_np.max()) + 1 if colors_np is not None else 0
                ),
                lam_max=jnp.asarray(lam_max, dtype=dtype),
            )
        )
        k_stat = Adev.kb if fmt == "bsr" else Adev.k if fmt == "ell" else 0
        stats.append((int(Al.shape[0]), int(k_stat), int(Al.nnz)))

    # outer-residual operator: exact two-f32 split of the f64 fine matrix
    fine_ell64 = ell_from_scipy(A, dtype=np.float64)
    d64 = np.asarray(fine_ell64.data)
    hi = d64.astype(np.float32)
    if residual_dtype == "doublefloat":
        lo = (d64 - hi.astype(np.float64)).astype(np.float32)
        fine_hi = dataclasses.replace(fine_ell64, data=jnp.asarray(hi))
        fine_lo = dataclasses.replace(fine_ell64, data=jnp.asarray(lo))
    else:
        rd = np.dtype(residual_dtype)
        fine_hi = dataclasses.replace(
            fine_ell64, data=jnp.asarray(d64.astype(rd))
        )
        fine_lo = None
    return SparseHierarchy(
        levels=tuple(levels),
        coarse_inv=jnp.asarray(coarse_inv, dtype=dtype),
        fine_hi=fine_hi,
        fine_lo=fine_lo,
        stats=tuple(stats),
        fmt=fmt,
        shapes=tuple(tuple(int(v) for v in s) for s in shapes),
        transfer_name=transfer_name,
        dofs=dofs,
    )


# ---------------------------------------------------------------------------
# cycle
# ---------------------------------------------------------------------------


def _smooth_sparse(level: SparseLevel, b, x, iterations: int, smoother, omega):
    if iterations <= 0:
        return x
    if smoother == "chebyshev":
        # 4th-kind Chebyshev (ops.smoothers.chebyshev) on flat vectors;
        # Gershgorin λmax precomputed at setup from the scipy operator
        lam = level.lam_max
        r = b - spmv(level.A, x)
        d = (4.0 / 3.0) / lam * level.inv_diag * r
        for k in range(1, iterations + 1):
            x = x + d
            if k == iterations:
                break
            r = r - spmv(level.A, d)
            d = ((2 * k - 1) / (2 * k + 3)) * d + (
                (8 * k + 4) / (2 * k + 3)
            ) / lam * level.inv_diag * r
        return x
    if smoother == "jacobi" or level.colors is None:
        om = jnp.asarray(omega, dtype=x.dtype)
        for _ in range(iterations):
            x = x + om * level.inv_diag * (b - spmv(level.A, x))
        return x
    if smoother == "rbgs":
        for _ in range(iterations):
            for c in range(level.num_colors):
                upd = x + level.inv_diag * (b - spmv(level.A, x))
                x = jnp.where(level.colors == c, upd, x)
        return x
    raise ValueError(f"unknown smoother {smoother!r}")


def _restrict_level(hierarchy: SparseHierarchy, level: int, r):
    """``R r`` at ``level``: separable strided grid ops on factor-2 level
    pairs (gather-free), explicit-ELL SpMV otherwise.
    Identical values either way (the explicit matrices are built FROM the
    tap tensor product — utils/oracle.py; agreement pinned in
    tests/test_transfer.py)."""
    geom = hierarchy.geom_transfer(level)
    if geom is not None:
        from openmg_tpu.ops.transfer import restrict

        fs, cs, transfer = geom
        return restrict(r.reshape(fs), transfer).reshape(-1)
    return spmv(hierarchy.levels[level].R, r)


def _prolong_level(hierarchy: SparseHierarchy, level: int, ec):
    """``P e`` at ``level`` (coarse level+1 → fine level); see
    :func:`_restrict_level`."""
    geom = hierarchy.geom_transfer(level)
    if geom is not None:
        from openmg_tpu.ops.transfer import prolong

        fs, cs, transfer = geom
        return prolong(ec.reshape(cs), fs, transfer).reshape(-1)
    return spmv(hierarchy.levels[level].P, ec)


def sparse_v_cycle(
    hierarchy: SparseHierarchy,
    b,
    x,
    level: int = 0,
    pre: int = 2,
    post: int = 2,
    smoother: str = "jacobi",
    omega: float = 2.0 / 3.0,
    gamma: int = 1,
):
    """One µ-cycle on flat vectors (``gamma=1`` → V, 2 → W); unrolls at
    trace time (T7)."""
    L = hierarchy.levels[level]
    if level == hierarchy.num_levels - 1:
        return dense_matvec(hierarchy.coarse_inv, b)
    x = _smooth_sparse(L, b, x, pre, smoother, omega)
    r = b - spmv(L.A, x)
    bc = _restrict_level(hierarchy, level, r)
    ec = jnp.zeros_like(bc)
    visits = 1 if level == hierarchy.num_levels - 2 else gamma
    for _ in range(visits):
        ec = sparse_v_cycle(
            hierarchy, bc, ec, level + 1, pre, post, smoother, omega, gamma
        )
    x = x + _prolong_level(hierarchy, level, ec)
    x = _smooth_sparse(L, b, x, post, smoother, omega)
    return x


def sparse_fmg_cycle(
    hierarchy: SparseHierarchy,
    b,
    pre: int = 2,
    post: int = 2,
    smoother: str = "jacobi",
    omega: float = 2.0 / 3.0,
):
    """Full-multigrid pass from a zero guess (cf. core.cycle.fmg_cycle)."""
    bs = [b]
    for lvl in range(hierarchy.num_levels - 1):
        bs.append(_restrict_level(hierarchy, lvl, bs[-1]))
    x = dense_matvec(hierarchy.coarse_inv, bs[-1])
    for lvl in range(hierarchy.num_levels - 2, -1, -1):
        x = _prolong_level(hierarchy, lvl, x)
        x = sparse_v_cycle(
            hierarchy, bs[lvl], x, lvl, pre, post, smoother, omega
        )
    return x


def _sparse_cycle_impl(
    hierarchy, r, *, pre, post, smoother, cycle_type, omega
):
    r32 = r.astype(hierarchy.levels[0].inv_diag.dtype)
    if cycle_type == "f":
        return sparse_fmg_cycle(hierarchy, r32, pre, post, smoother, omega)
    gamma = {"v": 1, "w": 2}.get(cycle_type)
    if gamma is None:
        raise ValueError(f"unknown cycle_type {cycle_type!r}; choose v|w|f")
    return sparse_v_cycle(
        hierarchy, r32, jnp.zeros_like(r32), 0, pre, post, smoother, omega,
        gamma,
    )


def _sparse_pcg_impl(
    hierarchy, r0, *, iters, pre, post, smoother, cycle_type, omega
):
    """``iters`` MG-preconditioned CG steps on ``A e = r0`` from zero —
    the general-sparse mirror of ``core.cycle.pcg_solve`` (one SpMV on
    the fine level operator + one cycle per step, static trip count)."""
    A0 = hierarchy.levels[0].A
    r32 = r0.astype(hierarchy.levels[0].inv_diag.dtype)

    def precond(rr):
        return _sparse_cycle_impl(
            hierarchy, rr, pre=pre, post=post, smoother=smoother,
            cycle_type=cycle_type, omega=omega,
        )

    e = jnp.zeros_like(r32)
    r = r32
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)
    for it in range(iters):
        Ap = spmv(A0, p)
        alpha = rz / jnp.sum(p * Ap)
        e = e + alpha * p
        if it == iters - 1:
            break
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / rz
        rz = rz_new
        p = z + beta * p
    return e


def _sparse_error_impl(
    hierarchy, r, *,
    pre, post, smoother, cycle_type, omega,
    krylov="none", krylov_iters=2,
):
    """Inner error solve: pure cycle or MG-preconditioned CG."""
    if krylov == "pcg":
        return _sparse_pcg_impl(
            hierarchy, r, iters=krylov_iters, pre=pre, post=post,
            smoother=smoother, cycle_type=cycle_type, omega=omega,
        )
    return _sparse_cycle_impl(
        hierarchy, r, pre=pre, post=post, smoother=smoother,
        cycle_type=cycle_type, omega=omega,
    )


_sparse_cycle_step = jax.jit(
    _sparse_error_impl,
    static_argnames=(
        "pre", "post", "smoother", "cycle_type", "omega",
        "krylov", "krylov_iters",
    ),
)


def _sparse_residual_df_t(fine_hi, fine_lo, b_df, x_df):
    ax = spmv_df(fine_hi, fine_lo, x_df[0], x_df[1])
    r = df_sub(b_df, ax)
    return r, jnp.sqrt(jnp.sum(r[0] * r[0]))


def _sparse_residual_t(fine_hi, b, x):
    r = b - spmv(fine_hi, x)
    return r, jnp.sqrt(jnp.sum(r * r))


_sparse_residual_df = jax.jit(_sparse_residual_df_t)
_sparse_residual = jax.jit(_sparse_residual_t)


@functools.partial(
    jax.jit,
    static_argnames=(
        "limit",
        "threshold",
        "pre",
        "post",
        "smoother",
        "cycle_type",
        "omega",
        "df",
        "krylov",
        "krylov_iters",
    ),
)
def _sparse_solve_device(
    h, b, x, *, limit, threshold, pre, post, smoother, cycle_type, omega, df,
    krylov="none", krylov_iters=2,
):
    """Whole-solve device program for the sparse engine — same structure
    as core.solver._solve_device (one dispatch per solve; see its
    docstring)."""
    from jax import lax

    def resid(xx):
        if df:
            r_pair, rn = _sparse_residual_df_t(h.fine_hi, h.fine_lo, b, xx)
            return r_pair[0], rn
        return _sparse_residual_t(h.fine_hi, b, xx)

    def apply_cycle(xx, r):
        e = _sparse_error_impl(
            h,
            r,
            pre=pre,
            post=post,
            smoother=smoother,
            cycle_type=cycle_type,
            omega=omega,
            krylov=krylov,
            krylov_iters=krylov_iters,
        )
        if df:
            return df_add_f32(xx, e)
        return xx + e.astype(b.dtype)

    hist0 = jnp.full((limit + 1,), -1.0, dtype=jnp.float32)

    def cond_fn(st):
        _, k, _, done = st
        return jnp.logical_and(jnp.logical_not(done), k <= limit)

    def body_fn(st):
        xx, k, hist, _ = st
        r, rn = resid(xx)
        hist = hist.at[k].set(rn.astype(jnp.float32))
        done = rn < threshold
        do_cycle = jnp.logical_and(jnp.logical_not(done), k < limit)
        xx = lax.cond(
            do_cycle,
            lambda op: apply_cycle(op[0], op[1]),
            lambda op: op[0],
            (xx, r),
        )
        return (xx, k + 1, hist, done)

    x, k, hist, done = lax.while_loop(
        cond_fn, body_fn, (x, jnp.int32(0), hist0, jnp.bool_(False))
    )
    from openmg_tpu.utils.observe import pack_solve_meta

    return x, pack_solve_meta(k, hist, done)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


class AlgebraicSolver:
    """General-sparse solver: same contract as
    :class:`openmg_tpu.core.solver.Solver` (defect-correction outer loop,
    per-cycle residual history) on flat vectors."""

    def __init__(self, hierarchy: SparseHierarchy, config: SolverConfig):
        if config.krylov not in (None, "none", "pcg"):
            raise ValueError(
                f"unknown krylov {config.krylov!r}; choose none|pcg"
            )
        self.hierarchy = hierarchy
        self.config = config
        self.df = hierarchy.fine_lo is not None
        self._cycle = functools.partial(
            _sparse_cycle_step,
            pre=config.pre_iterations,
            post=config.post_iterations,
            smoother=config.smoother,
            cycle_type=config.cycle_type,
            omega=config.omega,
            krylov=config.krylov or "none",
            krylov_iters=config.krylov_iters,
        )

    @property
    def n(self) -> int:
        return self.hierarchy.n

    def solve(self, b, x0=None):
        cfg = self.config
        h = self.hierarchy
        # device-native path (mirrors core.solver.Solver / the distributed
        # engines): a flat f32 jax-array rhs skips the host df_split and
        # the float64 merge/readback — serving callers keep everything on
        # device and read the full pair from info['x_df']
        device_native = (
            self.df and isinstance(b, jax.Array) and b.dtype == jnp.float32
        )
        if device_native:
            b1 = b.reshape(-1)
            b_dev = (b1, jnp.zeros_like(b1))
            if x0 is None:
                x = (jnp.zeros_like(b1), jnp.zeros_like(b1))
            elif isinstance(x0, jax.Array) and x0.dtype == jnp.float32:
                x = (x0.reshape(-1), jnp.zeros_like(b1))
            else:
                x = df_split(np.asarray(x0, dtype=np.float64).reshape(-1))
        else:
            b_np = np.asarray(b, dtype=np.float64).reshape(-1)
            x0_np = (
                np.zeros(self.n)
                if x0 is None
                else np.asarray(x0, dtype=np.float64).reshape(-1)
            )
            if self.df:
                b_dev = df_split(b_np)
                x = df_split(x0_np)
            else:
                rd = h.fine_hi.dtype
                b_dev = jnp.asarray(b_np, dtype=rd)
                x = jnp.asarray(x0_np, dtype=rd)

        limit = cfg.cycles if cfg.cycles > 0 else 10_000

        # device-side outer loop (one dispatch; cf. core.solver)
        if not cfg.verbose and cfg.outer_loop != "host":
            from openmg_tpu.utils.observe import unpack_solve_meta

            t_start = time.perf_counter()
            x, meta = _sparse_solve_device(
                h,
                b_dev,
                x,
                limit=limit,
                threshold=float(cfg.threshold),
                pre=cfg.pre_iterations,
                post=cfg.post_iterations,
                smoother=cfg.smoother,
                cycle_type=cfg.cycle_type,
                omega=cfg.omega,
                df=self.df,
                krylov=cfg.krylov or "none",
                krylov_iters=cfg.krylov_iters,
            )
            k_fin, history, done = unpack_solve_meta(meta)
            solve_time = time.perf_counter() - t_start
            n_cycles = max(k_fin - 1, 0)
            if device_native:
                x_out = x[0]
            else:
                x_out = (
                    df_merge(x)
                    if self.df
                    else np.asarray(x, dtype=np.float64)
                )
            info = {
                "residual_norms": history,
                "cycles": n_cycles,
                "converged": bool(done),
                "final_norm": history[-1] if history else float("nan"),
                "gridlevels": h.num_levels,
                "level_stats": h.stats,
                "format": h.fmt,
                "residual_mode": (
                    "doublefloat" if self.df else str(h.fine_hi.dtype)
                ),
                "num_colors": tuple(l.num_colors for l in h.levels),
                "cycle_times_s": [],
                "mean_cycle_time_s": solve_time / max(n_cycles, 1),
                "outer_loop": "device",
                "solve_time_s": solve_time,
            }
            if device_native:
                info["x_df"] = x
            return x_out, info

        history, cycle_times = [], []
        converged = False
        t_start = time.perf_counter()
        for k in range(limit + 1):
            if self.df:
                r_pair, rnorm = _sparse_residual_df(
                    h.fine_hi, h.fine_lo, b_dev, x
                )
                r = r_pair[0]
            else:
                r, rnorm = _sparse_residual(h.fine_hi, b_dev, x)
            rnorm = float(rnorm)
            history.append(rnorm)
            if cfg.verbose:
                print(f"[openmg_tpu/sparse] cycle {k}: ‖r‖ = {rnorm:.3e}")
            if rnorm < cfg.threshold:
                converged = True
                break
            if k == limit:
                break
            t0 = time.perf_counter()
            e = self._cycle(h, r)
            if self.df:
                x = df_add_f32(x, e)
                x[0].block_until_ready()
            else:
                x = x + e.astype(x.dtype)
                x.block_until_ready()
            cycle_times.append(time.perf_counter() - t0)

        if device_native:
            x_out = x[0]
        else:
            # host numpy out: never re-upload the result to the device
            x_out = (
                df_merge(x)
                if self.df
                else np.asarray(x, dtype=np.float64)
            )
        info = {
            "residual_norms": history,
            "cycles": len(history) - 1,
            "converged": converged,
            "final_norm": history[-1],
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "format": h.fmt,
            "residual_mode": "doublefloat" if self.df else str(h.fine_hi.dtype),
            "num_colors": tuple(l.num_colors for l in h.levels),
            "cycle_times_s": cycle_times,
            "mean_cycle_time_s": (
                float(np.mean(cycle_times[1:] or cycle_times))
                if cycle_times
                else float("nan")
            ),
            "outer_loop": "host",
            "solve_time_s": time.perf_counter() - t_start,
        }
        if device_native:
            info["x_df"] = x
        return x_out, info

    def solve_many(self, bs, x0s=None):
        """Batch of right-hand sides in ONE vmapped device program — the
        general-sparse serving path (same contract as
        ``core.solver.Solver.solve_many``; lockstep while loop, per-rhs
        histories).  Host/numpy input returns stacked float64 ``xs``; a
        ``(K, n)`` f32 jax-array takes the device-native path (no host
        df_split/merge; f32 hi part returned, full pair in
        ``info['x_df']``)."""
        cfg = self.config
        h = self.hierarchy
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        # device-native batch path: (K, n) f32 jax array skips host
        # df_split/stack and the float64 readback (cf. solve())
        device_native = (
            self.df and isinstance(bs, jax.Array) and bs.dtype == jnp.float32
        )
        if device_native:
            K = int(bs.shape[0])
            bK = bs.reshape(K, -1)
            b_in = (bK, jnp.zeros_like(bK))
            if x0s is None:
                x_in = (jnp.zeros_like(bK), jnp.zeros_like(bK))
            elif isinstance(x0s, jax.Array) and x0s.dtype == jnp.float32:
                x_in = (x0s.reshape(K, -1), jnp.zeros_like(bK))
            else:
                x_in = df_split(
                    np.stack(
                        [
                            np.asarray(x, dtype=np.float64).reshape(-1)
                            for x in x0s
                        ]
                    )
                )
        else:
            b_np = np.stack(
                [np.asarray(b, dtype=np.float64).reshape(-1) for b in bs]
            )
            K = b_np.shape[0]
            if x0s is None:
                x0_np = np.zeros_like(b_np)
            else:
                x0_np = np.stack(
                    [np.asarray(x, dtype=np.float64).reshape(-1) for x in x0s]
                )
            if self.df:
                b_in, x_in = df_split(b_np), df_split(x0_np)
            else:
                rd = h.fine_hi.dtype
                b_in = jnp.asarray(b_np, dtype=rd)
                x_in = jnp.asarray(x0_np, dtype=rd)

        t_start = time.perf_counter()
        # Cached jit(vmap(...)): re-running the batching transform per
        # call re-traces the whole solve (see core.solver.Solver.solve_many).
        # The hierarchy is a runtime ARGUMENT (in_axes=None), never a
        # closure — closures bake the level arrays into the lowered module
        # as HLO constants.
        if not hasattr(self, "_solve_many_prog"):
            _kw = dict(
                limit=limit,
                threshold=float(cfg.threshold),
                pre=cfg.pre_iterations,
                post=cfg.post_iterations,
                smoother=cfg.smoother,
                cycle_type=cfg.cycle_type,
                omega=cfg.omega,
                df=self.df,
                krylov=cfg.krylov or "none",
                krylov_iters=cfg.krylov_iters,
            )
            self._solve_many_prog = jax.jit(
                jax.vmap(
                    lambda hh, b1, x1: _sparse_solve_device(
                        hh, b1, x1, **_kw
                    ),
                    in_axes=(None, 0, 0),
                )
            )
        x_out, metas = self._solve_many_prog(h, b_in, x_in)
        from openmg_tpu.utils.observe import unpack_solve_meta

        metas_np = np.asarray(metas)
        solve_time = time.perf_counter() - t_start
        cycles, converged, final_norms, histories = [], [], [], []
        for k in range(K):
            k_fin, hist, done = unpack_solve_meta(metas_np[k])
            cycles.append(max(k_fin - 1, 0))
            converged.append(bool(done))
            final_norms.append(hist[-1] if hist else float("nan"))
            histories.append(hist)
        if device_native:
            xs = x_out[0]
        else:
            xs = (
                df_merge(x_out) if self.df else np.asarray(x_out, np.float64)
            )
        info = {
            "batch": K,
            "cycles": cycles,
            "converged": converged,
            "final_norm": final_norms,
            "residual_norms": histories,
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "format": h.fmt,
            "residual_mode": (
                "doublefloat" if self.df else str(h.fine_hi.dtype)
            ),
            "outer_loop": "device",
            "solve_time_s": solve_time,
        }
        if device_native:
            info["x_df"] = x_out
        return xs, info


def setup_sparse(
    A, shape, config: SolverConfig | None = None, *, dofs: int = 1
) -> AlgebraicSolver:
    """Build an :class:`AlgebraicSolver` for an arbitrary sparse SPD ``A``
    over the grid ``shape`` (the general engine behind ``mg_solve``).
    ``dofs`` > 1 marks a vector PDE with that many unknowns per node
    (block transfers; pair with ``format='bsr'`` and
    ``blocksize=dofs`` — see models/elasticity.py)."""
    config = config or SolverConfig()
    fmt = config.format if config.format not in (None, "auto", "stencil") else "ell"
    rmode = (
        config.residual_dtype
        if config.residual_dtype not in (None, "auto")
        else "doublefloat"
    )
    hierarchy = build_sparse_hierarchy(
        A,
        shape,
        gridlevels=config.gridlevels,
        fmt=fmt,
        transfer_name=config.transfer,
        dtype=np.dtype(config.dtype),
        residual_dtype=rmode,
        max_dense_coarse=config.max_dense_coarse,
        blocksize=config.blocksize,
        smoother=config.smoother,
        dofs=dofs,
    )
    return AlgebraicSolver(hierarchy, config)
