"""Grid-hierarchy construction (components R3, T6, T7 setup, T8).

Two builders:

* :func:`build_hierarchy` — host path (numpy; used on CPU and for general
  user-provided operators).  Setup runs eagerly in ``setup_dtype``
  (float32 by default — exact for the dyadic-rational stencils of Poisson
  hierarchies; coarse operators are preconditioner components, so reduced
  setup precision perturbs only the convergence *rate*, never the
  converged answer).
* :func:`build_hierarchy_device` — jitted path: the whole RAP chain,
  diagonal inverses, and constancy statistics are computed by ONE jitted
  program instead of many eager host steps.

Both builders detect **constant-coefficient levels** (translation-invariant
stencil + Dirichlet zero-truncation — true of Poisson fine operators and
all aggregation-Galerkin coarsenings) and store them as ``(K,)`` value
vectors instead of ``(K, *grid)`` arrays: smoother/SpMV sweeps then spend
no memory bandwidth on coefficients.

The coarsest level is factored into an explicit dense inverse so the
in-cycle coarse solve is a single dense matrix-vector product.  The result is a static
pytree of levels over which the V-cycle unrolls at trace time into one XLA
program.
"""

from __future__ import annotations

import dataclasses
import functools
from contextlib import nullcontext as _nullcontext

import numpy as np
import jax
import jax.numpy as jnp

from openmg_tpu.models.poisson import stencil_to_csr
from openmg_tpu.ops.galerkin import galerkin_rap_stencil, rap_output_offsets
from openmg_tpu.ops.stencil import StencilOperator, diag_index
from openmg_tpu.ops.transfer import AGGREGATE, Transfer, coarse_shape

__all__ = [
    "Level",
    "Hierarchy",
    "build_hierarchy",
    "build_hierarchy_device",
    "build_hierarchy_structured",
    "default_gridlevels",
]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("A", "inv_diag"),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class Level:
    A: StencilOperator
    inv_diag: jax.Array  # grid-shaped (varying) or scalar (constant) 1/diag

    @property
    def grid_shape(self):
        return self.A.grid_shape


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("levels", "coarse_inv", "fine_hi", "fine_hi_lo"),
    meta_fields=("stats", "transfer"),
)
@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: tuple  # tuple[Level, ...], finest first
    coarse_inv: jax.Array  # (nc, nc) dense inverse of the coarsest operator
    fine_hi: StencilOperator  # fine operator for the outer residual
    # double-float residual mode: fine_hi holds the f32 hi coefficients and
    # fine_hi_lo the f32 lo remainders (exact two-f32 split of the f64
    # operator); None in plain float modes.
    fine_hi_lo: StencilOperator | None
    stats: tuple  # static per-level (shape, num_offsets, true_nnz)
    transfer: Transfer  # static intergrid transfer spec

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def grid_shape(self):
        return self.levels[0].grid_shape


def default_gridlevels(shape, max_dense_coarse: int, min_coarse_dim: int = 1) -> int:
    """Full-depth level count: coarsen while factor-2 coarsening is legal
    and the current level is still too big for the dense coarse solve."""
    shape = [int(s) for s in shape]
    levels = 1
    while int(np.prod(shape)) > max_dense_coarse:
        if not (
            all(s == 1 or s % 2 == 0 for s in shape)
            and any(s > 1 for s in shape)
            and all(s == 1 or s // 2 >= min_coarse_dim for s in shape)
        ):
            break
        shape = [max(1, s // 2) for s in shape]
        levels += 1
    return levels


def _interior_slice(off, shape):
    return tuple(
        slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape)
    )


def _exists_mask(off, shape):
    """Boolean grid: True where the neighbor at ``off`` stays in-domain."""
    m = np.ones(shape, dtype=bool)
    for ax, o in enumerate(off):
        idx = [slice(None)] * len(shape)
        if o > 0:
            idx[ax] = slice(0, shape[ax] - o)
        elif o < 0:
            idx[ax] = slice(-o, None)
        else:
            continue
        mm = np.zeros(shape, dtype=bool)
        mm[tuple(idx)] = True
        m &= mm
    return m


def detect_faced(offsets, coeffs):
    """Detect the boundary-corrected constant structure: the operator equals
    a constant Dirichlet-truncated stencil at every point with all
    coordinates ≥ 1, deviating only on the low faces ``i_axis == 0``.

    This is exactly the structure of Galerkin coarsenings of constant
    operators under the separable radius-1 ``linear`` transfer (each 1D
    factor matrix is Toeplitz-tridiagonal except its [0, 0] entry — see
    :class:`openmg_tpu.ops.stencil.FacedStencilOperator`).  Returns
    ``(values, face_axes, face_planes)`` with ``face_planes[j]`` the exact
    ``(K, *shape-minus-axis)`` coefficients of face ``face_axes[j]``, or
    None when the structure does not hold.

    ``coeffs`` may be the full coefficient array OR a boundary-collapsed
    representative (structured.StructuredLevel.rep): the rep is an exact
    materialization for its own dummy shape, and expansion only replicates
    interior rows, so detection on the rep proves the property for every
    real extent.
    """
    shape = coeffs.shape[1:]
    if any(s < 3 for s in shape):
        return None
    mid = tuple(s // 2 for s in shape)
    vals = np.array([coeffs[k][mid] for k in range(coeffs.shape[0])])
    interior = tuple(slice(1, None) for _ in shape)
    deviating = []
    for k, off in enumerate(offsets):
        expect = vals[k] * _exists_mask(off, shape)
        if not np.array_equal(coeffs[k][interior], expect[interior]):
            return None
        deviating.append(not np.array_equal(coeffs[k], expect))
    if not any(deviating):
        return None  # exactly constant — caller should use the plain path
    face_axes, face_planes = [], []
    for a in range(len(shape)):
        plane = np.take(coeffs, 0, axis=a + 1)
        expect = np.stack(
            [
                np.take(vals[k] * _exists_mask(off, shape), 0, axis=a)
                for k, off in enumerate(offsets)
            ]
        )
        if not np.array_equal(plane, expect):
            face_axes.append(a)
            face_planes.append(plane)
    if not face_axes:
        return None
    return vals, tuple(face_axes), face_planes


def detect_cornered(offsets, coeffs):
    """Detect the corner-collapsed structure (the sharp form of
    :func:`detect_faced` — see :class:`~openmg_tpu.ops.stencil.
    CorneredOperator`): the tap at row ``i`` for offset ``o`` depends only
    on ``{b : i_b == 0 and o_b == 0}``.  Exact over the whole array
    (verified by rebuilding it from the extracted table and comparing
    bit-for-bit).  Returns ``(values, subsets, deltas)`` in inclusion–
    exclusion form, or None.

    ``coeffs`` may be a boundary-collapsed representative (see
    :func:`detect_faced` — the argument carries over unchanged).
    """
    import itertools

    shape = coeffs.shape[1:]
    d = len(shape)
    if any(s < 3 for s in shape):
        return None
    K = coeffs.shape[0]
    mid = tuple(s // 2 for s in shape)
    base = np.array([coeffs[k][mid] for k in range(K)])

    all_subsets = []
    for size in range(1, d + 1):
        all_subsets.extend(
            tuple(c) for c in itertools.combinations(range(d), size)
        )
    # Möbius extraction: delta_S[k] = g_S[k] − base[k] − Σ_{S'⊊S} delta_S'[k]
    deltas = {}
    for S in all_subsets:
        pt = tuple(0 if b in S else mid[b] for b in range(d))
        dS = np.zeros(K, dtype=coeffs.dtype)
        for k, off in enumerate(offsets):
            if not all(off[b] == 0 for b in S):
                continue  # tap never uses this delta
            g = coeffs[k][pt]
            acc = base[k]
            for Sp in all_subsets:
                if Sp != S and set(Sp) < set(S):
                    acc += deltas[Sp][k]
            dS[k] = g - acc
        deltas[S] = dS
    subsets = tuple(S for S in all_subsets if np.any(deltas[S]))
    if not subsets:
        return None  # exactly constant — the plain constant path applies

    # exact verification: rebuild every coefficient array from the table
    for k, off in enumerate(offsets):
        tap = np.full(shape, base[k], dtype=coeffs.dtype)
        for S in subsets:
            if not all(off[b] == 0 for b in S):
                continue
            sel = np.ones(shape, dtype=bool)
            for b in S:
                idx = [slice(None)] * d
                idx[b] = slice(1, None)
                m = np.ones(shape, dtype=bool)
                m[tuple(idx)] = False
                sel &= m
            tap = tap + deltas[S][k] * sel
        expect = tap * _exists_mask(off, shape)
        if not np.array_equal(coeffs[k], expect):
            return None
    return base, subsets, tuple(deltas[S] for S in subsets)


def detect_constant(offsets, coeffs):
    """Return the ``(K,)`` value vector if the (numpy) operator is exactly
    constant-coefficient with zero Dirichlet truncation, else None."""
    shape = coeffs.shape[1:]
    vals = []
    for k, off in enumerate(offsets):
        sl = _interior_slice(off, shape)
        interior = coeffs[k][sl]
        if interior.size == 0:
            vals.append(coeffs.dtype.type(0))
            continue
        v = interior.flat[0]
        if not (interior == v).all():
            return None
        vals.append(v)
        # the out-of-domain slabs must be exactly zero: every nonzero of
        # the full array must lie in the interior region
        if np.count_nonzero(coeffs[k]) != np.count_nonzero(interior):
            return None
    return np.asarray(vals, dtype=coeffs.dtype)


def _level_from_np(offs, cfs_np, dtype):
    """Build a Level (constant fast path when detected) from numpy coeffs."""
    offs = tuple(offs)
    di = diag_index(offs)
    diag = cfs_np[di]
    if np.any(diag == 0):
        raise ValueError("operator has zero diagonal entries")
    vals = detect_constant(offs, cfs_np)
    shape = tuple(int(s) for s in cfs_np.shape[1:])
    if vals is not None:
        op = StencilOperator(
            None, offs, jnp.asarray(vals, dtype=dtype), shape
        )
        inv_diag = jnp.asarray(1.0 / vals[di], dtype=dtype)
    else:
        op = StencilOperator(jnp.asarray(cfs_np, dtype=dtype), offs)
        inv_diag = jnp.asarray(1.0 / diag, dtype=dtype)
    return Level(A=op, inv_diag=inv_diag)


def build_hierarchy(
    offsets,
    coeffs,
    gridlevels=None,
    dtype=jnp.float32,
    residual_dtype=None,
    transfer: Transfer = AGGREGATE,
    max_dense_coarse: int = 512,
    min_coarse_dim: int = 1,
    setup_dtype="float32",
) -> Hierarchy:
    """Host-path hierarchy build from a fine-level stencil (numpy coeffs).

    Levels are cast to ``dtype`` for the cycle; the fine operator is
    additionally kept at ``residual_dtype`` precision for the outer
    defect-correction residual (SURVEY.md §7 mixed-precision plan) —
    ``"doublefloat"`` stores an exact two-f32 split of the *original*
    (full-precision) input instead of one array.
    """
    orig_coeffs = np.asarray(coeffs)
    shape = tuple(int(s) for s in orig_coeffs.shape[1:])
    if gridlevels is None:
        gridlevels = default_gridlevels(shape, max_dense_coarse, min_coarse_dim)
    coeffs = np.asarray(orig_coeffs, dtype=np.dtype(setup_dtype))

    chain = [(tuple(offsets), coeffs)]
    for _ in range(int(gridlevels) - 1):
        offs, cfs = chain[-1]
        c_offs, c_cfs = galerkin_rap_stencil(offs, cfs, transfer=transfer)
        chain.append((tuple(c_offs), c_cfs))

    coarse_inv = _coarse_inverse(
        chain[-1], max_dense_coarse, single_level=len(chain) == 1
    )

    levels, stats = [], []
    for offs, cfs in chain:
        levels.append(_level_from_np(offs, cfs, dtype))
        stats.append(
            (
                tuple(int(s) for s in cfs.shape[1:]),
                len(offs),
                int(np.count_nonzero(cfs)),
            )
        )

    fine_offs = tuple(chain[0][0])
    rdtype = residual_dtype or dtype
    fine_hi_lo = None
    if rdtype == "doublefloat":
        if orig_coeffs.dtype == np.float32:
            hi, lo = orig_coeffs, np.zeros_like(orig_coeffs)
        else:
            o64 = orig_coeffs.astype(np.float64, copy=False)
            hi = o64.astype(np.float32)
            lo = (o64 - hi).astype(np.float32)
        fine_hi = _residual_op_from_np(fine_offs, hi)
        fine_hi_lo = _residual_op_from_np(fine_offs, lo)
    else:
        fine_hi = StencilOperator(
            jnp.asarray(orig_coeffs.astype(np.float64, copy=False), dtype=rdtype),
            fine_offs,
        )
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=jnp.asarray(coarse_inv, dtype=dtype),
        fine_hi=fine_hi,
        fine_hi_lo=fine_hi_lo,
        stats=tuple(stats),
        transfer=transfer,
    )


def _residual_op_from_np(offs, cfs_np):
    """Residual-path operator: constant representation when possible (the
    zero lo part of an exactly-representable operator costs no memory)."""
    vals = detect_constant(offs, cfs_np)
    shape = tuple(int(s) for s in cfs_np.shape[1:])
    if vals is not None:
        return StencilOperator(None, offs, jnp.asarray(vals), shape)
    return StencilOperator(jnp.asarray(cfs_np), offs)


_UNCOARSENABLE_DENSE_CAP = 4096  # hard guard for the single-level escape


def _coarse_inverse(coarsest, max_dense_coarse, single_level: bool = False):
    c_offs, c_cfs = coarsest
    nc = int(np.prod(c_cfs.shape[1:]))
    if nc > max_dense_coarse:
        # a problem that cannot coarsen AT ALL (odd extents, tiny grids)
        # degrades to the reference's plain dense solve rather than
        # erroring — but only up to a hard cap, so an accidental 256³
        # "1-level" request can never densify a gigarow matrix
        if single_level and nc <= _UNCOARSENABLE_DENSE_CAP:
            import warnings

            warnings.warn(
                f"grid cannot be coarsened; solving its {nc} unknowns "
                f"directly (above max_dense_coarse={max_dense_coarse})",
                stacklevel=3,
            )
        else:
            raise ValueError(
                f"coarsest level has {nc} unknowns > max_dense_coarse="
                f"{max_dense_coarse}; increase gridlevels (or "
                "max_dense_coarse)"
            )
    Ac = stencil_to_csr(
        c_offs, np.asarray(c_cfs, dtype=np.float64)
    ).toarray()
    return np.linalg.inv(Ac)


# ---------------------------------------------------------------------------
# structured setup (boundary-collapsed; the default for constant fine ops)
# ---------------------------------------------------------------------------


def build_hierarchy_structured(
    offsets,
    fine_values,
    shape,
    gridlevels=None,
    dtype=jnp.float32,
    residual_dtype="doublefloat",
    transfer: Transfer = AGGREGATE,
    max_dense_coarse: int = 512,
    min_coarse_dim: int = 1,
    faced: bool = True,
) -> Hierarchy:
    """Hierarchy from a constant fine stencil via the boundary-collapsed
    chain (:mod:`openmg_tpu.core.structured`): the exact Galerkin hierarchy
    computed on 24-wide dummy grids in milliseconds, with varying levels
    materialized on device by one small slice/broadcast/concat program.

    This is the default setup for Poisson problems on every backend — it
    is exact (tests pin bit-equality with the direct RAP chain) and
    avoids a host numpy RAP over full-size grids.

    ``faced=True`` stores levels that are constant away from their low
    faces (linear-transfer Galerkin coarsenings) as
    :class:`~openmg_tpu.ops.stencil.FacedStencilOperator` — the exact same
    operator, but smoothed at constant-stencil speed with O(n²) face
    fix-ups instead of streaming 3^d coefficient grids.  The distributed
    builder uses it too: cornered levels ship as O(K) replicated tables
    (parallel/fast.py).
    """
    from openmg_tpu.core.structured import expand_rep, expand_rep_np, structured_chain
    from openmg_tpu.ops.stencil import CorneredOperator, FacedStencilOperator

    shape = tuple(int(s) for s in shape)
    offsets = tuple(tuple(o) for o in offsets)
    if gridlevels is None:
        gridlevels = default_gridlevels(shape, max_dense_coarse, min_coarse_dim)
    slevels = structured_chain(
        offsets, fine_values, shape, int(gridlevels), transfer
    )

    # classify levels; expand all varying levels in ONE jitted program
    reps = []
    plans = []
    for lvl in slevels:
        vals = detect_constant(lvl.offsets, lvl.rep)
        if vals is not None:
            plans.append(("const", lvl, vals))
            continue
        cd = detect_cornered(lvl.offsets, lvl.rep) if faced else None
        if cd is not None:
            plans.append(("cornered", lvl, cd))
            continue
        fd = detect_faced(lvl.offsets, lvl.rep) if faced else None
        if fd is not None:
            plans.append(("faced", lvl, fd))
            continue
        plans.append(("varying", lvl, None))
        reps.append(jnp.asarray(lvl.rep.astype(np.dtype(dtype))))

    if reps:
        varying = [lvl for kind, lvl, _ in plans if kind == "varying"]

        def expand_all(tables):
            out = []
            for t, lv in zip(tables, varying):
                coeffs = expand_rep(t, lv.m_shape, lv.real_shape)
                di = diag_index(lv.offsets)
                out.append((coeffs, 1.0 / coeffs[di]))
            return out

        expanded = jax.jit(expand_all)(reps)
    else:
        expanded = []

    levels, stats = [], []
    vi = 0
    for kind, lvl, payload in plans:
        di = diag_index(lvl.offsets)
        if kind == "const":
            vals = payload
            op = StencilOperator(
                None,
                lvl.offsets,
                jnp.asarray(vals.astype(np.dtype(dtype))),
                lvl.real_shape,
            )
            levels.append(
                Level(
                    A=op,
                    inv_diag=jnp.asarray(1.0 / vals[di], dtype=dtype),
                )
            )
        elif kind == "cornered":
            vals, subsets, devs = payload
            op = CorneredOperator(
                values=jnp.asarray(vals.astype(np.dtype(dtype))),
                deltas=jnp.asarray(
                    np.stack(devs).astype(np.dtype(dtype))
                ),
                offsets=lvl.offsets,
                shape=lvl.real_shape,
                subsets=subsets,
            )
            levels.append(
                Level(
                    A=op,
                    inv_diag=jnp.asarray(1.0 / vals[di], dtype=dtype),
                )
            )
        elif kind == "faced":
            vals, face_axes, face_planes = payload
            # expand each (collapsed) face plane over its remaining axes
            planes = []
            for a, plane in zip(face_axes, face_planes):
                m_rest = tuple(
                    m for i, m in enumerate(lvl.m_shape) if i != a
                )
                n_rest = tuple(
                    n for i, n in enumerate(lvl.real_shape) if i != a
                )
                for ax, (m, n) in enumerate(zip(m_rest, n_rest)):
                    if m < n:
                        plane = expand_rep_np(plane, ax, n)
                planes.append(
                    jnp.asarray(plane.astype(np.dtype(dtype)))
                )
            op = FacedStencilOperator(
                values=jnp.asarray(vals.astype(np.dtype(dtype))),
                face_coeffs=tuple(planes),
                offsets=lvl.offsets,
                shape=lvl.real_shape,
                face_axes=face_axes,
            )
            levels.append(
                Level(
                    A=op,
                    inv_diag=jnp.asarray(1.0 / vals[di], dtype=dtype),
                )
            )
        else:
            coeffs, inv_diag = expanded[vi]
            vi += 1
            levels.append(
                Level(A=StencilOperator(coeffs, lvl.offsets), inv_diag=inv_diag)
            )
        stats.append((lvl.real_shape, len(lvl.offsets), lvl.nnz()))

    # coarsest dense inverse from the (tiny) exact materialization
    last = slevels[-1]
    c_full = last.rep
    for a in range(len(last.real_shape)):
        if last.m_shape[a] < last.real_shape[a]:
            c_full = expand_rep_np(c_full, a, last.real_shape[a])
    coarse_inv = _coarse_inverse(
        (last.offsets, c_full), max_dense_coarse,
        single_level=len(slevels) == 1,
    )

    fine_op = levels[0].A
    if residual_dtype == "doublefloat":
        if not fine_op.is_constant:
            raise ValueError("structured setup requires a constant fine operator")
        fine_hi = fine_op
        # a host-side zeros put, NOT jnp.zeros_like: an eager zeros_like
        # is one more compiled device program
        fine_hi_lo = StencilOperator(
            None,
            fine_op.offsets,
            jnp.asarray(
                np.zeros(len(fine_op.offsets), dtype=np.dtype(dtype))
            ),
            fine_op.grid_shape,
        )
    else:
        rd = jnp.dtype(residual_dtype)
        fine_hi = fine_op.astype(rd)
        fine_hi_lo = None
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=jnp.asarray(coarse_inv, dtype=dtype),
        fine_hi=fine_hi,
        fine_hi_lo=fine_hi_lo,
        stats=tuple(stats),
        transfer=transfer,
    )


# ---------------------------------------------------------------------------
# setup-on-device (one jitted program)
# ---------------------------------------------------------------------------


def _materialize_constant(values, offsets, shape, dtype):
    """Traced: expand a constant stencil to full coeff arrays (zero-BC).

    Built as value × iota-mask products — scatter-free (XLA handles
    ``.at[].set`` scatters pathologically on CPU at these sizes)."""
    ks = []
    for k, off in enumerate(offsets):
        mask = None
        for axis, o in enumerate(off):
            if o == 0:
                continue
            n = shape[axis]
            i = jax.lax.broadcasted_iota(jnp.int32, shape, axis)
            cond = i < n - o if o > 0 else i >= -o
            mask = cond if mask is None else mask & cond
        if mask is None:
            ks.append(jnp.full(shape, values[k], dtype=dtype))
        else:
            ks.append(values[k].astype(dtype) * mask.astype(dtype))
    return jnp.stack(ks)


def build_hierarchy_device(
    offsets,
    coeffs=None,
    *,
    fine_values=None,
    shape=None,
    gridlevels=None,
    dtype=jnp.float32,
    residual_dtype="doublefloat",
    transfer: Transfer = AGGREGATE,
    max_dense_coarse: int = 512,
    min_coarse_dim: int = 1,
) -> Hierarchy:
    """Jitted hierarchy construction.

    Pass either ``coeffs`` (a device ``(K, *shape)`` array) or
    ``fine_values`` + ``shape`` (a constant fine stencil, e.g. Poisson —
    the fine coefficient grid is then materialized only transiently inside
    the setup program and never stored or transferred).

    Everything — RAP chain, inverse diagonals, nnz counts, per-offset
    constancy statistics — is computed by ONE jitted program.  This is
    set-up placement, not a fallback: the program runs once on the local
    XLA:CPU backend, which compiles it in seconds, and only the
    coarse-level results (≤ 1/8 of fine size each; the constant fine level
    needs no array at all) are transferred to the default device, where
    the solve runs.
    """
    offsets = tuple(tuple(o) for o in offsets)
    if fine_values is not None:
        if shape is None:
            raise ValueError("shape is required with fine_values")
        shape = tuple(int(s) for s in shape)
    else:
        shape = tuple(int(s) for s in coeffs.shape[1:])
    if gridlevels is None:
        gridlevels = default_gridlevels(shape, max_dense_coarse, min_coarse_dim)
    gridlevels = int(gridlevels)

    # static prep: per-level shapes and (unpruned) offset lists
    shapes = [shape]
    offs_chain = [offsets]
    for _ in range(gridlevels - 1):
        offs_chain.append(
            rap_output_offsets(offs_chain[-1], shapes[-1], transfer)
        )
        shapes.append(coarse_shape(shapes[-1]))

    def setup_program(c0):
        # c0 is the (K,) fine value vector or the (K, *shape) coeff array —
        # ALWAYS a runtime argument: with a constant-only input XLA would
        # constant-fold the entire RAP chain at compile time (observed:
        # minutes, single-threaded)
        if fine_values is not None:
            cur = _materialize_constant(c0.astype(dtype), offsets, shape, dtype)
        else:
            cur = c0.astype(dtype)
        cur_offs = offsets
        outs = []
        for lvl in range(gridlevels):
            if lvl > 0:
                new_offs, cur = galerkin_rap_stencil(
                    cur_offs, cur, transfer=transfer, prune=False
                )
                assert tuple(new_offs) == tuple(offs_chain[lvl])
                cur_offs = tuple(new_offs)
            di = diag_index(cur_offs)
            inv_diag = 1.0 / cur[di]
            nnz = jnp.sum(cur != 0)
            mins = jnp.stack(
                [
                    (
                        cur[k][_interior_slice(off, shapes[lvl])].min()
                        if all(
                            s - abs(o) > 0 for o, s in zip(off, shapes[lvl])
                        )
                        else jnp.zeros((), dtype)
                    )
                    for k, off in enumerate(cur_offs)
                ]
            )
            maxs = jnp.stack(
                [
                    (
                        cur[k][_interior_slice(off, shapes[lvl])].max()
                        if all(
                            s - abs(o) > 0 for o, s in zip(off, shapes[lvl])
                        )
                        else jnp.zeros((), dtype)
                    )
                    for k, off in enumerate(cur_offs)
                ]
            )
            outs.append((cur, inv_diag, nnz, mins, maxs))
        return outs

    try:
        cpu_dev = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        cpu_dev = None
    target_dev = jax.devices()[0]
    run_ctx = (
        jax.default_device(cpu_dev)
        if cpu_dev is not None and target_dev.platform != "cpu"
        else _nullcontext()
    )
    with run_ctx:
        if fine_values is not None:
            c0 = jnp.asarray([float(v) for v in fine_values], dtype=dtype)
        else:
            c0 = coeffs
        if cpu_dev is not None and target_dev.platform != "cpu":
            c0 = jax.device_put(c0, cpu_dev)
        outs = jax.jit(setup_program)(c0)

    def to_target(arr):
        return jax.device_put(arr, target_dev)

    levels, stats = [], []
    for lvl, (cur, inv_diag, nnz, mins, maxs) in enumerate(outs):
        offs = offs_chain[lvl]
        mins_h = np.asarray(mins)
        maxs_h = np.asarray(maxs)
        const = bool(np.all(mins_h == maxs_h))
        # prune identically-zero offsets (detected via interior min==max==0
        # plus a zero diagonal of impossibility — boundary slabs are zeroed
        # by the RAP invariant, so interior stats suffice for constants;
        # for varying levels fall back to a device reduction)
        if const:
            keep = [
                i
                for i in range(len(offs))
                if not (mins_h[i] == 0 and maxs_h[i] == 0)
            ] or [0]
            vals = mins_h[keep]
            offs_k = tuple(offs[i] for i in keep)
            di = diag_index(offs_k)
            op = StencilOperator(
                None,
                offs_k,
                to_target(jnp.asarray(vals, dtype=dtype)),
                shapes[lvl],
            )
            level = Level(
                A=op,
                inv_diag=to_target(jnp.asarray(1.0 / vals[di], dtype=dtype)),
            )
            nnz_val = int(nnz)
        else:
            nz = np.asarray(jnp.any(cur != 0, axis=tuple(range(1, cur.ndim))))
            keep = [i for i in range(len(offs)) if nz[i]] or [0]
            offs_k = tuple(offs[i] for i in keep)
            cur_k = np.asarray(cur)[np.asarray(keep)] if len(keep) < len(
                offs
            ) else cur
            op = StencilOperator(to_target(jnp.asarray(cur_k)), offs_k)
            level = Level(A=op, inv_diag=to_target(inv_diag))
            nnz_val = int(nnz)
        levels.append(level)
        stats.append((shapes[lvl], len(level.A.offsets), nnz_val))

    coarse_op = levels[-1].A
    if coarse_op.is_constant:
        c_cfs = np.zeros(
            (len(coarse_op.offsets),) + tuple(shapes[-1]), dtype=np.float64
        )
        vals = np.asarray(coarse_op.values, dtype=np.float64)
        for k, off in enumerate(coarse_op.offsets):
            sl = _interior_slice(off, shapes[-1])
            c_cfs[(k,) + sl] = vals[k]
        coarse_pair = (coarse_op.offsets, c_cfs)
    else:
        coarse_pair = (coarse_op.offsets, np.asarray(coarse_op.coeffs))
    coarse_inv = _coarse_inverse(
        coarse_pair, max_dense_coarse,
        single_level=len(levels) == 1,
    )

    fine_op = levels[0].A.astype(dtype)
    if residual_dtype == "doublefloat":
        fine_hi = fine_op
        if fine_op.is_constant:
            fine_hi_lo = StencilOperator(
                None,
                fine_op.offsets,
                jnp.zeros_like(fine_op.values),
                fine_op.grid_shape,
            )
        else:
            fine_hi_lo = StencilOperator(
                jnp.zeros_like(fine_op.coeffs), fine_op.offsets
            )
    else:
        rd = jnp.dtype(residual_dtype)
        fine_hi = fine_op.astype(rd)
        fine_hi_lo = None
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=jnp.asarray(coarse_inv, dtype=dtype),
        fine_hi=fine_hi,
        fine_hi_lo=fine_hi_lo,
        stats=tuple(stats),
        transfer=transfer,
    )
