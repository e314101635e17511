"""Stencil (DIA-on-grid) operator — the gather-free sparse format.

Every matrix whose rows/columns live on a regular grid and whose couplings
use a bounded set of multi-index offsets (true of the reference's entire
hierarchy: Poisson fine operators and all Galerkin coarsenings, SURVEY.md
R1/R3) is stored as ``coeffs[k, *grid]`` per static offset ``offsets[k]``.

SpMV then becomes shift–multiply–add over dense grid arrays: no gather and
no index traffic; XLA fuses the chain into one loop nest bound by device
memory bandwidth.  General unstructured matrices use the CSR/ELL/BSR
containers in :mod:`openmg_tpu.ops.sparse` instead.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "StencilOperator",
    "FacedStencilOperator",
    "CorneredOperator",
    "shift",
    "apply",
    "residual",
    "diag_index",
    "set_plane",
    "face_apply",
    "region_table",
    "TapStencil",
]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("coeffs", "values"),
    meta_fields=("offsets", "shape"),
)
@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Sparse operator in DIA-on-grid form.

    Two storage modes:

    * **varying** (general): ``coeffs`` is ``(K, *grid_shape)`` with
      ``coeffs[k][i] = A[i, i + offsets[k]]``, zero where the neighbor
      leaves the grid; ``values is None``.
    * **constant** (fast path): ``coeffs is None`` and ``values`` is a
      ``(K,)`` vector — the operator is translation-invariant with
      Dirichlet (zero) truncation at the grid boundary, i.e.
      ``A[i, i+o_k] = values[k]`` whenever ``i + o_k`` is in the grid.
      SpMV then reads only ``x`` (coefficients cost no memory
      bandwidth).  Poisson fine operators and
      all aggregation-Galerkin coarsenings are exactly of this form;
      detection happens at hierarchy setup.

    offsets: static tuple of K integer d-tuples.
    shape: static grid shape (required in constant mode; optional
        otherwise — inferred from coeffs).
    """

    coeffs: jax.Array | None
    offsets: tuple
    values: jax.Array | None = None
    shape: tuple | None = None

    @property
    def is_constant(self) -> bool:
        return self.coeffs is None

    @property
    def grid_shape(self) -> tuple:
        if self.coeffs is not None:
            return tuple(self.coeffs.shape[1:])
        return tuple(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.coeffs.dtype if self.coeffs is not None else self.values.dtype

    def coeff(self, k: int):
        """The k-th coefficient (grid array or scalar)."""
        return self.coeffs[k] if self.coeffs is not None else self.values[k]

    def apply(self, x: jax.Array) -> jax.Array:
        return apply(self, x)

    def diag(self):
        return self.coeff(diag_index(self.offsets))

    def astype(self, dtype) -> "StencilOperator":
        if self.coeffs is not None:
            return StencilOperator(self.coeffs.astype(dtype), self.offsets)
        return StencilOperator(
            None, self.offsets, self.values.astype(dtype), self.shape
        )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("values", "face_coeffs"),
    meta_fields=("offsets", "shape", "face_axes"),
)
@dataclasses.dataclass(frozen=True)
class FacedStencilOperator:
    """Boundary-corrected constant stencil — the exact-Galerkin fast path.

    Galerkin coarsenings of constant Dirichlet-truncated operators under
    separable radius-1 transfers are **Kronecker sums of 1D tridiagonal
    factors whose only non-Toeplitz entry is [0, 0]** (verified numerically
    for the linear transfer across shapes/levels; the aggregation transfer
    yields exactly constant operators and never needs this class).  Hence
    the operator equals a translation-invariant stencil everywhere except
    on the *low* faces ``i_axis == 0``, where the exact coefficient planes
    are stored densely.

    * ``values``: (K,) interior taps — the constant stencil with Dirichlet
      zero-truncation, as in :class:`StencilOperator` constant mode.
    * ``face_axes``: static tuple of axes carrying a low-face correction.
    * ``face_coeffs``: per face axis, the exact ``(K, *shape-minus-axis)``
      coefficients of the rows on that face (including edge/corner values,
      so fixing faces in sequence is idempotent where they overlap).

    Smoothers run the constant fast path on the full grid and then overwrite
    the O(n²) face rows exactly — which is why linear-transfer hierarchies
    smooth at constant-stencil speed (the varying 3^d-coefficient-grid
    representation streamed 27 coefficient arrays per sweep).
    """

    values: jax.Array  # (K,)
    face_coeffs: tuple  # per face axis: (K, *shape_minus_axis)
    offsets: tuple
    shape: tuple
    face_axes: tuple

    # ---- duck-typed StencilOperator surface ----
    @property
    def is_constant(self) -> bool:
        return False

    @property
    def is_faced(self) -> bool:
        return True

    @property
    def grid_shape(self) -> tuple:
        return tuple(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def const_op(self) -> StencilOperator:
        """The interior constant stencil as a plain operator (trace-time)."""
        return StencilOperator(None, self.offsets, self.values, self.shape)

    def apply(self, x: jax.Array) -> jax.Array:
        return apply(self, x)

    def face_inv_diag(self, face_index: int):
        """Exact 1/diag plane for ``face_axes[face_index]``."""
        di = diag_index(self.offsets)
        return 1.0 / self.face_coeffs[face_index][di]

    def astype(self, dtype) -> "FacedStencilOperator":
        return dataclasses.replace(
            self,
            values=self.values.astype(dtype),
            face_coeffs=tuple(f.astype(dtype) for f in self.face_coeffs),
        )

    def to_varying(self) -> StencilOperator:
        """Materialize the full ``(K, *grid)`` coefficient array (used by
        consumers of plain coefficient arrays, e.g. the distributed
        sharding path; memory-heavy at large shapes — prefer builders that
        produce varying levels directly there)."""
        ks = []
        for k, off in enumerate(self.offsets):
            mask = None
            for axis, o in enumerate(off):
                if o == 0:
                    continue
                n = self.shape[axis]
                i = jax.lax.broadcasted_iota(jnp.int32, self.shape, axis)
                cond = i < n - o if o > 0 else i >= -o
                mask = cond if mask is None else mask & cond
            if mask is None:
                ks.append(jnp.full(self.shape, self.values[k], self.dtype))
            else:
                ks.append(self.values[k] * mask.astype(self.dtype))
        coeffs = jnp.stack(ks)
        for fi, a in enumerate(self.face_axes):
            coeffs = jax.lax.dynamic_update_slice_in_dim(
                coeffs,
                jnp.expand_dims(self.face_coeffs[fi], a + 1),
                0,
                a + 1,
            )
        return StencilOperator(coeffs, self.offsets)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("values", "deltas"),
    meta_fields=("offsets", "shape", "subsets"),
)
@dataclasses.dataclass(frozen=True)
class CorneredOperator:
    """Corner-collapsed boundary-corrected constant stencil — the compact
    exact-Galerkin representation.

    Sharper structure than :class:`FacedStencilOperator` (verified
    numerically across shapes/levels/transfers, and provable from the 1D
    factor form): for Galerkin coarsenings of constant Dirichlet-truncated
    operators under separable radius-1 transfers, **the tap value at row
    ``i`` for offset ``o`` depends only on the set of axes
    ``{b : i_b == 0 and o_b == 0}``** — every 1D transfer/operator factor
    is Toeplitz except its ``[0, 0]`` entry, and coarse taps are sums of
    products of 1D factor entries.

    Storage is therefore O(K) total: the interior taps ``values`` plus one
    ``(K,)`` deviation row per nonempty axis subset ``S`` (inclusion–
    exclusion form; rows stacked into one ``(n_subsets, K)`` array) —

        tap(i, k) = values[k] + Σ_{S ∈ subsets, S ⊆ Z(i) ∩ Z(o_k)} deltas[S][k]

    with ``Z(i) = {b : i_b = 0}`` and ``Z(o) = {b : o_b = 0}``.  Unlike the
    dense face planes the tables are O(K) scalars, so boundary-corrected
    levels smooth at constant-stencil cost plus thin region fix-ups.
    """

    values: jax.Array  # (K,) interior taps
    deltas: jax.Array  # (n_subsets, K) deviation rows, aligned with subsets
    offsets: tuple
    shape: tuple
    subsets: tuple  # static nonempty axis subsets (tuples), ascending |S|

    # ---- duck-typed StencilOperator surface ----
    @property
    def is_constant(self) -> bool:
        return False

    @property
    def is_cornered(self) -> bool:
        return True

    @property
    def grid_shape(self) -> tuple:
        return tuple(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def face_axes(self) -> tuple:
        """Axes carrying any boundary deviation (union of the subsets)."""
        return tuple(sorted({b for S in self.subsets for b in S}))

    @property
    def regions(self) -> tuple:
        """All nonempty subsets of ``face_axes``, ascending |S| — the fix-up
        pass order (each pass overwrites the previous passes' rows on its
        deeper intersection, so the last write is always the exact one)."""
        axes = self.face_axes
        out = []
        for size in range(1, len(axes) + 1):
            out.extend(_subsets_of_size(axes, size))
        return tuple(out)

    @property
    def const_op(self) -> StencilOperator:
        """The interior constant stencil as a plain operator (trace-time)."""
        return StencilOperator(None, self.offsets, self.values, self.shape)

    def tap_stencil(self, shape=None, axis0_first=None) -> "TapStencil":
        """The exact operator as per-offset taps broadcastable to the grid
        (see :func:`cornered_taps`)."""
        return TapStencil(
            cornered_taps(self, shape, axis0_first), self.offsets
        )

    def apply(self, x: jax.Array) -> jax.Array:
        return apply(self, x)

    def astype(self, dtype) -> "CorneredOperator":
        return dataclasses.replace(
            self,
            values=self.values.astype(dtype),
            deltas=self.deltas.astype(dtype),
        )

    def to_varying(self) -> StencilOperator:
        """Materialize the full ``(K, *grid)`` coefficient array."""
        tbl = region_table(self)
        ks = []
        for k, off in enumerate(self.offsets):
            mask = None
            for axis, o in enumerate(off):
                if o == 0:
                    continue
                n = self.shape[axis]
                i = jax.lax.broadcasted_iota(jnp.int32, self.shape, axis)
                cond = i < n - o if o > 0 else i >= -o
                mask = cond if mask is None else mask & cond
            tap = jnp.full(self.shape, self.values[k], self.dtype)
            for r, R in enumerate(self.regions):
                if not all(off[b] == 0 for b in R):
                    continue
                sel = None
                for b in R:
                    zb = jax.lax.broadcasted_iota(jnp.int32, self.shape, b) == 0
                    sel = zb if sel is None else sel & zb
                tap = jnp.where(sel, tbl[r, k], tap)
            if mask is not None:
                tap = tap * mask.astype(self.dtype)
            ks.append(tap)
        return StencilOperator(jnp.stack(ks), self.offsets)


def _subsets_of_size(axes, size):
    import itertools

    return [tuple(c) for c in itertools.combinations(axes, size)]


def region_table(op: CorneredOperator):
    """Per-(region, offset) cumulative tap table, ``(n_regions, K)``.

    ``tbl[r, k] = values[k] + Σ_{S ⊆ R_r ∩ Z(o_k)} deltas[S][k]`` — the
    exact tap a row in region ``R_r`` (coordinates zero exactly on a
    superset of ``R_r``; fix-up passes run ascending so deeper regions
    overwrite) uses for offset ``k``.  Trace-time (K,) arithmetic only.
    """
    rows = []
    for R in op.regions:
        row = op.values
        for si, S in enumerate(op.subsets):
            if not set(S) <= set(R):
                continue
            m = np.array(
                [all(off[b] == 0 for b in S) for off in op.offsets]
            )
            row = row + op.deltas[si] * jnp.asarray(m, dtype=op.values.dtype)
        rows.append(row)
    return jnp.stack(rows)


@dataclasses.dataclass(frozen=True)
class TapStencil:
    """Trace-time stencil whose taps are arrays broadcastable to the grid
    (``coeff(k)`` has size 1 on every axis the tap does not vary along).
    It takes the place of a :class:`StencilOperator` in :func:`apply` and
    the smoothers; it is never stored in a hierarchy."""

    taps: tuple
    offsets: tuple
    is_constant = False

    def coeff(self, k: int):
        return self.taps[k]


def cornered_taps(op: CorneredOperator, shape=None, axis0_first=None):
    """Per-offset taps of a cornered operator, exact at every row:
    ``values[k] + Σ_{S ⊆ Z(i) ∩ Z(o_k)} deltas[S][k]``, with the zero
    sets ``Z(i)`` generated from iota — XLA fuses them into the sweep that
    consumes the taps, so a boundary-corrected level costs one loop nest
    per sweep, like a constant one.  Subsets are added in
    :func:`region_table`'s order, so the taps equal its entries exactly.

    ``shape`` defaults to the operator's grid; ``axis0_first`` (a traced
    bool) gates axis 0's zero plane on a row-partitioned block, where only
    the first device holds global row 0.
    """
    shape = tuple(shape if shape is not None else op.shape)
    nd = len(shape)
    zero = {}
    for b in op.face_axes:
        dims = [1] * nd
        dims[b] = shape[b]
        z = lax.broadcasted_iota(jnp.int32, tuple(dims), b) == 0
        if b == 0 and axis0_first is not None:
            z = jnp.logical_and(z, axis0_first)
        zero[b] = z
    masks = []
    for S in op.subsets:
        m = zero[S[0]]
        for b in S[1:]:
            m = jnp.logical_and(m, zero[b])
        masks.append(m)
    nil = jnp.zeros((), op.values.dtype)
    taps = []
    for k, off in enumerate(op.offsets):
        c = op.values[k]
        for si, S in enumerate(op.subsets):
            if all(off[b] == 0 for b in S):
                c = c + jnp.where(masks[si], op.deltas[si, k], nil)
        taps.append(c)
    return tuple(taps)


def set_plane(arr, axis: int, index: int, plane):
    """Functional write of one plane ``arr[..., index, ...] = plane`` along
    ``axis`` (XLA aliases the dynamic-update-slice in-place under jit)."""
    return jax.lax.dynamic_update_slice_in_dim(
        arr, jnp.expand_dims(plane, axis), index, axis
    )


def _take_plane(x, axis: int, index: int):
    return jax.lax.index_in_dim(x, index, axis=axis, keepdims=False)


def face_apply(
    op: FacedStencilOperator, face_index: int, x, exclude_diag: bool = False
):
    """Exact ``(A x)`` (or ``(A − D) x``) restricted to the low face of
    ``op.face_axes[face_index]`` — reads only planes ``i_a ∈ {0, 1}``."""
    a = op.face_axes[face_index]
    fc = op.face_coeffs[face_index]
    di = diag_index(op.offsets)
    acc = None
    for k, off in enumerate(op.offsets):
        if exclude_diag and k == di:
            continue
        oa = off[a]
        if oa < 0:
            continue  # neighbor at i_a = −1 is outside the domain
        plane = _take_plane(x, a, oa)
        rest = tuple(o for i, o in enumerate(off) if i != a)
        term = fc[k] * shift(plane, rest)
        acc = term if acc is None else acc + term
    return acc


def diag_index(offsets) -> int:
    zero = (0,) * len(offsets[0])
    return offsets.index(zero)


def shift(x: jax.Array, off) -> jax.Array:
    """``z[i] = x[i + off]`` with zeros outside the domain (static offset).

    Implemented as pad+slice so XLA fuses the whole shift–multiply–add chain
    of an SpMV into one HBM-streaming loop nest.
    """
    if all(o == 0 for o in off):
        return x
    pad_cfg = [(max(0, -o), max(0, o), 0) for o in off]
    xp = lax.pad(x, jnp.zeros((), x.dtype), pad_cfg)
    starts = [max(0, o) for o in off]
    limits = [s + n for s, n in zip(starts, x.shape)]
    return lax.slice(xp, starts, limits)


def apply(op, x: jax.Array) -> jax.Array:
    """SpMV ``y = A x`` on grid-shaped ``x`` (gather-free)."""
    if isinstance(op, CorneredOperator):
        op = op.tap_stencil()
    if isinstance(op, FacedStencilOperator):
        y = apply(op.const_op, x)
        for fi, a in enumerate(op.face_axes):
            y = set_plane(y, a, 0, face_apply(op, fi, x))
        return y
    y = None
    for k, off in enumerate(op.offsets):
        t = op.coeff(k) * shift(x, off)
        y = t if y is None else y + t
    return y


def residual(op, b: jax.Array, x: jax.Array) -> jax.Array:
    """``r = b − A x`` (reference component R5).

    Faced operators run the constant path and overwrite the face rows
    exactly; everything else (cornered operators through their taps) is
    ``b − apply(A, x)``, which XLA fuses into one loop nest.
    """
    if isinstance(op, FacedStencilOperator):
        r = residual(op.const_op, b, x)
        for fi, a in enumerate(op.face_axes):
            rf = _take_plane(b, a, 0) - face_apply(op, fi, x)
            r = set_plane(r, a, 0, rf)
        return r
    return b - apply(op, x)
