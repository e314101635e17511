"""Sparse format layer: CSR / ELL / BSR with padded static nnz (T1).

The stencil (DIA-on-grid) form in :mod:`openmg_tpu.ops.stencil` is the fast
path for grid-structured operators (gather-free SpMV).  This module is the
*general* sparse-interchange surface required by the BASELINE north star
("sparse format layer (CSR/BSR with padded static nnz)", SURVEY.md T1): it
covers arbitrary sparse SPD matrices — anything a user of the reference
could pass to ``mg_solve(A, b, parameters)`` (SURVEY.md R7) — at the cost
of gather traffic in the SpMV.

Design for XLA:

* every container is a frozen pytree dataclass of **statically-shaped**
  device arrays: nnz is padded at construction (pad entries carry
  ``data == 0`` at a valid coordinate, so they are provably inert in every
  kernel — SURVEY.md §7 "Hard parts"), and the padded sizes are part of the
  pytree structure, so one XLA compilation serves every cycle;
* **ELL** is the preferred general layout: ``(k, n)`` data/column
  planes make the SpMV a dense gather + row reduction — regular and
  vectorizable, and gather-free for banded matrices;
* **CSR** is the interchange format (scipy-compatible; SpMV via sorted
  ``segment_sum``);
* **BSR** stores ``(br, bc)`` dense blocks in block-ELL layout; its SpMV
  contracts block columns with ``einsum`` at ~``1/(br·bc)`` the index
  traffic of CSR (BASELINE config 4 names BSR
  operators at 256³).

Conversions are host-side (scipy) and happen once at setup.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "CSRMatrix",
    "ELLMatrix",
    "BSRMatrix",
    "DenseMatrix",
    "csr_from_scipy",
    "ell_from_scipy",
    "bsr_from_scipy",
    "dense_from_scipy",
    "from_scipy",
    "dense_matvec",
    "to_scipy",
    "spmv",
    "spmv_df",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("data", "indices", "row_ids"),
    meta_fields=("shape", "nnz"),
)
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """CSR with padded static nnz.

    ``data/indices/row_ids`` all have length ``nnz_pad`` (static); entries
    are row-major sorted, pads sit at the end with ``data == 0`` in the
    last row (keeping ``row_ids`` sorted for a fast segment reduction).
    ``indptr`` is not carried on device — the SpMV uses ``row_ids``; it is
    reconstructed on the host in :func:`to_scipy`.
    """

    data: jax.Array  # (nnz_pad,)
    indices: jax.Array  # (nnz_pad,) int32 column of each entry
    row_ids: jax.Array  # (nnz_pad,) int32 row of each entry (sorted)
    shape: tuple  # (nrows, ncols)
    nnz: int  # true (unpadded) nnz

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("data", "cols"),
    meta_fields=("shape", "nnz", "bandwidth", "slot_offsets"),
)
@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK in slot-major ("ELLPACK-T") layout: ``k`` (padded
    max-nnz-per-row) entries per row, stored as ``(k, nrows)`` planes.

    ``data[j, i]`` pairs with column ``cols[j, i]``; pad slots carry
    ``data == 0`` at column 0.  Slot-major makes each slot one contiguous
    length-``n`` stream, which the banded SpMV
    (:mod:`openmg_tpu.ops.ell`) reads as shifted slices.

    **Invariant:** when ``slot_offsets`` is not None, every true entry of
    slot ``j`` satisfies ``cols[j, i] == i + slot_offsets[j]`` (pads are
    ``data == 0`` anywhere).  The banded SpMV trusts
    ``slot_offsets`` and never reads ``cols``; the two builders
    (:func:`ell_from_scipy`, ``models.poisson.poisson_ell_device``)
    maintain the invariant, and hand-constructed / ``dataclasses.replace``'d
    instances must too — otherwise ``spmv`` silently computes a wrong
    product.  Set ``slot_offsets=None`` to force the gather path.
    """

    data: jax.Array  # (k, nrows)
    cols: jax.Array  # (k, nrows) int32
    shape: tuple
    nnz: int
    bandwidth: int = 0  # max |col − row| over true entries (static)
    # per-slot constant column delta when every slot is offset-regular
    # (``col == row + slot_offsets[j]`` wherever data != 0) — the static
    # structure the banded SpMV (ops/ell.py) keys on; None for
    # irregular matrices (jnp gather path).
    slot_offsets: tuple | None = None

    @property
    def k(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "ELLMatrix":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("data", "bcols"),
    meta_fields=("shape", "blocksize", "nnz", "slot_offsets"),
)
@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse rows in block-ELL layout.

    Two device layouts, keyed on ``slot_offsets``:

    * ``slot_offsets is None`` (general): ``data[I, J]`` is the dense
      ``(br, bc)`` block coupling block-row ``I`` to block-column
      ``bcols[I, J]``; pad slots are zero blocks at block column 0.
      SpMV gathers block columns and contracts with ``einsum``.
    * ``slot_offsets = (d_0, …)`` (**blocked-band**): every true block of
      slot ``J`` sits at ``bcols[I, J] == I + d_J`` — detected at build
      (the Poisson family, vector-PDE stencils, any block-banded matrix).
      ``data`` is then stored **slot-major** as ``(kb, bc, n)``:
      ``data[J, j, I·br + i]`` is element ``(i, j)`` of block ``(I,
      I + d_J)``.  Each (slot, block column) is one contiguous
      length-``n`` stream (like :class:`ELLMatrix`), so the SpMV is
      gather-free: for each (slot, block column j), a flat shift of the
      block-aligned ``x`` replica by ``d_J·bc``
      (:mod:`openmg_tpu.ops.bsr`).
      ``bcols`` is kept for interchange (``to_scipy``).

    ``nnz`` counts true scalar nonzeros.
    """

    data: jax.Array  # (nbrows, kb, br, bc) | banded: (kb, bc, n)
    bcols: jax.Array  # (nbrows, kb) int32
    shape: tuple
    blocksize: tuple  # (br, bc)
    nnz: int
    slot_offsets: tuple | None = None

    @property
    def kb(self) -> int:
        return int(
            self.data.shape[0] if self.slot_offsets is not None
            else self.data.shape[1]
        )

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "BSRMatrix":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("data",),
    meta_fields=("nnz",),
)
@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operator — the reference's ``dense=True`` debug mode
    (SURVEY.md R9, ``flexible_mmult``): the same cycle code runs with the
    matrix materialized densely and the SpMV executed as one matmul.
    Only sensible for small/debug problems; ``nnz`` records the true
    sparse nonzero count so metrics stay comparable across formats.
    """

    data: jax.Array  # (nrows, ncols)
    nnz: int

    @property
    def shape(self) -> tuple:
        return tuple(int(s) for s in self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DenseMatrix":
        return dataclasses.replace(self, data=self.data.astype(dtype))


# ---------------------------------------------------------------------------
# host-side conversion (setup-time, one-off)
# ---------------------------------------------------------------------------


def dense_from_scipy(A, dtype=np.float32) -> DenseMatrix:
    """scipy sparse / numpy dense → :class:`DenseMatrix`."""
    import scipy.sparse as sp

    if sp.issparse(A):
        nnz = int(sp.csr_matrix(A).nnz)
        arr = A.toarray()
    else:
        arr = np.asarray(A)
        nnz = int(np.count_nonzero(arr))
    return DenseMatrix(data=jnp.asarray(arr, dtype=dtype), nnz=nnz)


def csr_from_scipy(A, pad_nnz_to: int = 8, dtype=np.float32) -> CSRMatrix:
    """scipy sparse → :class:`CSRMatrix`, nnz padded to a multiple of
    ``pad_nnz_to`` (static-shape budget, SURVEY.md T1)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    nnz = int(A.nnz)
    nnz_pad = max(_round_up(nnz, pad_nnz_to), pad_nnz_to)
    data = np.zeros(nnz_pad, dtype=dtype)
    indices = np.zeros(nnz_pad, dtype=np.int32)
    row_ids = np.full(nnz_pad, n - 1, dtype=np.int32)  # pads at end stay sorted
    data[:nnz] = A.data
    indices[:nnz] = A.indices
    row_ids[:nnz] = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(A.indptr).astype(np.int64)
    )
    return CSRMatrix(
        data=jnp.asarray(data),
        indices=jnp.asarray(indices),
        row_ids=jnp.asarray(row_ids),
        shape=(int(n), int(m)),
        nnz=nnz,
    )


def ell_from_scipy(A, k: int | None = None, dtype=np.float32) -> ELLMatrix:
    """scipy sparse → :class:`ELLMatrix`; ``k`` defaults to the true
    max-nnz-per-row (pass a larger ``k`` to align budgets across levels).

    Diagonal-structured matrices (few distinct ``col − row`` deltas —
    the Poisson family, banded systems) are packed **slot-per-offset**
    so every slot is offset-regular and the gather-free banded SpMV
    (:mod:`openmg_tpu.ops.ell`) engages; irregular matrices use compact
    per-row packing (jnp gather path).  Both are valid ELL — pads carry
    ``data == 0`` — and every consumer treats them identically.
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    counts = np.diff(A.indptr)
    k_true = int(counts.max()) if n else 0
    rows_of = np.repeat(np.arange(n), counts)
    bw = int(np.abs(A.indices - rows_of).max()) if A.nnz else 0

    # offset-aligned packing when the diagonal count fits the budget
    if n == m and A.nnz:
        deltas = np.unique(A.indices.astype(np.int64) - rows_of)
        k_dia = len(deltas)
        k_budget = k if k is not None else max(k_true, 1)
        if k_dia <= max(k_budget, k_true):
            kk = max(k_budget, k_dia, 1)
            data = np.zeros((kk, n), dtype=dtype)
            cols = np.zeros((kk, n), dtype=np.int32)
            offsets = [0] * kk
            Ad = sp.dia_matrix(A)
            diag_of = {int(d): Ad.data[i] for i, d in enumerate(Ad.offsets)}
            for j, d in enumerate(int(dd) for dd in deltas):
                # dia_matrix stores diagonal d at data[d:] (cols indexed)
                band = diag_of[d]
                r0, r1 = max(0, -d), min(n, n - d)
                rr = np.arange(r0, r1)
                data[j, rr] = band[rr + d]
                cols[j, rr] = rr + d
                offsets[j] = d
            return ELLMatrix(
                data=jnp.asarray(data),
                cols=jnp.asarray(cols),
                shape=(int(n), int(m)),
                nnz=int(A.nnz),
                bandwidth=bw,
                slot_offsets=tuple(offsets),
            )

    k = max(k if k is not None else k_true, 1)
    if k < k_true:
        raise ValueError(f"k={k} < max nnz/row {k_true}")
    data = np.zeros((k, n), dtype=dtype)
    cols = np.zeros((k, n), dtype=np.int32)
    # slot index of each entry within its row
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    data[slot, rows_of] = A.data
    cols[slot, rows_of] = A.indices
    from openmg_tpu.ops.ell import detect_slot_offsets

    return ELLMatrix(
        data=jnp.asarray(data),
        cols=jnp.asarray(cols),
        shape=(int(n), int(m)),
        nnz=int(A.nnz),
        bandwidth=bw,
        slot_offsets=detect_slot_offsets(data, cols) if n == m else None,
    )


def bsr_from_scipy(
    A, blocksize: tuple = (4, 4), kb: int | None = None, dtype=np.float32
) -> BSRMatrix:
    """scipy sparse → :class:`BSRMatrix` (block-ELL).  Dims must divide by
    the block size; blocks are dense (explicit zeros inside a touched
    block), which is the bandwidth/regularity trade BSR makes."""
    import scipy.sparse as sp

    br, bc = int(blocksize[0]), int(blocksize[1])
    n, m = A.shape
    if n % br or m % bc:
        raise ValueError(f"shape {A.shape} not divisible by blocksize {blocksize}")
    true_nnz = int(sp.csr_matrix(A).nnz)
    B = sp.bsr_matrix(A, blocksize=(br, bc))
    B.sort_indices()
    nbr = n // br
    counts = np.diff(B.indptr)
    kb_true = int(counts.max()) if nbr else 0
    kb = max(kb if kb is not None else kb_true, 1)
    if kb < kb_true:
        raise ValueError(f"kb={kb} < max blocks/row {kb_true}")
    rows = np.repeat(np.arange(nbr), counts)

    # blocked-band packing (square blocks): slot-per-block-delta, so every
    # slot has a constant block-column delta and the gather-free SpMV
    # engages (mirrors ell_from_scipy's offset-aligned packing — compact
    # per-row packing would misalign slots at boundary rows)
    if n == m and br == bc and B.indices.size:
        deltas_all = B.indices.astype(np.int64) - rows
        uniq = np.unique(deltas_all)
        kb_dia = len(uniq)
        # delta-packing may need a few more slots than compact packing
        # (e.g. when every block row touches a boundary and misses one
        # side's neighbor); accept ≤ ~50% zero-block padding — the
        # gather-free SpMV wins far more than the extra zero stream costs
        if kb_dia <= max(kb, kb_true + max(kb_true // 2, 2)):
            kbb = max(kb, kb_dia, 1)
            slot_of = {int(d): s for s, d in enumerate(uniq)}
            s_idx = np.array([slot_of[int(d)] for d in deltas_all])
            data_sm = np.zeros((kbb, bc, nbr, br), dtype=dtype)
            # data_sm[s, j, I, i] = block[i, j]
            data_sm[s_idx, :, rows, :] = B.data.transpose(0, 2, 1)
            bcols = np.zeros((nbr, kbb), dtype=np.int32)
            bcols[rows, s_idx] = B.indices
            offs = [0] * kbb
            for s, d in enumerate(uniq):
                offs[s] = int(d)
            return BSRMatrix(
                data=jnp.asarray(
                    np.ascontiguousarray(data_sm.reshape(kbb, bc, n))
                ),
                bcols=jnp.asarray(bcols),
                shape=(int(n), int(m)),
                blocksize=(br, bc),
                nnz=true_nnz,
                slot_offsets=tuple(offs),
            )

    data = np.zeros((nbr, kb, br, bc), dtype=dtype)
    bcols = np.zeros((nbr, kb), dtype=np.int32)
    slot = np.arange(B.indices.size) - np.repeat(B.indptr[:-1], counts)
    data[rows, slot] = B.data
    bcols[rows, slot] = B.indices
    return BSRMatrix(
        data=jnp.asarray(data),
        bcols=jnp.asarray(bcols),
        shape=(int(n), int(m)),
        blocksize=(br, bc),
        nnz=true_nnz,
    )


def from_scipy(A, fmt: str = "ell", dtype=np.float32, **kw):
    """Dispatching converter: ``fmt`` in {"csr", "ell", "bsr"}."""
    if fmt == "csr":
        return csr_from_scipy(A, dtype=dtype, **kw)
    if fmt == "ell":
        return ell_from_scipy(A, dtype=dtype, **kw)
    if fmt == "bsr":
        return bsr_from_scipy(A, dtype=dtype, **kw)
    if fmt == "dense":
        return dense_from_scipy(A, dtype=dtype, **kw)
    raise ValueError(f"unknown sparse format {fmt!r}")


def to_scipy(M):
    """Round-trip any container back to scipy CSR (drops padding)."""
    import scipy.sparse as sp

    if isinstance(M, CSRMatrix):
        rows = np.asarray(M.row_ids)[: M.nnz]
        cols = np.asarray(M.indices)[: M.nnz]
        vals = np.asarray(M.data)[: M.nnz]
        return sp.coo_matrix((vals, (rows, cols)), shape=M.shape).tocsr()
    if isinstance(M, ELLMatrix):
        k, n = M.data.shape
        rows = np.tile(np.arange(n), k)
        cols = np.asarray(M.cols).ravel()
        vals = np.asarray(M.data).ravel()
        keep = vals != 0
        return sp.coo_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=M.shape
        ).tocsr()
    if isinstance(M, BSRMatrix):
        br, bc = M.blocksize
        nbr, kb = M.bcols.shape
        data = np.asarray(M.data)
        if M.slot_offsets is not None:  # slot-major → canonical blocks
            data = data.reshape(kb, bc, nbr, br).transpose(2, 0, 3, 1)
        bcols = np.asarray(M.bcols)
        indptr = np.arange(nbr + 1) * kb
        B = sp.bsr_matrix(
            (data.reshape(nbr * kb, br, bc), bcols.ravel(), indptr),
            shape=M.shape,
            blocksize=(br, bc),
        )
        out = sp.csr_matrix(B)
        out.eliminate_zeros()
        return out
    if isinstance(M, DenseMatrix):
        return sp.csr_matrix(np.asarray(M.data))
    raise TypeError(f"not a sparse container: {type(M)}")


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


def dense_matvec(A, x: jax.Array) -> jax.Array:
    """``A @ x`` at full f32 (or f64) precision.  ``HIGHEST`` stops the
    backend from rounding f32 operands to TF32, which keeps about three
    digits and would stall the coarse solve of a 1e-10 solve."""
    return jnp.matmul(A, x, precision=lax.Precision.HIGHEST)


def spmv(M, x: jax.Array) -> jax.Array:
    """``y = M x`` for any container; ``x`` flat ``(ncols,)``.

    Pad entries contribute exactly 0 (zero data at valid coordinates).
    """
    if isinstance(M, ELLMatrix):
        if M.slot_offsets is not None and x.dtype == M.dtype:
            # banded: static shifted slices, no gather
            from openmg_tpu.ops.ell import spmv_banded_jnp

            return spmv_banded_jnp(M.data, M.slot_offsets, x)
        return jnp.sum(M.data * x[M.cols], axis=0)
    if isinstance(M, CSRMatrix):
        prod = M.data * x[M.indices]
        return jax.ops.segment_sum(
            prod, M.row_ids, num_segments=M.shape[0], indices_are_sorted=True
        )
    if isinstance(M, BSRMatrix):
        br, bc = M.blocksize
        if M.slot_offsets is not None:
            from openmg_tpu.ops.bsr import spmv_banded_jnp

            return spmv_banded_jnp(M, x)
        xb = x.reshape(-1, bc)[M.bcols]  # (nbr, kb, bc)
        y = jnp.einsum(
            "rkij,rkj->ri", M.data, xb, precision=lax.Precision.HIGHEST
        )
        return y.reshape(-1)
    if isinstance(M, DenseMatrix):
        return dense_matvec(M.data, x)
    raise TypeError(f"not a sparse container: {type(M)}")


def spmv_df(M_hi, M_lo, x_hi, x_lo):
    """Double-float SpMV accumulation ``(A_hi + A_lo)(x_hi + x_lo)`` for the
    outer 1e-10 residual on the general path (ELL only — the residual
    operator is stored in ELL regardless of the cycle format).

    Returns the df pair ``(y_hi, y_lo)``.  Loops over the static k slots so
    each term goes through compensated two-f32 products/sums
    (:mod:`openmg_tpu.ops.doublefloat`).
    """
    from openmg_tpu.ops.doublefloat import df_add, df_mul

    if not isinstance(M_hi, ELLMatrix):
        raise TypeError("spmv_df requires ELL residual operators")
    if M_hi.slot_offsets is not None:
        # banded fast path: per-slot static shifted slices of the
        # zero-padded vector instead of gathers (this outer residual runs
        # every defect-correction step).  Values are identical to the
        # gather path (same slots, same order), so the compensated
        # arithmetic is bitwise unchanged.
        n = M_hi.shape[0]
        H = max((abs(int(d)) for d in M_hi.slot_offsets), default=0)
        xe_h = jnp.pad(x_hi, (H, H)) if H else x_hi
        xe_l = jnp.pad(x_lo, (H, H)) if H else x_lo
        acc = None
        for j, d in enumerate(M_hi.slot_offsets):
            xs = (
                lax.slice_in_dim(xe_h, H + int(d), H + int(d) + n),
                lax.slice_in_dim(xe_l, H + int(d), H + int(d) + n),
            )
            term = df_mul((M_hi.data[j], M_lo.data[j]), xs)
            acc = term if acc is None else df_add(acc, term)
        return acc
    acc = None
    for j in range(M_hi.k):
        c = M_hi.cols[j]
        term = df_mul(
            (M_hi.data[j], M_lo.data[j]), (x_hi[c], x_lo[c])
        )
        acc = term if acc is None else df_add(acc, term)
    return acc


def diagonal(M) -> jax.Array:
    """Main diagonal of a (square) container, computed on device."""
    n = M.shape[0]
    if isinstance(M, ELLMatrix):
        rows = jnp.arange(n, dtype=M.cols.dtype)[None, :]
        return jnp.sum(jnp.where(M.cols == rows, M.data, 0.0), axis=0)
    if isinstance(M, CSRMatrix):
        hit = jnp.where(M.indices == M.row_ids, M.data, 0.0)
        return jax.ops.segment_sum(
            hit, M.row_ids, num_segments=n, indices_are_sorted=True
        )
    if isinstance(M, BSRMatrix):
        br, bc = M.blocksize
        if M.slot_offsets is not None:
            # diag[r] = Σ_{slots with d=0} data[s, r % B, r]
            rmod = jnp.arange(n, dtype=jnp.int32) % br
            diag = jnp.zeros((n,), M.dtype)
            for s, d in enumerate(M.slot_offsets):
                if d != 0:
                    continue
                sel = jnp.take_along_axis(M.data[s], rmod[None, :], axis=0)
                diag = diag + sel[0]
            return diag
        nbr = n // br
        rows = jnp.arange(nbr, dtype=M.bcols.dtype)[:, None]
        dia_blocks = jnp.sum(
            jnp.where(
                (M.bcols == rows)[:, :, None, None], M.data, 0.0
            ),
            axis=1,
        )  # (nbr, br, bc)
        k = min(br, bc)
        idx = jnp.arange(k)
        return dia_blocks[:, idx, idx].reshape(-1)
    if isinstance(M, DenseMatrix):
        return jnp.diagonal(M.data)
    raise TypeError(f"not a sparse container: {type(M)}")
