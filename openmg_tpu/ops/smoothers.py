"""Stationary smoothers on stencil operators (components R4, T3, T4).

The reference pre-smooths with lexicographic Gauss–Seidel
(``iterative_solve``, SURVEY.md R4) — inherently sequential over rows.  The
build uses the two order-free variants named by BASELINE:

* weighted Jacobi  ``x ← x + ω D⁻¹ (b − A x)``  (T3), and
* red–black Gauss–Seidel — update the red parity class from black, then
  black from red (T4).  For bipartite stencils (the 2d+1-point Poisson
  operators and all aggregation-Galerkin coarsenings of them, which stay
  (2d+1)-point) this is exactly Gauss–Seidel in the red-black ordering.

XLA fuses each sweep into one loop nest that reads ``x`` and ``b`` once
from device memory.  The red/black parity mask is generated inline from
broadcasted iota (XLA fuses it — index parity costs no memory traffic,
where a stored bool mask would stream 1 byte/point per half-sweep).

Iteration counts are static (Python ints), so sweeps unroll at trace time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openmg_tpu.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    StencilOperator,
    apply,
    diag_index,
    face_apply,
    region_table,
    residual,
    set_plane,
    shift,
)

__all__ = [
    "jacobi",
    "rbgs",
    "chebyshev",
    "gershgorin_lambda_max",
    "red_mask",
    "parity_mask_expr",
    "smooth",
]


def parity_mask_expr(shape):
    """Traced red-parity mask (True where coordinate-sum parity is even);
    generated from iota inside the surrounding jit — no memory traffic."""
    shape = tuple(int(s) for s in shape)
    acc = None
    for a in range(len(shape)):
        par = jax.lax.broadcasted_iota(jnp.int32, shape, a) & 1
        acc = par if acc is None else acc ^ par
    return acc == 0


def red_mask(shape) -> "jnp.ndarray":
    """Materialized red/black parity mask (kept for tests/inspection; the
    smoothers use :func:`parity_mask_expr` inline).

    Parity of a sum is the xor of parities — computed by broadcasting uint8
    aranges (np.indices would materialize d full int64 grids; at 256³ that
    is 400 MB of traffic on a bandwidth-starved host).
    """
    import numpy as np

    shape = tuple(int(s) for s in shape)
    acc = None
    for a, s in enumerate(shape):
        view = [1] * len(shape)
        view[a] = -1
        par = (np.arange(s, dtype=np.uint8) & 1).reshape(view)
        acc = par if acc is None else acc ^ par
    return jnp.asarray(acc == 0)


def jacobi(
    op: StencilOperator,
    inv_diag,
    b,
    x,
    iterations: int,
    omega: float = 2.0 / 3.0,
):
    om = jnp.asarray(omega, dtype=x.dtype)
    for _ in range(iterations):
        x = x + om * inv_diag * (b - apply(op, x))
    return x


def _offdiag_apply(op: StencilOperator, x):
    """(A − D) x : stencil apply skipping the zero offset."""
    di = diag_index(op.offsets)
    y = None
    for k, off in enumerate(op.offsets):
        if k == di:
            continue
        t = op.coeff(k) * shift(x, off)
        y = t if y is None else y + t
    return y


def rbgs(
    op: StencilOperator,
    inv_diag,
    b,
    x,
    iterations: int,
):
    """Red–black Gauss–Seidel: per half-sweep, colored points are set to
    ``D⁻¹ (b − (A − D) x)`` using the other color's current values."""
    mask = parity_mask_expr(x.shape)
    for _ in range(iterations):
        for m in (mask, ~mask):
            xn = inv_diag * (b - _offdiag_apply(op, x))
            x = jnp.where(m, xn, x)
    return x


def gershgorin_lambda_max(op: StencilOperator, inv_diag):
    """Upper bound on λmax(D⁻¹A): ``max_i (1 + Σ_j≠i |a_ij| / a_ii)``.

    Scalar expression for constant stencils (zero runtime cost under jit);
    one fused reduction for varying ones.  Exactly 2 for Poisson.
    """
    di = diag_index(op.offsets)
    if isinstance(op, CorneredOperator):
        tbl = region_table(op)
        offsum_int = sum(
            jnp.abs(op.values[k]) for k in range(op.num_offsets) if k != di
        )
        lam = 1.0 + offsum_int / jnp.abs(op.values[di])
        for r, R in enumerate(op.regions):
            offsum = sum(
                jnp.abs(tbl[r, k])
                for k, off in enumerate(op.offsets)
                # taps reaching i_b = −1 for b ∈ R are out of domain on
                # every row of the region — excluding them tightens the
                # bound (remaining boundary truncation still only
                # over-counts, so the bound stays valid)
                if k != di and not any(off[b] < 0 for b in R)
            )
            lam = jnp.maximum(lam, 1.0 + offsum / jnp.abs(tbl[r, di]))
        return lam
    if isinstance(op, FacedStencilOperator):
        offsum_int = sum(
            jnp.abs(op.values[k]) for k in range(op.num_offsets) if k != di
        )
        lam = 1.0 + offsum_int / jnp.abs(op.values[di])
        for fi in range(len(op.face_axes)):
            fc = op.face_coeffs[fi]
            offsum = None
            for k in range(op.num_offsets):
                if k == di:
                    continue
                t = jnp.abs(fc[k])
                offsum = t if offsum is None else offsum + t
            lam = jnp.maximum(lam, 1.0 + jnp.max(offsum / jnp.abs(fc[di])))
        return lam
    if op.is_constant:
        offsum = sum(
            jnp.abs(op.values[k])
            for k in range(op.num_offsets)
            if k != di
        )
        return 1.0 + offsum * jnp.abs(inv_diag)
    offsum = None
    for k in range(op.num_offsets):
        if k == di:
            continue
        t = jnp.abs(op.coeffs[k])
        offsum = t if offsum is None else offsum + t
    return 1.0 + jnp.max(offsum * jnp.abs(inv_diag))


def chebyshev(
    op: StencilOperator,
    inv_diag,
    b,
    x,
    iterations: int,
    lam_max=None,
):
    """Fourth-kind Chebyshev polynomial smoother (PAPERS.md: "Optimal
    Polynomial Smoothers for Parallel AMG"; Lottes' 4th-kind scheme).

    K iterations of ``x ← x + d_k`` with the d-recurrence

        d_1 = 4/(3 λmax) · D⁻¹ r₀
        d_{k+1} = (2k−1)/(2k+3) · d_k + (8k+4)/((2k+3) λmax) · D⁻¹ r_k

    damps the whole upper half of the spectrum optimally in the 4th-kind
    Chebyshev sense; K=1 with λmax=2 is exactly ω=2/3 weighted Jacobi
    (pinned by tests).  Order-free (pure Jacobi building blocks), so it
    distributes exactly like Jacobi.  Each iteration costs one A-apply —
    ``residual`` computes both the initial residual and the
    ``r ← r − A d`` updates.
    """
    if lam_max is None:
        lam_max = gershgorin_lambda_max(op, inv_diag)
    lam_max = jnp.asarray(lam_max, dtype=x.dtype)
    r = residual(op, b, x)
    d = (4.0 / 3.0) / lam_max * inv_diag * r
    for k in range(1, iterations + 1):
        x = x + d
        if k == iterations:
            break
        r = residual(op, r, d)  # r ← r − A d
        d = ((2 * k - 1) / (2 * k + 3)) * d + (
            (8 * k + 4) / (2 * k + 3)
        ) / lam_max * inv_diag * r
    return x


def cornered_inv_diag_full(op: CorneredOperator, dtype=None):
    """Full-grid exact 1/diag for a cornered operator (diagnostic use;
    the smoothers keep the broadcastable tap form)."""
    dtype = dtype or op.dtype
    inv = 1.0 / op.tap_stencil().coeff(diag_index(op.offsets))
    return jnp.broadcast_to(inv, op.grid_shape).astype(dtype)


def _smooth_cornered(name, op, b, x, iterations, omega):
    """Smoothing on a cornered operator: the plain sweeps on its exact
    taps (:func:`openmg_tpu.ops.stencil.cornered_taps`), so each
    half-sweep is one fused loop nest with no boundary passes."""
    taps = op.tap_stencil()
    inv_d = 1.0 / taps.coeff(diag_index(op.offsets))
    if name == "chebyshev":
        return chebyshev(op, inv_d, b, x, iterations)
    if name == "jacobi":
        return jacobi(taps, inv_d, b, x, iterations, omega)
    if name == "rbgs":
        return rbgs(taps, inv_d, b, x, iterations)
    raise ValueError(f"unknown smoother {name!r}")


def _faced_fix_half_sweep(op, b, x_old, x_new, mode, omega, color):
    """Overwrite the low-face rows of ``x_new`` with the exact half-sweep
    update computed from ``x_old`` (the pre-sweep iterate — every point of a
    half-sweep reads old values, so all faces are fixed from the same
    state; overlapping edge/corner rows get identical values)."""
    import jax.lax as lax

    planes = []
    for fi, a in enumerate(op.face_axes):
        invd = op.face_inv_diag(fi)
        b_f = lax.index_in_dim(b, 0, axis=a, keepdims=False)
        x_f = lax.index_in_dim(x_old, 0, axis=a, keepdims=False)
        if mode == "jacobi":
            om = jnp.asarray(omega, dtype=x_f.dtype)
            xf = x_f + om * invd * (b_f - face_apply(op, fi, x_old))
        else:  # red-black half-sweep, this color only
            xn = invd * (b_f - face_apply(op, fi, x_old, exclude_diag=True))
            red = parity_mask_expr(x_f.shape)
            m = red if color == 0 else ~red
            xf = jnp.where(m, xn, x_f)
        planes.append((a, xf))
    for a, xf in planes:
        x_new = set_plane(x_new, a, 0, xf)
    return x_new


def _smooth_faced(name, op, b, x, iterations, omega):
    """Smoothing on a faced operator: constant-stencil half-sweeps on the
    full grid + exact face fix-ups after every half-sweep."""
    const = op.const_op
    di = diag_index(op.offsets)
    inv_d = 1.0 / op.values[di]
    if name == "chebyshev":
        # Chebyshev is residual-based: residual() dispatches exactly on the
        # faced operator; the preconditioner diag uses the exact faces.
        invd_full = jnp.full(op.grid_shape, inv_d, dtype=x.dtype)
        for fi, a in enumerate(op.face_axes):
            invd_full = set_plane(
                invd_full, a, 0, op.face_inv_diag(fi).astype(x.dtype)
            )
        return chebyshev(op, invd_full, b, x, iterations)
    for _ in range(iterations):
        if name == "jacobi":
            xn = jacobi(const, inv_d, b, x, 1, omega)
            x = _faced_fix_half_sweep(op, b, x, xn, "jacobi", omega, 0)
        elif name == "rbgs":
            red = parity_mask_expr(x.shape)
            for color in (0, 1):
                upd = inv_d * (b - _offdiag_apply(const, x))
                m = red if color == 0 else ~red
                xn = jnp.where(m, upd, x)
                x = _faced_fix_half_sweep(op, b, x, xn, "rb", omega, color)
        else:
            raise ValueError(f"unknown smoother {name!r}")
    return x


def smooth(
    name: str,
    op: StencilOperator,
    inv_diag,
    b,
    x,
    iterations: int,
    omega: float,
):
    if iterations <= 0:
        return x
    if isinstance(op, CorneredOperator):
        return _smooth_cornered(name, op, b, x, iterations, omega)
    if isinstance(op, FacedStencilOperator):
        return _smooth_faced(name, op, b, x, iterations, omega)
    if name == "jacobi":
        return jacobi(op, inv_diag, b, x, iterations, omega)
    if name == "rbgs":
        return rbgs(op, inv_diag, b, x, iterations)
    if name == "chebyshev":
        return chebyshev(op, inv_diag, b, x, iterations)
    raise ValueError(f"unknown smoother {name!r}")
