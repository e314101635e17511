"""Halo exchange and halo-aware grid ops inside ``shard_map`` (T10).

Each device owns a contiguous block of grid axis 0.  Stencils and the
``linear`` transfer taps reach at most one plane across the block boundary,
so the halo is a single plane each way, exchanged with ``lax.ppermute``
ring shifts (neighbor traffic; on one host the cards are joined all to
all).  The grid boundary is
Dirichlet-truncated, matching the single-device stencil convention: edge
devices receive a zero halo (the ppermute ring wraps, so the wrapped plane
is masked off).

All functions here run *inside* ``shard_map`` on local blocks.

Overlap (the BASELINE T10 "halo exchange overlapped with interior
smoothing" clause): :func:`halo_planes` + :func:`apply_overlapped`
structure the sweeps so the bulk local-only SpMV has no data dependency
on the ppermute results — only the two boundary-plane correction terms
consume them — leaving XLA free to run the collective-permute
concurrently with interior compute.  ``apply_overlapped`` is
algebraically identical to ``apply_ext`` after ``halo_exchange`` (the
halo terms are summed last instead of in offset order; fp differences are
at roundoff).  Whether the overlap happens on the cards is not measured
yet (README "Halo story").
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "halo_exchange",
    "halo_planes",
    "halo_slabs",
    "shifted_ext",
    "apply_ext",
    "apply_overlapped",
    "restrict_axis0_ext",
    "prolong_axis0_ext",
]


def _ring_perm(n: int, step: int):
    return [(i, (i + step) % n) for i in range(n)]


def halo_exchange(x_local, axis_name: str, n_dev: int):
    """Return ``x_ext`` of shape ``(local+2, ...)``: one received plane on
    each side of the local block (zeros at the global domain edges)."""
    if n_dev == 1:
        pad = [(1, 1, 0)] + [(0, 0, 0)] * (x_local.ndim - 1)
        return lax.pad(x_local, jnp.zeros((), x_local.dtype), pad)
    idx = lax.axis_index(axis_name)
    # plane sent up (to device i+1) arrives as the lower halo of i+1
    lower = lax.ppermute(x_local[-1:], axis_name, _ring_perm(n_dev, 1))
    # plane sent down (to device i-1) arrives as the upper halo of i-1
    upper = lax.ppermute(x_local[:1], axis_name, _ring_perm(n_dev, -1))
    lower = jnp.where(idx == 0, jnp.zeros_like(lower), lower)
    upper = jnp.where(idx == n_dev - 1, jnp.zeros_like(upper), upper)
    return jnp.concatenate([lower, x_local, upper], axis=0)


def halo_planes(x_local, axis_name: str, n_dev: int):
    """Just the two received halo planes ``(lower, upper)``, each
    ``(1, *trailing)`` (zeros at the global domain edges) — the overlapped
    path keeps them separate from the local block so the bulk compute has
    no data dependency on the ppermute."""
    if n_dev == 1:
        z = jnp.zeros_like(x_local[:1])
        return z, z
    idx = lax.axis_index(axis_name)
    lower = lax.ppermute(x_local[-1:], axis_name, _ring_perm(n_dev, 1))
    upper = lax.ppermute(x_local[:1], axis_name, _ring_perm(n_dev, -1))
    lower = jnp.where(idx == 0, jnp.zeros_like(lower), lower)
    upper = jnp.where(idx == n_dev - 1, jnp.zeros_like(upper), upper)
    return lower, upper


def halo_slabs(x_local, axis_name: str, n_dev: int, lo_width: int,
               hi_width: int | None = None):
    """Multi-plane halo exchange: ``(lower, upper)`` slabs of
    ``lo_width`` / ``hi_width`` planes (zeros at the global domain
    edges); the banded sparse levels exchange ``max|d|``-row slabs.
    Requires ``local ≥ width``."""
    if hi_width is None:
        hi_width = lo_width
    if n_dev == 1:
        zlo = jnp.zeros((lo_width,) + x_local.shape[1:], x_local.dtype)
        zhi = jnp.zeros((hi_width,) + x_local.shape[1:], x_local.dtype)
        return zlo, zhi
    idx = lax.axis_index(axis_name)
    lower = lax.ppermute(
        x_local[-lo_width:], axis_name, _ring_perm(n_dev, 1)
    )
    upper = lax.ppermute(
        x_local[:hi_width], axis_name, _ring_perm(n_dev, -1)
    )
    lower = jnp.where(idx == 0, jnp.zeros_like(lower), lower)
    upper = jnp.where(idx == n_dev - 1, jnp.zeros_like(upper), upper)
    return lower, upper


def _plane_shift(plane, off):
    """Apply the trailing-axis part of ``off`` to a (1, *trailing) plane."""
    rest = (0,) + tuple(off[1:])
    if all(o == 0 for o in rest):
        return plane
    from openmg_tpu.ops.stencil import shift

    return shift(plane, rest)


def _coeff_row(op, k, row: int):
    """Coefficient slab of offset k at local row ``row``: the coefficient
    itself when it does not vary along axis 0 (a scalar, or a tap of size
    1 there), else its (1, *trailing) slice."""
    c = op.coeff(k)
    if jnp.ndim(c) == 0 or c.shape[0] == 1:
        return c
    return lax.slice_in_dim(c, row, row + 1, axis=0)


def apply_overlapped(op, x_local, lower, upper, exclude_diag: bool = False):
    """Local SpMV ``y = A_local x`` structured for collective/compute
    overlap: the full-block term uses zero halos (exact for all interior
    rows), and the two boundary rows are corrected with the received
    planes afterwards.  Only the corrections depend on the ppermute
    outputs, so XLA can schedule the permute under the bulk compute.
    ``exclude_diag`` gives ``(A − D) x`` (the diagonal never crosses the
    halo, so only the bulk term changes)."""
    local = x_local.shape[0]
    pad = [(1, 1, 0)] + [(0, 0, 0)] * (x_local.ndim - 1)
    x_ext0 = lax.pad(x_local, jnp.zeros((), x_local.dtype), pad)
    y = apply_ext(op, x_ext0, exclude_diag)  # no ppermute dependency

    corr_lo = None  # row 0 reads x[-1] = lower plane via offsets with o0 == -1
    corr_hi = None  # row local-1 reads x[local] = upper plane via o0 == +1
    for k, off in enumerate(op.offsets):
        if off[0] == -1:
            t = _coeff_row(op, k, 0) * _plane_shift(lower, off)
            corr_lo = t if corr_lo is None else corr_lo + t
        elif off[0] == 1:
            t = _coeff_row(op, k, local - 1) * _plane_shift(upper, off)
            corr_hi = t if corr_hi is None else corr_hi + t
    first = y[:1] + corr_lo if corr_lo is not None else y[:1]
    last = y[-1:] + corr_hi if corr_hi is not None else y[-1:]
    if local == 1:
        # a single local row is both boundary rows
        out = first + (corr_hi if corr_hi is not None else 0.0)
        return out
    return jnp.concatenate([first, y[1:-1], last], axis=0)


def shifted_ext(x_ext, off):
    """``z[i] = x[i + off]`` on the local block, using the axis-0 halo for
    ``off[0] ∈ {−1, 0, 1}`` and zero-fill shifts on the trailing axes."""
    o0 = off[0]
    if not -1 <= o0 <= 1:
        raise ValueError(f"axis-0 offset {o0} exceeds halo width 1")
    local = x_ext.shape[0] - 2
    sl = lax.slice_in_dim(x_ext, 1 + o0, 1 + o0 + local, axis=0)
    rest = (0,) + tuple(off[1:])
    if all(o == 0 for o in rest):
        return sl
    from openmg_tpu.ops.stencil import shift

    return shift(sl, rest)


def apply_ext(op, x_ext, exclude_diag: bool = False):
    """Local SpMV ``y = A_local x`` with halo-extended ``x`` (``op`` is a
    StencilOperator over the *local* block — varying or constant).
    ``exclude_diag`` computes ``(A − D) x`` (RB-GS half-sweeps)."""
    zero = (0,) * len(op.offsets[0])
    y = None
    for k, off in enumerate(op.offsets):
        if exclude_diag and off == zero:
            continue
        t = op.coeff(k) * shifted_ext(x_ext, off)
        y = t if y is None else y + t
    return y


def restrict_axis0_ext(v_ext, taps):
    """Axis-0 restriction on a halo-extended local block:
    ``out[I] = Σ_t w(t) · v[2I + t]`` with the halo supplying cross-shard
    taps.  Local fine extent must be even (the partition plan guarantees
    it)."""
    local = v_ext.shape[0] - 2
    m = local // 2
    out = None
    for t, w in taps:
        # v[2I + t] = v_ext[1 + 2I + t], I = 0..m-1 → strided slice
        start = 1 + t
        sl = lax.slice_in_dim(v_ext, start, start + 2 * (m - 1) + 1, stride=2, axis=0)
        term = sl * jnp.asarray(w, dtype=v_ext.dtype)
        out = term if out is None else out + term
    return out


def prolong_axis0_ext(u_ext, taps):
    """Axis-0 prolongation on a halo-extended local coarse block:
    ``out[2I + pm] = Σ_{t ≡ pm (2)} w(t) · u[I − (t − pm)/2]``."""
    local = u_ext.shape[0] - 2
    parts = []
    for pm in (0, 1):
        part = None
        for t, w in taps:
            if t % 2 != pm:
                continue
            s = (t - pm) // 2
            sl = lax.slice_in_dim(u_ext, 1 - s, 1 - s + local, axis=0)
            term = sl * jnp.asarray(w, dtype=u_ext.dtype)
            part = term if part is None else part + term
        parts.append(part)
    stacked = jnp.stack(parts, axis=1)
    new_shape = (local * 2,) + tuple(u_ext.shape[1:])
    return stacked.reshape(new_shape)
