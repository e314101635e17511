"""Constant and cornered stencil levels, row-partitioned inside
``shard_map`` (T10).

* **Halo planes feed the local sweep.**  Each partitioned half-sweep reads
  the two ``ppermute``-received (1, ny, nx) halo planes in place of the
  Dirichlet zero at the local block's axis-0 edges
  (:func:`openmg_tpu.parallel.halo.apply_overlapped`).  Only the halo
  reads depend on the collective, so XLA can overlap the permute with the
  interior part of the sweep.
* **Cornered levels distribute natively.**  A
  :class:`~openmg_tpu.ops.stencil.CorneredOperator`'s (values, deltas)
  tables are O(K) replicated scalars — no 27-coefficient varying arrays
  are ever materialized or sharded.  Its exact taps are generated on the
  local block from iota (:func:`~openmg_tpu.ops.stencil.cornered_taps`);
  the axis-0 boundary plane exists only on device 0 (global row 0) and
  is gated on ``lax.axis_index``.

Correctness is pinned by tests/test_parallel.py: partitioned solves (8
virtual CPU devices) match single-device solves to fp tolerance for
cornered linear-transfer hierarchies.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from openmg_tpu.ops.smoothers import gershgorin_lambda_max, parity_mask_expr
from openmg_tpu.ops.stencil import (
    CorneredOperator,
    StencilOperator,
    diag_index,
)
from openmg_tpu.parallel.halo import apply_overlapped, halo_planes

__all__ = [
    "is_fast_op",
    "smooth_part",
    "residual_part",
]


def is_fast_op(op) -> bool:
    """Does the partitioned fast tier handle this operator?"""
    return isinstance(op, CorneredOperator) or (
        isinstance(op, StencilOperator) and op.is_constant
    )


def _local_op(op, shape, axis_name, n_dev: int):
    """The level's operator on the local block: the constant stencil, or a
    cornered operator's exact taps with axis 0's boundary plane gated to
    the device holding global row 0."""
    if isinstance(op, CorneredOperator):
        first = lax.axis_index(axis_name) == 0 if n_dev > 1 else None
        return op.tap_stencil(shape, axis0_first=first)
    return StencilOperator(None, op.offsets, op.values, shape)


def _half_sweep(mode, op, b, x, omega, color, lower, upper):
    """One half-sweep (or residual) on the local block, halo-exact: the
    received halo planes stand in for the Dirichlet zero at the block's
    axis-0 edges."""
    inv_diag = 1.0 / op.coeff(diag_index(op.offsets))
    if mode == "jacobi":
        om = jnp.asarray(omega, dtype=x.dtype)
        ax = apply_overlapped(op, x, lower, upper)
        return x + om * inv_diag * (b - ax)
    if mode == "rb":
        off_sum = apply_overlapped(op, x, lower, upper, exclude_diag=True)
        xn = inv_diag * (b - off_sum)
        red = parity_mask_expr(x.shape)
        m = red if color == 0 else ~red
        return jnp.where(m, xn, x)
    return b - apply_overlapped(op, x, lower, upper)


def residual_part(op, b, x, axis_name, n_dev: int):
    """Halo-exact ``r = b − A x`` on the local block of a partitioned
    constant/cornered level."""
    lower, upper = halo_planes(x, axis_name, n_dev)
    local = _local_op(op, x.shape, axis_name, n_dev)
    return _half_sweep("residual", local, b, x, 0.0, 0, lower, upper)


def smooth_part(
    name: str,
    op,
    b,
    x,
    iterations: int,
    omega: float,
    axis_name,
    n_dev: int,
):
    """Partitioned-level smoothing on the fast representations (constant /
    cornered).  Per half-sweep: exchange the halo planes, sweep the local
    block on the level's exact taps — identical math to the single-device
    smoothers up to summation order."""
    if iterations <= 0:
        return x
    local = _local_op(op, x.shape, axis_name, n_dev)
    di = diag_index(op.offsets)

    if name == "chebyshev":
        lam = jnp.asarray(
            gershgorin_lambda_max(op, 1.0 / op.values[di]), dtype=x.dtype
        )
        invd = 1.0 / local.coeff(di)
        r = residual_part(op, b, x, axis_name, n_dev)
        d = (4.0 / 3.0) / lam * invd * r
        for k in range(1, iterations + 1):
            x = x + d
            if k == iterations:
                break
            r = residual_part(op, r, d, axis_name, n_dev)  # r ← r − A d
            d = ((2 * k - 1) / (2 * k + 3)) * d + (
                (8 * k + 4) / (2 * k + 3)
            ) / lam * invd * r
        return x

    if name == "jacobi":
        sweeps = (("jacobi", 0),)
    elif name == "rbgs":
        sweeps = (("rb", 0), ("rb", 1))
    else:
        raise ValueError(f"unknown smoother {name!r}")

    for _ in range(iterations):
        for mode, color in sweeps:
            lower, upper = halo_planes(x, axis_name, n_dev)
            x = _half_sweep(mode, local, b, x, omega, color, lower, upper)
    return x
