"""Gather-free SpMV for blocked-band BSR.

A **blocked-band** BSR has a constant per-slot block-column delta
(``bcols[I, s] == I + d_s``, detected at container build: vector-PDE
stencils, any block-banded matrix).  The algebra::

    y[I·B + i] = Σ_s Σ_j data[I, s, i, j] · x[(I + d_s)·B + j]

regroups per (slot s, block column j) into a flat elementwise product:
let ``z_j[r] = x[(r − r%B) + j]`` (each block's j-th element replicated
across the block).  Then the (s, j) contribution to ``y`` is
``data_sm[s, j, :] · shift(z_j, d_s·B)`` — a static flat shift, since the
replica is block-aligned.  ``data_sm`` is the slot-major ``(kb, bc, n)``
layout of :class:`openmg_tpu.ops.sparse.BSRMatrix`.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["spmv_banded_jnp"]


def _flat_shift(v, d):
    """Zero-filled flat shift ``w[r] = v[r + d]``."""
    if d == 0:
        return v
    z = jnp.zeros((abs(d),), v.dtype)
    if d > 0:
        return jnp.concatenate([v[d:], z])
    return jnp.concatenate([z, v[:d]])


def spmv_banded_jnp(M, x):
    """Gather-free SpMV on the slot-major banded layout: block-aligned
    replicas + static flat shifts, which XLA fuses."""
    B = M.blocksize[0]
    n = M.shape[0]
    nbr = n // B
    xv = x.reshape(nbr, B)
    acc = None
    for j in range(B):
        zj = jnp.broadcast_to(xv[:, j:j + 1], (nbr, B)).reshape(n)
        for s, d in enumerate(M.slot_offsets):
            t = M.data[s, j] * _flat_shift(zj, int(d) * B)
            acc = t if acc is None else acc + t
    return acc
