"""Banded ELL helpers: slot-offset detection and the gather-free SpMV.

When every slot's true entries satisfy ``col == row + d_j`` for a
constant per-slot delta (true of the Poisson family, banded matrices, and
any matrix assembled slot-per-neighbor), the SpMV needs no gather: each
slot is a static shifted slice of the zero-padded ``x``, which XLA fuses
into one loop nest.  Irregular matrices use the gather path in
:func:`openmg_tpu.ops.sparse.spmv`.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["spmv_banded_jnp", "detect_slot_offsets"]


def detect_slot_offsets(data, cols):
    """Per-slot constant column delta, or None if any slot is irregular.

    Host-side (numpy), setup-time.  ``data``/``cols`` are the slot-major
    ``(k, n)`` arrays; entries with ``data == 0`` (pads and boundary
    truncations) are ignored.
    """
    import numpy as np

    data = np.asarray(data)
    cols = np.asarray(cols)
    k, n = data.shape
    rows = np.arange(n, dtype=np.int64)
    offsets = []
    for j in range(k):
        mask = data[j] != 0
        if not mask.any():
            offsets.append(0)
            continue
        deltas = cols[j][mask].astype(np.int64) - rows[mask]
        d0 = int(deltas[0])
        if not (deltas == d0).all():
            return None
        offsets.append(d0)
    return tuple(offsets)


def spmv_banded_jnp(data, slot_offsets, x):
    """Gather-free jnp SpMV of a slot-offset ELL: zero-pad + per-slot
    static shifted slices (``y[i] = Σ_j data[j,i]·xe[i+d_j+H]``).  XLA
    fuses the shifted reads; for narrow bands they coalesce into
    essentially one ``x`` stream."""
    from jax import lax

    H = max((abs(int(d)) for d in slot_offsets), default=0)
    n = x.shape[0]
    xe = jnp.pad(x, (H, H)) if H else x
    acc = None
    for j, d in enumerate(slot_offsets):
        t = data[j] * lax.slice_in_dim(xe, H + int(d), H + int(d) + n)
        acc = t if acc is None else acc + t
    return acc
