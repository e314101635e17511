"""Grid transfer operators: restriction / prolongation (components R2, T5).

The reference builds an explicit sparse aggregation matrix R with
``R[c, f] = 1/2^d`` over each coarse point's ``2^d`` fine children and uses
``P = Rᵀ`` (SURVEY.md R2).  On grid-shaped arrays those products are exact
strided-slice/interleave operations — no sparse matrix, no gather — which is
how this build executes them.

Transfers are *separable*: a per-axis tap list ``(offset t, weight w)``
defines ``R_axis[c, f] = Σ_t w·[f = 2c + t]`` and analogously for P; the
d-dimensional operator is the tensor product over coarsened axes.  Two
specs ship:

* ``AGGREGATE`` — the reference's piecewise-constant scheme (parity tests
  against the explicit-R oracle prove bit-level agreement).
* ``LINEAR`` — vertex-centered full-weighting restriction with linear
  interpolation (per-dim taps at ``t ∈ {−1, 0, 1}`` around injection point
  ``f = 2c``; R = Pᵀ/2 per dim).  Not in the reference: a convergence
  upgrade (O(h²) interpolation lifts the two-grid rate from ~0.6–0.8 to
  ~0.1), selected via ``SolverConfig(transfer="linear")``.  The {−1,0,1}
  support is what keeps Galerkin coarse stencils at ≤ 3^d points (a
  cell-centered 4-tap variant was tried and densifies to 5^d —
  tests/test_galerkin.py pins the 3^d bound).

Out-of-domain taps are zero-filled (no boundary renormalization), which is
the Dirichlet-consistent choice and keeps R = c·Pᵀ exact so Galerkin
coarse operators stay symmetric.

Dims of size 1 are never coarsened.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

__all__ = [
    "Transfer",
    "AGGREGATE",
    "LINEAR",
    "TRANSFERS",
    "coarse_shape",
    "restrict",
    "prolong",
]

@dataclasses.dataclass(frozen=True)
class Transfer:
    """Separable transfer spec: per-axis restriction/prolongation taps.

    Each tap list is a tuple of ``(t, w)``: ``R[c, f] = Σ w·[f = 2c + t]``
    per coarsened axis (tensor product across axes); similarly
    ``P[f, c] = Σ w·[f = 2c + t]`` using ``p_taps``.
    """

    name: str
    r_taps: tuple
    p_taps: tuple


AGGREGATE = Transfer(
    name="aggregate",
    r_taps=((0, 0.5), (1, 0.5)),
    p_taps=((0, 0.5), (1, 0.5)),
)

LINEAR = Transfer(
    name="linear",
    r_taps=((-1, 0.25), (0, 0.5), (1, 0.25)),
    p_taps=((-1, 0.5), (0, 1.0), (1, 0.5)),
)

TRANSFERS = {t.name: t for t in (AGGREGATE, LINEAR)}


def coarse_shape(shape) -> tuple:
    return tuple(max(1, int(s) // 2) for s in shape)


def _coarsened_axes(shape):
    return [a for a, s in enumerate(shape) if s > 1]


def _shift_axis(x, s: int, axis: int):
    """``z[i] = x[i + s]`` along one axis, zero-filled (static shift)."""
    if s == 0:
        return x
    pad_cfg = [(0, 0, 0)] * x.ndim
    pad_cfg[axis] = (max(0, -s), max(0, s), 0)
    xp = lax.pad(x, jnp.zeros((), x.dtype), pad_cfg)
    start = [0] * x.ndim
    start[axis] = max(0, s)
    limits = [st + n for st, n in zip(start, x.shape)]
    return lax.slice(xp, start, limits)


def _parity_slice(x, pm: int, axis: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(pm, None, 2)
    return x[tuple(idx)]


def _restrict_axis(v, axis: int, taps):
    """out[I] = Σ_t w(t) · v[2I + t] along ``axis`` (zero-fill OOB)."""
    out = None
    for t, w in taps:
        pm = t % 2  # Python mod: −1 % 2 == 1
        s = (t - pm) // 2
        samp = _shift_axis(_parity_slice(v, pm, axis), s, axis)
        term = samp * jnp.asarray(w, dtype=v.dtype)
        out = term if out is None else out + term
    return out


def _prolong_axis(u, axis: int, taps):
    """out[2I + pm] = Σ_{t ≡ pm (2)} w(t) · u[I − (t − pm)/2] along axis."""
    parts = []
    for pm in (0, 1):
        part = None
        for t, w in taps:
            if t % 2 != pm:
                continue
            s = (t - pm) // 2
            term = _shift_axis(u, -s, axis) * jnp.asarray(w, dtype=u.dtype)
            part = term if part is None else part + term
        parts.append(part)
    # interleave even/odd fine positions along `axis`
    stacked = jnp.stack(parts, axis=axis + 1)
    new_shape = list(u.shape)
    new_shape[axis] = u.shape[axis] * 2
    return stacked.reshape(new_shape)


def restrict(v, transfer: Transfer = AGGREGATE):
    """``R v`` (fine → coarse), separably over all coarsenable axes."""
    out = v
    for a in _coarsened_axes(v.shape):
        out = _restrict_axis(out, a, transfer.r_taps)
    return out


def prolong(u, fine_shape, transfer: Transfer = AGGREGATE):
    """``P u`` (coarse → fine).

    ``fine_shape`` identifies which axes were coarsened (those with
    ``fine == 2 * coarse``); a coarse dim of 1 that came from a fine dim of
    2 must still be expanded, so the fine shape cannot be inferred from
    ``u`` alone.
    """
    axes = [a for a, (f, c) in enumerate(zip(fine_shape, u.shape)) if f == 2 * c]
    for a, (f, c) in enumerate(zip(fine_shape, u.shape)):
        if a not in axes and f != c:
            raise ValueError(f"incompatible shapes {u.shape} -> {fine_shape}")
    out = u
    for a in axes:
        out = _prolong_axis(out, a, transfer.p_taps)
    return out
