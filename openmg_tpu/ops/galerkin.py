"""Galerkin coarsening ``A_c = R A P`` in stencil form (components R3, T6).

The reference computes the triple product with scipy SpGEMM at every level
(SURVEY.md §3.1).  For regular grids with separable tap transfers
(:mod:`openmg_tpu.ops.transfer`) the product has a closed structured form,
computed here with pure strided array ops (numpy or JAX — no SpGEMM, no
index lists), which is what makes 512³ setup feasible (SURVEY.md §7 "Hard
parts: SpGEMM at 512³").

The contraction is applied one axis at a time (transfers are tensor
products).  For one axis with restriction taps ``(p, wr)`` and prolongation
taps ``(q, wp)``:

    A'[I, I + D]  +=  wr · wp · A[f, f + o]      at  f = 2I + p,
    whenever p + o_axis − q is even,  with  D = (p + o_axis − q) / 2

and all other axes' offsets pass through unchanged.  Sampling
``A[2I + p]`` is a parity slice plus a coarse shift; fine-grid boundary
truncation (zero coefficients) propagates automatically.  Contributions
that would target out-of-domain coarse columns are zeroed at the end to
maintain the stencil invariant (coeff = 0 where row + offset leaves the
grid) — these correspond to prolongation taps of nonexistent coarse cells,
consistent with the transfer ops' zero-fill.

Agreement with scipy SpGEMM on the explicit matrices is proven in
tests/test_galerkin.py for both the aggregate and linear specs.
"""

from __future__ import annotations

import numpy as np

from openmg_tpu.ops.stencil import StencilOperator
from openmg_tpu.ops.transfer import AGGREGATE, Transfer, coarse_shape

__all__ = ["galerkin_rap_stencil", "galerkin_rap"]


def _xp(arr):
    if isinstance(arr, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def _parity_slice(x, pm: int, axis: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(pm, None, 2)
    return x[tuple(idx)]


def _shift_axis_np(xp, x, s: int, axis: int):
    """z[i] = x[i + s] along axis, zero-filled, numpy/jnp-agnostic.

    The jnp path uses pad+slice (NOT zeros+scatter: XLA lowers scatters
    poorly on CPU and tries to constant-fold them for minutes at 256³).
    """
    if s == 0:
        return x
    n = x.shape[axis]
    if xp is np:
        z = np.zeros_like(x)
        src = [slice(None)] * x.ndim
        dst = [slice(None)] * x.ndim
        if s > 0:
            dst[axis] = slice(0, n - s)
            src[axis] = slice(s, n)
        else:
            dst[axis] = slice(-s, n)
            src[axis] = slice(0, n + s)
        z[tuple(dst)] = x[tuple(src)]
        return z
    from jax import lax
    import jax.numpy as jnp

    pad_cfg = [(0, 0, 0)] * x.ndim
    pad_cfg[axis] = (max(0, -s), max(0, s), 0)
    xpad = lax.pad(x, jnp.zeros((), x.dtype), pad_cfg)
    start = [0] * x.ndim
    start[axis] = max(0, s)
    limits = [st + nn for st, nn in zip(start, x.shape)]
    return lax.slice(xpad, start, limits)


def _rap_axis(offsets, coeffs, axis: int, r_taps, p_taps):
    """Contract one grid axis by factor 2 with the given taps.

    The numpy path accumulates in place (this host's numpy is memory-
    bandwidth-bound; every avoided full-array pass matters at 512³ setup).
    """
    xp = _xp(coeffs)
    acc: dict = {}
    for k, off in enumerate(offsets):
        ck = coeffs[k]
        o = off[axis]
        for p, wr in r_taps:
            pm = p % 2
            s = (p - pm) // 2
            samp = None  # computed lazily: some (p) rows have no valid q
            for q, wp in p_taps:
                num = p + o - q
                if num % 2:
                    continue
                D = num // 2
                newoff = tuple(
                    D if a == axis else off[a] for a in range(len(off))
                )
                if samp is None:
                    samp = _shift_axis_np(
                        xp, _parity_slice(ck, pm, axis), s, axis
                    )
                w = wr * wp
                if xp is np:
                    if newoff in acc:
                        np.add(acc[newoff], samp * w, out=acc[newoff])
                    else:
                        acc[newoff] = samp * w  # first term owns the buffer
                else:
                    term = samp * w
                    acc[newoff] = acc[newoff] + term if newoff in acc else term
    new_offsets = list(acc.keys())
    stacked = xp.stack([acc[D] for D in new_offsets])
    return new_offsets, stacked


def _zero_oob(xp, offsets, coeffs):
    """Enforce the stencil invariant: coeff[k][i] = 0 where i + off OOB.

    The numpy path mutates ``coeffs`` in place (callers pass freshly
    stacked arrays); only thin boundary slices are touched.
    """
    shape = coeffs.shape[1:]
    if xp is np:
        for k, off in enumerate(offsets):
            for axis, o in enumerate(off):
                n = shape[axis]
                if o == 0:
                    continue
                idx = [slice(None)] * len(shape)
                idx[axis] = (
                    slice(max(0, n - o), n) if o > 0 else slice(0, min(n, -o))
                )
                coeffs[(k,) + tuple(idx)] = 0
        return coeffs
    # jnp path: multiply by an iota-derived in-domain mask (scatter-free)
    import jax
    import jax.numpy as jnp

    out = []
    for k, off in enumerate(offsets):
        c = coeffs[k]
        mask = None
        for axis, o in enumerate(off):
            n = shape[axis]
            if o == 0:
                continue
            i = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), axis)
            cond = i < n - o if o > 0 else i >= -o
            mask = cond if mask is None else mask & cond
        out.append(c if mask is None else c * mask.astype(c.dtype))
    return xp.stack(out)


def galerkin_rap_stencil(
    offsets, coeffs, transfer: Transfer = AGGREGATE, prune: bool = True
):
    """Structured RAP on raw ``(offsets, coeffs)`` arrays (numpy or jax).

    Returns coarse ``(offsets, coeffs)``.  ``prune`` drops coarse offsets
    whose coefficient grid is identically zero (requires concrete values —
    setup runs eagerly, outside jit).
    """
    xp = _xp(coeffs)
    shape = tuple(coeffs.shape[1:])
    d = len(shape)
    axes = [a for a in range(d) if shape[a] > 1]
    if any(shape[a] % 2 for a in axes):
        raise ValueError(f"all dims > 1 must be even to coarsen, got {shape}")

    cur_offsets = [tuple(o) for o in offsets]
    cur = coeffs
    for a in axes:
        cur_offsets, cur = _rap_axis(cur_offsets, cur, a, transfer.r_taps, transfer.p_taps)
    cur = _zero_oob(xp, cur_offsets, cur)
    cur = cur.astype(coeffs.dtype, copy=False) if xp is np else cur.astype(
        coeffs.dtype
    )
    assert tuple(cur.shape[1:]) == coarse_shape(shape)

    if prune:
        keep = [i for i in range(len(cur_offsets)) if bool((cur[i] != 0).any())]
        if not keep:  # degenerate all-zero operator; keep the diagonal slot
            keep = [0]
        cur_offsets = [cur_offsets[i] for i in keep]
        cur = cur[np.asarray(keep)]

    # diagonal-first convention
    zero = (0,) * d
    order = sorted(range(len(cur_offsets)), key=lambda i: (cur_offsets[i] != zero, cur_offsets[i]))
    cur_offsets = [cur_offsets[i] for i in order]
    cur = cur[np.asarray(order)]
    return tuple(cur_offsets), cur


def rap_output_offsets(offsets, shape, transfer: Transfer = AGGREGATE):
    """Static (host-side) computation of the coarse offset list the RAP
    chain will produce, via a structural dry run on a tiny dummy grid with
    the same dims>1 pattern — used to jit the device RAP (whose output
    offsets must be known at trace time)."""
    dummy_shape = tuple(4 if s > 1 else 1 for s in shape)
    dummy = np.ones((len(offsets),) + dummy_shape, dtype=np.float32)
    offs, _ = galerkin_rap_stencil(offsets, dummy, transfer=transfer, prune=False)
    return offs


def galerkin_rap_device(offsets, coeffs, transfer: Transfer = AGGREGATE):
    """Device-side jitted Galerkin RAP (setup-on-device fast path).

    One jitted program per level, with the (static) output offset list
    precomputed by
    :func:`rap_output_offsets` and identically-zero offsets pruned by a
    single vectorized device reduction afterwards.
    """
    import functools as _ft

    import jax
    import jax.numpy as jnp

    offsets = tuple(tuple(o) for o in offsets)
    shape = tuple(int(s) for s in coeffs.shape[1:])
    out_offsets = rap_output_offsets(offsets, shape, transfer)

    @_ft.partial(jax.jit, static_argnames=())
    def run(c):
        offs, cur = galerkin_rap_stencil(offsets, c, transfer=transfer, prune=False)
        assert tuple(offs) == tuple(out_offsets)
        return cur

    cur = run(coeffs)
    nz = np.asarray(jnp.any(cur != 0, axis=tuple(range(1, cur.ndim))))
    keep = [i for i in range(len(out_offsets)) if nz[i]] or [0]
    return tuple(out_offsets[i] for i in keep), cur[np.asarray(keep)]


def galerkin_rap(
    op: StencilOperator, transfer: Transfer = AGGREGATE, prune: bool = True
) -> StencilOperator:
    """Structured Galerkin coarsening of a :class:`StencilOperator`."""
    c_offsets, c_coeffs = galerkin_rap_stencil(
        op.offsets, op.coeffs, transfer=transfer, prune=prune
    )
    return StencilOperator(c_coeffs, tuple(c_offsets))
