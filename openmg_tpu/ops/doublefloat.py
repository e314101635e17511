"""Double-float (two-f32, "double-word") arithmetic for the outer residual.

SURVEY.md §7 "Hard parts" Plan A: the defect-correction residual
``r = b − A x`` is evaluated in **double-float** arithmetic — each value is
an unevaluated sum ``hi + lo`` of two float32s (~49-bit effective mantissa,
unit roundoff ~2⁻⁴⁹ ≈ 1.8e-15) — using the classical error-free
transformations (Knuth TwoSum, Dekker TwoProd/split).  All operations are
elementwise f32 code that needs no float64 on the device.  It is the
default high-precision residual off the CPU; whether native f64 is faster
on a given card is an open measurement (ROADMAP Speed 4).

A note on compiler semantics: TwoSum uses only adds/subs (XLA does not
reassociate floating point), and TwoProd's multiply-add pairs may legally be
contracted to FMA by the backend — the FMA variant of TwoProd computes the
*same* error term (it is the textbook fma formulation), so contraction is
harmless here.

Double-float values are ``(hi, lo)`` tuples of same-shape f32 arrays.
Accuracy against numpy float64 oracles is proven in tests/test_doublefloat.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "pow2_terms",
    "df_split",
    "df_merge",
    "two_sum",
    "quick_two_sum",
    "two_prod",
    "df_add",
    "df_add_f32",
    "df_sub",
    "df_neg",
    "df_mul",
    "df_mul_f32",
]

# Dekker splitting constant for f32 (p=24): 2^ceil(p/2) + 1
_SPLIT = np.float32(4097.0)


def pow2_terms(v, max_terms: int = 3):
    """Decompose ``v`` into a sum of ≤ ``max_terms`` signed powers of two,
    or None.  A power-of-two factor makes ``p·x`` *exact* in f32 (no
    mantissa bits added), so a double-float multiply by such a ``v``
    degenerates to exact scalings + compensated adds — the basis of the
    fast-path residual for Poisson-family stencils, whose taps are all of
    this form (±1 and 2d = 2, 4, 4+2)."""
    import math

    r = float(v)
    if r != np.float64(np.float32(r)):
        return None  # not exactly representable
    out = []
    for _ in range(max_terms):
        if r == 0.0:
            return tuple(out)
        a = math.copysign(2.0 ** math.floor(math.log2(abs(r))), r)
        out.append(a)
        r -= a
    return tuple(out) if r == 0.0 else None


def df_split(a) -> tuple:
    """Host-side split of a float64 array into an exact (hi, lo) f32 pair."""
    a = np.asarray(a, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_merge(x) -> np.ndarray:
    """Host-side merge back to float64."""
    hi, lo = x
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split32(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker split)."""
    p = a * b
    a_hi, a_lo = _split32(a)
    b_hi, b_lo = _split32(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x, y):
    """Double-float + double-float."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def df_add_f32(x, a):
    """Double-float + plain f32."""
    s, e = two_sum(x[0], a)
    e = e + x[1]
    return quick_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    """Double-float × double-float."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def df_mul_f32(x, a):
    """Double-float × plain f32."""
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return quick_two_sum(p, e)
