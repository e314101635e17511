"""Cycle engine: V / W / FMG (components R6, T7, T8).

The reference's ``mg_cycle`` is a recursive Python function (SURVEY.md
§3.2).  Here the recursion unrolls at *trace* time over the static level
list — per-level shapes differ, so the "recursion" becomes straight-line
multi-level code inside a single jitted XLA program; there is no dynamic
control flow on device.

Beyond the reference's V-cycle, two standard stronger cycles ship
(selected by ``SolverConfig.cycle_type``):

* **W-cycle** (``gamma=2``): each level visits its coarser level twice —
  more robust for hard problems at ~2× coarse-level work (cheap in 3D,
  where each level is 1/8 the size).
* **FMG** (full multigrid, "f"): restrict the rhs to every level, solve
  the coarsest exactly, then work back up — prolongate and run one
  V-cycle per level.  One FMG pass costs ~1.3× a V-cycle and contracts
  the error like ~2 V-cycles, so as the defect-correction preconditioner
  it cuts outer cycles roughly in half.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openmg_tpu.core.hierarchy import Hierarchy
from openmg_tpu.ops.smoothers import smooth
from openmg_tpu.ops.sparse import dense_matvec
from openmg_tpu.ops.stencil import apply, residual
from openmg_tpu.ops.transfer import prolong, restrict

__all__ = ["v_cycle", "fmg_cycle", "coarse_solve", "run_cycle", "pcg_solve"]


def coarse_solve(hierarchy: Hierarchy, b):
    """Direct solve at the coarsest level via the precomputed dense inverse
    (R8): one small matrix-vector product at full precision."""
    return dense_matvec(hierarchy.coarse_inv, b.reshape(-1)).reshape(b.shape)


def v_cycle(
    hierarchy: Hierarchy,
    b,
    x,
    level: int = 0,
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
    gamma: int = 1,
    x_zero: bool = False,
):
    """One µ-cycle starting at ``level`` (``gamma=1`` → V, 2 → W);
    returns the improved ``x``.

    All loop/recursion bounds are static; under ``jax.jit`` this traces to
    one straight-line multi-level program (T7).

    ``x_zero`` declares (statically) that ``x`` is all-zero — true at every
    level of the defect-correction cycle (fine level solves ``A e = r``
    from zero; each coarse visit starts from a zero correction).  With no
    pre-smoothing the residual is then ``b`` itself.
    """
    L = hierarchy.levels[level]
    if level == hierarchy.num_levels - 1:
        with jax.named_scope(f"level{level}"):
            return coarse_solve(hierarchy, b)
    with jax.named_scope(f"level{level}"):
        x, bc = _pre_side(hierarchy, L, b, x, pre, smoother, omega, x_zero)
    ec = jnp.zeros_like(bc)
    # µ recursive visits; at the level just above the coarsest a second
    # visit would re-run the exact solve on an (near-)unchanged residual,
    # so W-cycles fall back to one visit there (standard optimization)
    visits = 1 if level == hierarchy.num_levels - 2 else gamma
    for v in range(visits):
        ec = v_cycle(
            hierarchy,
            bc,
            ec,
            level + 1,
            pre,
            post,
            smoother,
            omega,
            gamma,
            x_zero=(v == 0),
        )
    with jax.named_scope(f"level{level}"):
        x = x + prolong(ec, L.grid_shape, hierarchy.transfer)
        return smooth(smoother, L.A, L.inv_diag, b, x, post, omega)


def _pre_side(hierarchy, L, b, x, pre, smoother, omega, x_zero):
    """Pre-smoothing, residual and restriction of one level visit."""
    if x_zero and pre == 0:
        r = b
    else:
        x = smooth(smoother, L.A, L.inv_diag, b, x, pre, omega)
        r = residual(L.A, b, x)
    return x, restrict(r, hierarchy.transfer)


def fmg_cycle(
    hierarchy: Hierarchy,
    b,
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
    gamma: int = 1,
):
    """One full-multigrid pass for ``A x = b`` from a zero initial guess
    (the defect-correction outer loop always solves from zero, so FMG
    needs no ``x`` argument): restrict ``b`` to every level, solve the
    coarsest exactly, then prolongate upward with one µ-cycle per level.
    """
    bs = [b]
    for lvl in range(hierarchy.num_levels - 1):
        bs.append(restrict(bs[-1], hierarchy.transfer))
    x = coarse_solve(hierarchy, bs[-1])
    for lvl in range(hierarchy.num_levels - 2, -1, -1):
        shape = hierarchy.levels[lvl].grid_shape
        x = prolong(x, shape, hierarchy.transfer)
        x = v_cycle(
            hierarchy, bs[lvl], x, lvl, pre, post, smoother, omega, gamma
        )
    return x


def run_cycle(
    hierarchy: Hierarchy,
    r,
    cycle_type: str = "v",
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
):
    """Error-correction cycle ``e ≈ A⁻¹ r`` from zero, by cycle type."""
    if cycle_type == "v":
        return v_cycle(
            hierarchy, r, jnp.zeros_like(r), 0, pre, post, smoother, omega, 1,
            x_zero=True,
        )
    if cycle_type == "w":
        return v_cycle(
            hierarchy, r, jnp.zeros_like(r), 0, pre, post, smoother, omega, 2,
            x_zero=True,
        )
    if cycle_type == "f":
        return fmg_cycle(hierarchy, r, pre, post, smoother, omega, 1)
    raise ValueError(f"unknown cycle_type {cycle_type!r}; choose v|w|f")


def pcg_solve(
    hierarchy: Hierarchy,
    r0,
    iters: int = 2,
    cycle_type: str = "v",
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
):
    """``iters`` steps of conjugate gradients on ``A e = r0`` from zero,
    preconditioned by one multigrid cycle per step (beyond the reference:
    MG-preconditioned Krylov is the standard production combination for
    SPD systems with rough coefficients, where a stationary V-cycle's
    contraction degrades — PAPERS.md two-stage-GS/Krylov literature).

    Used as the inner error solver of the defect-correction loop
    (``SolverConfig(krylov="pcg")``): the outer loop tolerates a
    nonlinear inner map, so no flexible-CG machinery is needed.  The
    steps run as one ``fori_loop``, so the preconditioning cycle is traced
    and compiled once, whatever ``iters`` is (step 0 takes ``β = 0``).
    """
    from jax import lax

    from openmg_tpu.ops.stencil import apply as stencil_apply

    A = hierarchy.levels[0].A

    def step(it, st):
        e, r, p, rz_old = st
        z = run_cycle(hierarchy, r, cycle_type, pre, post, smoother, omega)
        rz = jnp.sum(r * z)
        beta = jnp.where(it == 0, jnp.zeros_like(rz), rz / rz_old)
        p = z + beta * p
        Ap = stencil_apply(A, p)
        alpha = rz / jnp.sum(p * Ap)
        return e + alpha * p, r - alpha * Ap, p, rz

    zero = jnp.zeros_like(r0)
    one = jnp.ones((), r0.dtype)
    e, _, _, _ = lax.fori_loop(0, iters, step, (zero, r0, zero, one))
    return e
