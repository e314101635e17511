"""Distributed multigrid: row-partitioned levels over a 1D device mesh
(components T9 row/block partition, T10 halo exchange, T11 coarse
redistribution, T16 collective substrate).

Design (SURVEY.md §3.4 / §7):

* Every level's grid arrays are partitioned along grid axis 0 across the
  mesh axis ``"x"`` (contiguous row blocks per device) while the level is
  large enough; the static *partition plan* decides per level.
* Smoothing/residual/SpMV at partitioned levels exchange one halo plane
  each way via ``lax.ppermute`` (:mod:`openmg_tpu.parallel.halo`);
  intergrid transfers use halo taps along axis 0 and purely local ops on
  the trailing axes.
* When a level's per-device block would become too small (or lose factor-2
  divisibility), the cycle *redistributes*: the restricted residual is
  ``all_gather``-ed and all coarser levels run replicated — every device
  executes the identical coarse computation (deterministic), and the
  correction is sliced back to local blocks on the way up (T11).
* Norms are ``psum`` reductions.  The whole distributed V-cycle is one
  ``shard_map``-ped jitted program per hierarchy.

The partitioned solve matches the single-device solve to fp tolerance
(tests/test_parallel.py); elementwise arithmetic is identical, only
reduction order differs (norms).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from openmg_tpu.core.config import MeshConfig, SolverConfig
from openmg_tpu.core.hierarchy import Hierarchy
from openmg_tpu.ops.doublefloat import df_add_f32, df_merge, df_mul, df_split, df_sub
from openmg_tpu.ops.smoothers import parity_mask_expr
from openmg_tpu.ops.smoothers import smooth as smooth_plain
from openmg_tpu.ops.sparse import dense_matvec
from openmg_tpu.ops.stencil import StencilOperator
from openmg_tpu.ops.transfer import (
    Transfer,
    _prolong_axis,
    _restrict_axis,
)
from openmg_tpu.parallel.halo import (
    apply_ext,
    apply_overlapped,
    halo_exchange,
    halo_planes,
    prolong_axis0_ext,
    restrict_axis0_ext,
    shifted_ext,
)
from openmg_tpu.parallel.mesh import make_mesh

__all__ = ["partition_plan", "DistributedSolver", "distributed_setup"]


def partition_plan(
    shapes, n_dev: int, min_rows_per_device: int = 2, force: bool = False
) -> tuple:
    """Static per-level partitioned/replicated decision (T11 policy table).

    Level ℓ stays partitioned while all of: the previous level is
    partitioned, ``shape0 % n_dev == 0``, the local block is at least
    ``min_rows_per_device`` rows, and the local block extent is even (so
    factor-2 restriction never splits an aggregation cell across devices).
    The coarsest level is always replicated (its direct solve is a small
    dense matmul executed identically everywhere).

    ``force=True`` (``MeshConfig.force_partition``) drops the ``n_dev > 1``
    requirement: levels are marked partitioned even on a 1-device mesh so
    a single device compiles/runs the exact per-device program (the
    halo layer degenerates to zero planes with no collective there).
    """
    plan = []
    prev = True
    for i, shape in enumerate(shapes):
        s0 = int(shape[0])
        ok = (
            prev
            and (n_dev > 1 or force)
            and s0 % n_dev == 0
            and s0 // n_dev >= min_rows_per_device
            and (s0 // n_dev) % 2 == 0
        )
        if i == len(shapes) - 1:
            ok = False
        plan.append(ok)
        prev = ok
    return tuple(plan)


# ---------------------------------------------------------------------------
# partitioned-level ops (run inside shard_map on local blocks)
# ---------------------------------------------------------------------------


def _apply_dist(op, x, axis_name, n_dev, overlap, exclude_diag=False):
    """Partitioned SpMV: overlapped (halo planes consumed only by the
    boundary-row corrections — the BASELINE halo/compute overlap, T10) or
    the plain exchange-then-apply reference path."""
    if overlap:
        lower, upper = halo_planes(x, axis_name, n_dev)
        return apply_overlapped(op, x, lower, upper, exclude_diag)
    return apply_ext(op, halo_exchange(x, axis_name, n_dev), exclude_diag)


def _smooth_part(
    name,
    op: StencilOperator,
    inv_diag,
    b,
    x,
    iterations,
    omega,
    axis_name,
    n_dev,
    overlap: bool = True,
):
    om = jnp.asarray(omega, dtype=x.dtype)
    if name == "jacobi":
        for _ in range(iterations):
            ax = _apply_dist(op, x, axis_name, n_dev, overlap)
            x = x + om * inv_diag * (b - ax)
        return x
    if name == "rbgs":
        # local parity == global parity: the partition plan guarantees an
        # even number of local rows per device
        mask = parity_mask_expr(x.shape)
        for _ in range(iterations):
            for m in (mask, ~mask):
                off_sum = _apply_dist(
                    op, x, axis_name, n_dev, overlap, exclude_diag=True
                )
                xn = inv_diag * (b - off_sum)
                x = jnp.where(m, xn, x)
        return x
    if name == "chebyshev":
        # 4th-kind Chebyshev (see ops.smoothers.chebyshev) on partitioned
        # blocks; pure Jacobi building blocks, so it distributes exactly
        from openmg_tpu.ops.smoothers import gershgorin_lambda_max

        lam = gershgorin_lambda_max(op, inv_diag)
        if not op.is_constant:
            lam = lax.pmax(lam, axis_name)  # one global polynomial
        lam = jnp.asarray(lam, dtype=x.dtype)
        r = b - _apply_dist(op, x, axis_name, n_dev, overlap)
        d = (4.0 / 3.0) / lam * inv_diag * r
        for k in range(1, iterations + 1):
            x = x + d
            if k == iterations:
                break
            r = r - _apply_dist(op, d, axis_name, n_dev, overlap)
            d = ((2 * k - 1) / (2 * k + 3)) * d + (
                (8 * k + 4) / (2 * k + 3)
            ) / lam * inv_diag * r
        return x
    raise ValueError(f"unknown smoother {name!r}")


def _restrict_dist(r, transfer, axes, part_here, axis_name, n_dev):
    """Restrict over ``axes``; axis 0 via halo taps when partitioned."""
    out = r
    for a in axes:
        if a == 0 and part_here:
            r_ext = halo_exchange(out, axis_name, n_dev)
            out = restrict_axis0_ext(r_ext, transfer.r_taps)
        else:
            out = _restrict_axis(out, a, transfer.r_taps)
    return out


# ---------------------------------------------------------------------------
# the distributed V-cycle (one shard_map program)
# ---------------------------------------------------------------------------


def _dist_v_cycle(
    level_data,  # tuple per level: arrays per `kinds[level]` (local blocks)
    coarse_inv,
    r,
    *,
    offsets_per_level,
    kinds,  # per level: "const" | "corner" | "vary" (static)
    subsets_per_level,  # per level: cornered axis subsets or None (static)
    coarsened_axes,  # per level: axes halved between level and level+1
    plan,
    transfer: Transfer,
    pre,
    post,
    smoother,
    omega,
    axis_name,
    n_dev,
    overlap: bool = True,
    gamma: int = 1,
    fmg: bool = False,
):
    from openmg_tpu.ops.stencil import CorneredOperator
    from openmg_tpu.ops.stencil import residual as stencil_residual
    from openmg_tpu.parallel import fast

    num_levels = len(level_data)

    def op_at(level, vec_shape):
        data = level_data[level]
        offsets = offsets_per_level[level]
        kind = kinds[level]
        if kind == "const":
            return StencilOperator(None, offsets, data[0], tuple(vec_shape))
        if kind == "corner":
            return CorneredOperator(
                data[0], data[1], offsets, tuple(vec_shape),
                subsets_per_level[level],
            )
        return StencilOperator(data[0], offsets)

    def inv_diag_at(level):
        data = level_data[level]
        kind = kinds[level]
        if kind == "vary":
            return data[1]
        from openmg_tpu.ops.stencil import diag_index

        # constant/cornered interior 1/diag (scalar, free under jit); the
        # cornered smoothers use exact per-region diagonals internally
        return 1.0 / data[0][diag_index(offsets_per_level[level])]

    def smooth_at(level, b, x, iters):
        if iters <= 0:
            return x
        op = op_at(level, x.shape)
        if plan[level]:
            if kinds[level] in ("const", "corner"):
                return fast.smooth_part(
                    smoother, op, b, x, iters, omega, axis_name, n_dev
                )
            return _smooth_part(
                smoother, op, inv_diag_at(level), b, x, iters, omega,
                axis_name, n_dev, overlap,
            )
        return smooth_plain(
            smoother, op, inv_diag_at(level), b, x, iters, omega
        )

    def residual_at(level, b, x):
        op = op_at(level, x.shape)
        if plan[level]:
            if kinds[level] in ("const", "corner"):
                return fast.residual_part(op, b, x, axis_name, n_dev)
            return b - _apply_dist(op, x, axis_name, n_dev, overlap)
        return stencil_residual(op, b, x)

    def restrict_at(level, rr):
        """Level → level+1 restriction including the redistribution
        all_gather at a partitioned→replicated transition (T11)."""
        axes = coarsened_axes[level]
        bc = _restrict_dist(rr, transfer, axes, plan[level], axis_name, n_dev)
        if plan[level] and not plan[level + 1]:
            bc = lax.all_gather(bc, axis_name, axis=0, tiled=True)
        return bc

    def prolong_at(level, ec):
        """Level+1 → level prolongation (halo taps between partitioned
        levels; full prolong + local re-slice off a replicated level)."""
        axes = coarsened_axes[level]
        if plan[level]:
            if plan[level + 1]:
                up = ec
                for a in reversed(axes):
                    if a == 0:
                        u_ext = halo_exchange(up, axis_name, n_dev)
                        up = prolong_axis0_ext(u_ext, transfer.p_taps)
                    else:
                        up = _prolong_axis(up, a, transfer.p_taps)
            else:
                # coarse is replicated/full: prolong fully, slice local rows
                up = ec
                for a in reversed(axes):
                    up = _prolong_axis(up, a, transfer.p_taps)
                idx = lax.axis_index(axis_name)
                local = up.shape[0] // n_dev
                up = lax.dynamic_slice_in_dim(up, idx * local, local, axis=0)
        else:
            up = ec
            for a in reversed(axes):
                up = _prolong_axis(up, a, transfer.p_taps)
        return up

    def coarse(b):
        return dense_matvec(coarse_inv, b.reshape(-1)).reshape(b.shape)

    def vc(level, b, x, x_zero=False):
        if level == num_levels - 1:
            return coarse(b)
        if x_zero and pre == 0:
            rr = b
        else:
            x = smooth_at(level, b, x, pre)
            rr = residual_at(level, b, x)
        bc = restrict_at(level, rr)
        ec = jnp.zeros_like(bc)
        visits = 1 if level == num_levels - 2 else gamma
        for v in range(visits):
            ec = vc(level + 1, bc, ec, x_zero=(v == 0))
        x = x + prolong_at(level, ec)
        x = smooth_at(level, b, x, post)
        return x

    if not fmg:
        return vc(0, r, jnp.zeros_like(r), x_zero=True)

    # Full multigrid (distributed): restrict the rhs to every level with
    # the same halo-tap/redistribution transfers the V-cycle uses, solve
    # the (replicated) coarsest exactly, then prolongate upward with one
    # µ-cycle per level — the per-level rhs redistribution that was
    # rejected in earlier rounds is exactly restrict_at.
    bs = [r]
    for level in range(num_levels - 1):
        bs.append(restrict_at(level, bs[-1]))
    x = coarse(bs[-1])
    for level in range(num_levels - 2, -1, -1):
        x = prolong_at(level, x)
        x = vc(level, bs[level], x, x_zero=False)
    return x


def _dist_pcg(level_data, coarse_inv, r0, *, iters, cycle_kwargs):
    """Distributed MG-preconditioned CG on ``A e = r0`` from zero —
    the shard_map mirror of ``core.cycle.pcg_solve`` (SURVEY.md §2B
    T7/T16 engine symmetry).  One ``_dist_v_cycle`` preconditioner
    application and one partitioned fine-level SpMV per step; the three
    CG inner products each cost one ``lax.psum`` scalar reduction, so
    the added communication per step is negligible next to the cycle's
    halo traffic.  Static trip count — trace-unrolls into the solve
    program like the single-device version."""
    from openmg_tpu.ops.stencil import CorneredOperator
    from openmg_tpu.ops.stencil import apply as stencil_apply
    from openmg_tpu.parallel import fast

    kinds = cycle_kwargs["kinds"]
    plan = cycle_kwargs["plan"]
    offsets = cycle_kwargs["offsets_per_level"][0]
    subsets = cycle_kwargs["subsets_per_level"][0]
    axis_name = cycle_kwargs["axis_name"]
    n_dev = cycle_kwargs["n_dev"]
    overlap = cycle_kwargs.get("overlap", True)
    data = level_data[0]

    def op0(shape):
        if kinds[0] == "const":
            return StencilOperator(None, offsets, data[0], tuple(shape))
        if kinds[0] == "corner":
            return CorneredOperator(
                data[0], data[1], offsets, tuple(shape), subsets
            )
        return StencilOperator(data[0], offsets)

    def apply_A(p):
        op = op0(p.shape)
        if plan[0]:
            # A·p as -(0 - A·p) through the partitioned residual (the
            # same halo-exact path the cycle uses)
            if kinds[0] in ("const", "corner"):
                return -fast.residual_part(
                    op, jnp.zeros_like(p), p, axis_name, n_dev
                )
            return _apply_dist(op, p, axis_name, n_dev, overlap)
        return stencil_apply(op, p)

    def pdot(a, b):
        s = jnp.sum(a * b)
        if plan[0] and n_dev > 1:
            s = lax.psum(s, axis_name)
        return s

    def precond(rr):
        return _dist_v_cycle(level_data, coarse_inv, rr, **cycle_kwargs)

    e = jnp.zeros_like(r0)
    r = r0
    z = precond(r)
    p = z
    rz = pdot(r, z)
    for it in range(iters):
        Ap = apply_A(p)
        alpha = rz / pdot(p, Ap)
        e = e + alpha * p
        if it == iters - 1:
            break
        r = r - alpha * Ap
        z = precond(r)
        rz_new = pdot(r, z)
        beta = rz_new / rz
        rz = rz_new
        p = z + beta * p
    return e


def _dist_error_solve(
    level_data, coarse_inv, r, *, krylov, krylov_iters, cycle_kwargs
):
    """Inner error solve ``e ≈ A⁻¹ r``: pure MG cycle, or krylov_iters
    MG-preconditioned CG steps (mirrors ``core.solver._error_solve``)."""
    if krylov == "pcg":
        return _dist_pcg(
            level_data, coarse_inv, r,
            iters=krylov_iters, cycle_kwargs=cycle_kwargs,
        )
    return _dist_v_cycle(level_data, coarse_inv, r, **cycle_kwargs)


def _dist_residual_df(
    c_hi,
    c_lo,
    b_hi,
    b_lo,
    x_hi,
    x_lo,
    *,
    offsets,
    axis_name,
    n_dev,
    part,
    exact_terms=None,
):
    def coeff(data, k):
        return data[k]  # (K,) scalar row or (K, *grid) block — both index k

    if part:
        xh = halo_exchange(x_hi, axis_name, n_dev)
        xl = halo_exchange(x_lo, axis_name, n_dev)
        samples = [(shifted_ext(xh, o), shifted_ext(xl, o)) for o in offsets]
    else:
        from openmg_tpu.ops.stencil import shift

        samples = [(shift(x_hi, o), shift(x_lo, o)) for o in offsets]
    acc = (b_hi, b_lo)
    for k, xs in enumerate(samples):
        if exact_terms is not None:
            # power-of-two taps: products are exact, only compensated
            # adds needed (see core.solver._residual_norm_df_exact_t)
            for p in exact_terms[k]:
                pf = jnp.float32(p)
                acc = df_sub(acc, (pf * xs[0], pf * xs[1]))
        else:
            term = df_mul((coeff(c_hi, k), coeff(c_lo, k)), xs)
            acc = df_sub(acc, term)
    nsq = jnp.sum(acc[0] * acc[0])
    if n_dev > 1:
        nsq = lax.psum(nsq, axis_name)
    return acc[0], acc[1], jnp.sqrt(nsq)


def _dist_solve_loop(
    level_data,
    coarse_inv,
    c_hi,
    c_lo,
    b_hi,
    b_lo,
    x_hi,
    x_lo,
    *,
    limit,
    threshold,
    res_kwargs,
    cycle_kwargs,
    krylov="none",
    krylov_iters=2,
):
    """Whole-solve loop, per-device body under shard_map: residuals, the
    distributed V-cycle, the convergence check, and the history are all one
    program — no host round-trip per cycle (mirrors core.solver's
    ``_solve_device``; see its docstring for why).  ``k``/``hist``/``done``
    are computed from the psum-replicated norm, hence identical on every
    device."""
    hist0 = jnp.full((limit + 1,), -1.0, dtype=jnp.float32)

    def cond_fn(st):
        _, _, k, _, done = st
        return jnp.logical_and(jnp.logical_not(done), k <= limit)

    def body_fn(st):
        xh, xl, k, hist, _ = st
        r_hi, _, rn = _dist_residual_df(
            c_hi, c_lo, b_hi, b_lo, xh, xl, **res_kwargs
        )
        hist = hist.at[k].set(rn.astype(jnp.float32))
        done = rn < threshold
        do_cycle = jnp.logical_and(jnp.logical_not(done), k < limit)

        def run(ops):
            xh_, xl_, r_ = ops
            e = _dist_error_solve(
                level_data, coarse_inv, r_,
                krylov=krylov, krylov_iters=krylov_iters,
                cycle_kwargs=cycle_kwargs,
            )
            return df_add_f32((xh_, xl_), e)

        xh, xl = lax.cond(
            do_cycle, run, lambda ops: (ops[0], ops[1]), (xh, xl, r_hi)
        )
        return (xh, xl, k + 1, hist, done)

    xh, xl, k, hist, done = lax.while_loop(
        cond_fn,
        body_fn,
        (x_hi, x_lo, jnp.int32(0), hist0, jnp.bool_(False)),
    )
    from openmg_tpu.utils.observe import pack_solve_meta

    return xh, xl, pack_solve_meta(k, hist, done)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


class DistributedSolver:
    """Multi-device solver: same contract as :class:`~openmg_tpu.core.
    solver.Solver`, with every array row-partitioned over the mesh.

    Only the ``doublefloat`` residual mode is offered on the distributed
    path (see core/solver.py).

    Scope limits (validated at construction):

    * **Halo width 1**: every partitioned level's operator must have
      axis-0 offsets in {−1, 0, +1} (true of the whole Poisson/Galerkin
      family this framework builds — radius-1 fine stencils stay radius-1
      under the radius-1 transfers).  Wider operators would need
      multi-plane halos, which the exchange layer does not implement.
    * This class distributes stencil-form problems.  General-sparse
      (ELL) problems with banded structure distribute via
      :class:`openmg_tpu.parallel.sparse_dist.DistributedAlgebraicSolver`
      (slot-offset levels row-partition exactly like the stencil tier —
      ``max|d|``-row halo slabs, static-slice SpMV on the extended
      segment); irregular-sparsity matrices remain single-device
      (:class:`openmg_tpu.core.algebraic.AlgebraicSolver`).
    """

    def __init__(
        self,
        hierarchy: Hierarchy,
        config: SolverConfig,
        mesh_config: MeshConfig | None = None,
    ):
        if hierarchy.fine_hi_lo is None:
            raise ValueError(
                "distributed solver requires residual_dtype='doublefloat'"
            )
        # Cornered levels distribute natively (O(K) replicated tables —
        # parallel/fast.py); only the dense-face-plane representation is
        # materialized to varying arrays (rare: the structured builder
        # emits cornered, not faced, levels).
        import dataclasses as _dc

        from openmg_tpu.ops.stencil import CorneredOperator, FacedStencilOperator

        def _devarnish(l):
            if not isinstance(l.A, FacedStencilOperator):
                return l
            A = l.A.to_varying()
            di = A.offsets.index((0,) * l.A.ndim)
            return _dc.replace(l, A=A, inv_diag=1.0 / A.coeff(di))

        if any(
            isinstance(l.A, FacedStencilOperator) for l in hierarchy.levels
        ):
            hierarchy = _dc.replace(
                hierarchy,
                levels=tuple(_devarnish(l) for l in hierarchy.levels),
            )
        if config.cycle_type not in ("v", "w", "f"):
            raise ValueError(
                f"unknown cycle_type {config.cycle_type!r}; choose v|w|f"
            )
        if config.krylov not in (None, "none", "pcg"):
            raise ValueError(
                f"unknown krylov {config.krylov!r}; choose none|pcg"
            )
        self.config = config
        self.mesh_config = mesh_config or MeshConfig()
        if self.mesh_config.mesh_shape is not None:
            from openmg_tpu.parallel.mesh import make_mesh_2d

            self.mesh = make_mesh_2d(
                self.mesh_config.mesh_shape, self.mesh_config.axis_names
            )
            # the partition axis spans both mesh axes: collectives take the
            # axis-name tuple (linearized host-major index)
            self.axis_name = tuple(self.mesh_config.axis_names)
        else:
            self.mesh = make_mesh(
                self.mesh_config.n_devices, self.mesh_config.axis_name
            )
            self.axis_name = self.mesh_config.axis_name
        self.n_dev = self.mesh.devices.size
        shapes = [s[0] for s in hierarchy.stats]
        self.plan = partition_plan(
            shapes,
            self.n_dev,
            self.mesh_config.min_rows_per_device,
            force=self.mesh_config.force_partition,
        )
        if not self.plan[0] and self.n_dev > 1:
            raise ValueError(
                f"finest level shape {shapes[0]} cannot be row-partitioned "
                f"over {self.n_dev} devices (axis 0 must divide evenly with "
                f">= {2 * self.mesh_config.min_rows_per_device} rows/device)"
            )
        self.grid_shape = shapes[0]
        self.offsets_per_level = tuple(l.A.offsets for l in hierarchy.levels)
        for i, offs in enumerate(self.offsets_per_level):
            if self.plan[i] and any(abs(o[0]) > 1 for o in offs):
                raise ValueError(
                    f"level {i} operator reaches {max(abs(o[0]) for o in offs)} "
                    "rows across the partition boundary; the distributed "
                    "halo exchange supports radius-1 (one plane each way) "
                    "only — coarsen differently or solve single-device"
                )

        def _kind(A):
            if isinstance(A, CorneredOperator):
                return "corner"
            return "const" if A.is_constant else "vary"

        self.kinds = tuple(_kind(l.A) for l in hierarchy.levels)
        self.subsets_per_level = tuple(
            l.A.subsets if isinstance(l.A, CorneredOperator) else None
            for l in hierarchy.levels
        )
        self.coarsened_axes = tuple(
            tuple(
                a
                for a in range(len(shapes[i]))
                if shapes[i + 1][a] * 2 == shapes[i][a]
            )
            for i in range(len(shapes) - 1)
        ) + ((),)
        self.transfer = hierarchy.transfer
        self.stats = hierarchy.stats

        # shard the hierarchy per the plan.  Constant levels carry a tiny
        # replicated (K,) value vector; cornered levels the (K,) values +
        # (n_subsets, K) delta table — O(K) total, never a materialized
        # coefficient grid; only varying levels shard real grid arrays.
        def put(arr, partitioned, grid_axis):
            if partitioned:
                spec = [None] * arr.ndim
                spec[grid_axis] = self.axis_name
                sh = NamedSharding(self.mesh, P(*spec))
            else:
                sh = NamedSharding(self.mesh, P())
            return jax.device_put(arr, sh)

        def coeff_data(op, partitioned):
            if op.is_constant:
                return put(op.values, False, 0)
            return put(op.coeffs, partitioned, 1)

        def level_payload(i, l):
            kind = self.kinds[i]
            if kind == "const":
                return (put(l.A.values, False, 0),)
            if kind == "corner":
                return (put(l.A.values, False, 0), put(l.A.deltas, False, 0))
            return (
                put(l.A.coeffs, self.plan[i], 1),
                put(l.inv_diag, self.plan[i], 0),
            )

        self.level_data = tuple(
            level_payload(i, l) for i, l in enumerate(hierarchy.levels)
        )
        self.coarse_inv = put(hierarchy.coarse_inv, False, 0)
        from openmg_tpu.core.solver import exact_residual_terms

        self._exact_terms = exact_residual_terms(hierarchy)
        self.fine_hi = coeff_data(hierarchy.fine_hi, self.plan[0])
        self.fine_lo = coeff_data(hierarchy.fine_hi_lo, self.plan[0])
        self.fine_const = hierarchy.fine_hi.is_constant
        self._fine_offsets = hierarchy.fine_hi.offsets

        self._build_programs()

    def _specs(self):
        """shard_map PartitionSpecs mirroring the data layout."""
        gd = len(self.grid_shape)

        def spec(partitioned, grid_axis, ndim):
            if not partitioned:
                return P()
            s = [None] * ndim
            s[grid_axis] = self.axis_name
            return P(*s)

        def level_spec(i):
            kind = self.kinds[i]
            if kind == "const":
                return (P(),)
            if kind == "corner":
                return (P(), P())
            return (spec(self.plan[i], 1, gd + 1), spec(self.plan[i], 0, gd))

        level_specs = tuple(
            level_spec(i) for i in range(len(self.level_data))
        )
        vec = spec(self.plan[0], 0, gd)
        return level_specs, vec

    def _build_programs(self):
        cfg = self.config
        level_specs, vec = self._specs()
        mesh = self.mesh

        cycle_kwargs = dict(
            offsets_per_level=self.offsets_per_level,
            kinds=self.kinds,
            subsets_per_level=self.subsets_per_level,
            coarsened_axes=self.coarsened_axes,
            plan=self.plan,
            transfer=self.transfer,
            pre=cfg.pre_iterations,
            post=cfg.post_iterations,
            smoother=cfg.smoother,
            omega=cfg.omega,
            axis_name=self.axis_name,
            n_dev=self.n_dev,
            overlap=self.mesh_config.overlap_halo,
            gamma={"v": 1, "w": 2, "f": 1}[cfg.cycle_type],
            fmg=cfg.cycle_type == "f",
        )
        cycle_impl = functools.partial(
            _dist_error_solve,
            krylov=cfg.krylov or "none",
            krylov_iters=cfg.krylov_iters,
            cycle_kwargs=cycle_kwargs,
        )
        self._cycle = jax.jit(
            jax.shard_map(
                cycle_impl,
                mesh=mesh,
                in_specs=(level_specs, P(), vec),
                out_specs=vec,
                check_vma=False,
            )
        )

        res_impl = functools.partial(
            _dist_residual_df,
            offsets=self._fine_offsets,
            axis_name=self.axis_name,
            n_dev=self.n_dev,
            part=self.plan[0],
            exact_terms=self._exact_terms,
        )
        gd = len(self.grid_shape)
        if self.fine_const:
            coef_spec = P()
        elif self.plan[0]:
            s = [None] * (gd + 1)
            s[1] = self.axis_name
            coef_spec = P(*s)
        else:
            coef_spec = P()
        self._residual = jax.jit(
            jax.shard_map(
                res_impl,
                mesh=mesh,
                in_specs=(coef_spec, coef_spec, vec, vec, vec, vec),
                out_specs=(vec, vec, P()),
                check_vma=False,
            )
        )

        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        solve_impl = functools.partial(
            _dist_solve_loop,
            limit=limit,
            threshold=float(cfg.threshold),
            res_kwargs=dict(
                offsets=self._fine_offsets,
                axis_name=self.axis_name,
                n_dev=self.n_dev,
                part=self.plan[0],
                exact_terms=self._exact_terms,
            ),
            cycle_kwargs=cycle_kwargs,
            krylov=cfg.krylov or "none",
            krylov_iters=cfg.krylov_iters,
        )
        self._solve_loop = jax.jit(
            jax.shard_map(
                solve_impl,
                mesh=mesh,
                in_specs=(
                    level_specs,
                    P(),
                    coef_spec,
                    coef_spec,
                    vec,
                    vec,
                    vec,
                    vec,
                ),
                out_specs=(vec, vec, P()),
                check_vma=False,
            )
        )

    def _put_vec(self, arr):
        _, vec = self._specs()
        return jax.device_put(arr, NamedSharding(self.mesh, vec))

    def _zeros_vec(self, like):
        """Sharded zeros materialized on device (one tiny dispatch, no
        host upload of a full grid)."""
        if not hasattr(self, "_zeros_prog"):
            _, vec = self._specs()
            self._zeros_prog = jax.jit(
                jnp.zeros_like,
                out_shardings=NamedSharding(self.mesh, vec),
            )
        return self._zeros_prog(like)

    @staticmethod
    def _deliver(x_hi, x_lo, device_native, info):
        """Result delivery mirrors core.solver.Solver._deliver: host-numpy
        callers get the exact float64 merge; device-native (f32 jax-array)
        callers get the f32 hi part on device with the full-precision pair
        in ``info['x_df']`` — no device→host round trip."""
        if device_native:
            info["x_df"] = (x_hi, x_lo)
            return x_hi
        return df_merge((x_hi, x_lo))

    def _batch_sharding(self):
        _, vec = self._specs()
        bspec = P(*((None,) + tuple(vec)))
        return NamedSharding(self.mesh, bspec)

    def _zeros_batch(self, like):
        """Batch-sharded zeros materialized on device (mirrors
        :meth:`_zeros_vec` — no host upload of K grids)."""
        if not hasattr(self, "_zeros_batch_prog"):
            self._zeros_batch_prog = jax.jit(
                jnp.zeros_like, out_shardings=self._batch_sharding()
            )
        return self._zeros_batch_prog(like)

    def solve_many(self, bs, x0s=None):
        """Batch of right-hand sides in ONE vmapped distributed program
        (a cached ``jit(vmap(...))`` over the shard_map solve loop —
        matches scalar distributed solves to fp-reassociation tolerance
        with identical cycle counts; run-to-run bitwise).  Same contract as
        ``core.solver.Solver.solve_many``: lockstep while loop, per-rhs
        cycle counts/histories.  A ``(K, *grid)`` f32 jax-array ``bs``
        (and optionally ``x0s``) takes the device-native path — no host
        ``df_split``, the lo parts and zero guesses are materialized on
        device (mirrors :meth:`solve`); host/numpy input returns stacked
        float64 ``xs``, device-native input returns the f32 hi part with
        the full pair in ``info['x_df']``."""
        cfg = self.config
        shape = self.grid_shape
        sh = self._batch_sharding()
        device_native = isinstance(bs, jax.Array) and bs.dtype == jnp.float32
        if device_native:
            K = int(bs.shape[0])
            b_hi = jax.device_put(bs.reshape((K,) + shape), sh)
            b_lo = self._zeros_batch(b_hi)
            if x0s is None:
                x_hi, x_lo = self._zeros_batch(b_hi), self._zeros_batch(b_hi)
            elif isinstance(x0s, jax.Array) and x0s.dtype == jnp.float32:
                x_hi = jax.device_put(x0s.reshape((K,) + shape), sh)
                x_lo = self._zeros_batch(b_hi)
            else:
                x_hi, x_lo = (
                    jax.device_put(a, sh)
                    for a in df_split(
                        np.stack(
                            [
                                np.asarray(x, dtype=np.float64).reshape(shape)
                                for x in x0s
                            ]
                        )
                    )
                )
        else:
            b_np = np.stack(
                [np.asarray(b, dtype=np.float64).reshape(shape) for b in bs]
            )
            K = b_np.shape[0]
            if x0s is None:
                x0_np = np.zeros_like(b_np)
            else:
                x0_np = np.stack(
                    [np.asarray(x, dtype=np.float64).reshape(shape) for x in x0s]
                )
            b_hi, b_lo = (jax.device_put(a, sh) for a in df_split(b_np))
            x_hi, x_lo = (jax.device_put(a, sh) for a in df_split(x0_np))

        t_start = time.perf_counter()
        # Cached jit(vmap(...)): re-running the batching transform per
        # call re-traces the whole solve (see core.solver.solve_many).
        # The hierarchy arrays are runtime ARGUMENTS (in_axes=None) — a
        # closure would bake them into the lowered module as HLO
        # constants.
        if not hasattr(self, "_solve_many_prog"):
            self._solve_many_prog = jax.jit(
                jax.vmap(
                    lambda ld, ci, fh, fl, bh1, bl1, xh1, xl1:
                    self._solve_loop(ld, ci, fh, fl, bh1, bl1, xh1, xl1),
                    in_axes=(None, None, None, None, 0, 0, 0, 0),
                )
            )
        xh, xl, metas = self._solve_many_prog(
            self.level_data, self.coarse_inv, self.fine_hi, self.fine_lo,
            b_hi, b_lo, x_hi, x_lo,
        )
        from openmg_tpu.utils.observe import unpack_solve_meta

        metas_np = np.asarray(metas)
        solve_time = time.perf_counter() - t_start
        cycles, converged, final_norms, histories = [], [], [], []
        for k in range(K):
            k_fin, hist, done = unpack_solve_meta(metas_np[k])
            cycles.append(max(k_fin - 1, 0))
            converged.append(bool(done))
            final_norms.append(hist[-1] if hist else float("nan"))
            histories.append(hist)
        info = {
            "batch": K,
            "cycles": cycles,
            "converged": converged,
            "final_norm": final_norms,
            "residual_norms": histories,
            "gridlevels": len(self.level_data),
            "level_stats": self.stats,
            "transfer": self.transfer.name,
            "residual_mode": "doublefloat",
            "partition_plan": self.plan,
            "n_devices": self.n_dev,
            "outer_loop": "device",
            "solve_time_s": solve_time,
        }
        if device_native:
            info["x_df"] = (xh, xl)
            return xh, info
        return df_merge((xh, xl)), info

    def solve(
        self,
        b,
        x0=None,
        *,
        checkpoint_path=None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ):
        """Solve ``A x = b`` (same contract as ``core.solver.Solver.solve``
        including checkpoint/resume — SURVEY.md §5.4: with
        ``checkpoint_path``, the full-precision iterate + cycle counter
        are written atomically every ``checkpoint_every`` cycles from the
        host loop; ``resume=True`` restarts from the file, config-hash
        validated)."""
        cfg = self.config
        shape = self.grid_shape

        start_cycle = 0
        preload_history = []
        cfg_hash = None
        if checkpoint_path is not None:
            import os

            from openmg_tpu.utils.checkpoint import (
                config_hash,
                load_checkpoint,
            )

            cfg_hash = config_hash(cfg, shape)
            if resume and os.path.exists(checkpoint_path):
                x0, start_cycle, preload_history = load_checkpoint(
                    checkpoint_path, cfg_hash
                )
                x0 = np.asarray(x0).reshape(shape)

        # Device-resident inputs stay on device (mirrors core.solver):
        # an f32 jax-array rhs splits exactly as (b, 0)
        # with the lo part and the zero initial guess materialized by a
        # tiny jitted program, never transferred from the host.
        device_native = isinstance(b, jax.Array) and b.dtype == jnp.float32
        if device_native:
            b_hi = self._put_vec(b.reshape(shape))
            b_lo = self._zeros_vec(b_hi)
            if x0 is None:
                x_hi, x_lo = self._zeros_vec(b_hi), self._zeros_vec(b_hi)
            elif isinstance(x0, jax.Array) and x0.dtype == jnp.float32:
                x_hi = self._put_vec(x0.reshape(shape))
                x_lo = self._zeros_vec(b_hi)
            else:
                x_hi, x_lo = df_split(
                    np.asarray(x0, dtype=np.float64).reshape(shape)
                )
                x_hi, x_lo = self._put_vec(x_hi), self._put_vec(x_lo)
        else:
            b_np = np.asarray(b, dtype=np.float64).reshape(shape)
            x0_np = (
                np.zeros(shape)
                if x0 is None
                else np.asarray(x0, dtype=np.float64).reshape(shape)
            )
            b_hi, b_lo = df_split(b_np)
            b_hi, b_lo = self._put_vec(b_hi), self._put_vec(b_lo)
            x_hi, x_lo = df_split(x0_np)
            x_hi, x_lo = self._put_vec(x_hi), self._put_vec(x_lo)

        # device-side outer loop (one dispatch per solve); host loop below
        # streams verbose per-cycle norms and writes checkpoints
        if (
            checkpoint_path is None
            and not cfg.verbose
            and cfg.outer_loop != "host"
        ):
            from openmg_tpu.utils.observe import unpack_solve_meta

            t_start = time.perf_counter()
            x_hi, x_lo, meta = self._solve_loop(
                self.level_data,
                self.coarse_inv,
                self.fine_hi,
                self.fine_lo,
                b_hi,
                b_lo,
                x_hi,
                x_lo,
            )
            k_fin, history, done = unpack_solve_meta(meta)
            solve_time = time.perf_counter() - t_start
            n_cycles = max(k_fin - 1, 0)
            info = {
                "residual_norms": history,
                "cycles": n_cycles,
                "converged": bool(done),
                "final_norm": history[-1] if history else float("nan"),
                "gridlevels": len(self.level_data),
                "level_stats": self.stats,
                "transfer": self.transfer.name,
                "residual_mode": "doublefloat",
                "partition_plan": self.plan,
                "n_devices": self.n_dev,
                "cycle_times_s": [],
                "mean_cycle_time_s": solve_time / max(n_cycles, 1),
                "outer_loop": "device",
                "solve_time_s": solve_time,
            }
            return self._deliver(x_hi, x_lo, device_native, info), info

        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        history, cycle_times = list(preload_history), []
        converged = False
        t_start = time.perf_counter()
        for k in range(start_cycle, limit + 1):
            r_hi, r_lo, rnorm = self._residual(
                self.fine_hi, self.fine_lo, b_hi, b_lo, x_hi, x_lo
            )
            rnorm = float(rnorm)
            history.append(rnorm)
            if cfg.verbose:
                print(f"[openmg_tpu/dist] cycle {k}: ‖r‖ = {rnorm:.3e}")
            if rnorm < cfg.threshold:
                converged = True
                break
            if k == limit:
                break
            t0 = time.perf_counter()
            e = self._cycle(self.level_data, self.coarse_inv, r_hi)
            x_hi, x_lo = df_add_f32((x_hi, x_lo), e)
            x_hi.block_until_ready()
            cycle_times.append(time.perf_counter() - t0)
            if checkpoint_path is not None and (k + 1) % checkpoint_every == 0:
                from openmg_tpu.utils.checkpoint import save_checkpoint

                save_checkpoint(
                    checkpoint_path,
                    df_merge((x_hi, x_lo)),
                    k + 1,
                    history,
                    cfg_hash,
                )

        info = {
            "residual_norms": history,
            "cycles": len(history) - 1,
            "converged": converged,
            "final_norm": history[-1],
            "gridlevels": len(self.level_data),
            "level_stats": self.stats,
            "transfer": self.transfer.name,
            "residual_mode": "doublefloat",
            "partition_plan": self.plan,
            "n_devices": self.n_dev,
            "cycle_times_s": cycle_times,
            "mean_cycle_time_s": (
                float(np.mean(cycle_times[1:] or cycle_times))
                if cycle_times
                else float("nan")
            ),
            "outer_loop": "host",
            "solve_time_s": time.perf_counter() - t_start,
        }
        return self._deliver(x_hi, x_lo, device_native, info), info


def distributed_setup(
    problem,
    config: SolverConfig | None = None,
    mesh_config: MeshConfig | None = None,
) -> DistributedSolver:
    """Build a :class:`DistributedSolver` (native API, multi-device)."""
    from openmg_tpu.core.solver import setup

    import dataclasses

    config = config or SolverConfig(residual_dtype="doublefloat")
    if config.residual_dtype != "doublefloat":
        config = dataclasses.replace(config, residual_dtype="doublefloat")
    # faced=True: cornered exact-Galerkin levels distribute natively as
    # O(K) replicated tables (parallel/fast.py) — the same representations
    # as the single-device solver
    base = setup(problem, config, faced=True)
    return DistributedSolver(base.hierarchy, config, mesh_config)
