"""Distributed general-sparse multigrid: banded ELL levels row-partitioned
over the device mesh (SURVEY.md §2B T9/T10/T11 extended to the algebraic
engine — closes the one engine/parallelism asymmetry the stencil tier left:
``core.algebraic`` problems were single-device only).

Scope and design
----------------

The general engine's input domain is *arbitrary* sparse SPD matrices over a
``problemshape`` grid.  Distribution requires structure: a contiguous
row-partition only has local SpMVs when every matrix row reaches a bounded
distance across the partition boundary.  The structure this module keys on
is exactly the one the single-device banded SpMV keys on
(:mod:`openmg_tpu.ops.ell`): **slot-offset-regular (banded) ELL** — every
slot ``j`` satisfies ``cols[j, i] == i + d_j`` wherever ``data != 0``
(:class:`openmg_tpu.ops.sparse.ELLMatrix` invariant).  Then the local SpMV
on a block of ``m`` rows is gather-free given halo slabs of
``H = max|d_j|`` rows from each ring neighbor:

    ``y[i] = Σ_j data[j, i] · xe[i + d_j + H]``,  ``xe = [lo | x | hi]``

— per-slot *static* shifted slices of the extended segment (the flat-vector
analog of the stencil tier's shifted halo-extended planes,
:mod:`openmg_tpu.parallel.halo`).  The Poisson/diffusion family, 1D/2D/3D
grid operators under flat indexing, and any band matrix all qualify; their
Galerkin coarsenings (R·A·P of banded with geometric taps) stay banded, so
whole hierarchies partition.  Matrices with **irregular** sparsity
partition on the *gathered-x tier* (VERDICT r4 task 7): rows/data/cols
shard contiguously and every SpMV all-gathers the source vector first —
the same collective the transfers already pay.  Cost note: the gather
moves the full vector per SpMV application (per color for multicolor GS),
so the tier saves compute (k·m vs k·n MACs per device) but not smoother
bandwidth; it exists for capability-surface completeness and for
hierarchies whose fine level is banded but whose Galerkin levels go
irregular — the per-level plan mixes tiers freely.

Per level, the partition plan mirrors the stencil tier
(:func:`openmg_tpu.parallel.dist.partition_plan`): a level is partitioned
iff its operator is banded, its row count divides the mesh, and the local
block is at least ``max(H, min_rows_per_device)`` rows; everything else —
always including the coarsest level, whose dense solve wants the full
vector — runs replicated (redundant identical compute on every device, the
standard coarse-grid policy; T11).

Transfers are the *general* rectangular ELL matrices built at setup (their
columns are arbitrary, not banded), so transfer applications go through a
full source vector: ``all_gather`` the partitioned source (tiled, one
collective), then each device computes exactly its destination rows from
its row-block of R/P (sharded slot-major planes).  Smoothing and residuals
— the per-sweep hot loop — stay halo-local; only the two transfer
applications per level per cycle pay a gather, the same trade the stencil
tier makes at its partitioned→replicated transition.

The whole solve (defect-correction outer loop in double-float, V/W/FMG
cycles, convergence test, residual history) is ONE ``shard_map``-ped jitted
program per hierarchy — no host round-trips per cycle — with ``psum``
residual norms, mirroring :func:`openmg_tpu.parallel.dist._dist_solve_loop`.
Both the 1D mesh and the 2-axis ``(host, chip)`` mesh are supported, and
``MeshConfig(force_partition=True)`` compiles the exact per-device
multi-device program on one device (halo slabs degenerate to zeros,
gathers to identity) for validation, as in the stencil tier.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from openmg_tpu.core.algebraic import SparseHierarchy
from openmg_tpu.core.config import MeshConfig, SolverConfig
from openmg_tpu.ops.doublefloat import (
    df_add_f32,
    df_merge,
    df_mul,
    df_split,
    df_sub,
)
from openmg_tpu.ops.sparse import ELLMatrix, dense_matvec
from openmg_tpu.parallel.halo import halo_slabs
from openmg_tpu.parallel.mesh import make_mesh, make_mesh_2d

__all__ = [
    "sparse_partition_plan",
    "DistributedAlgebraicSolver",
    "setup_sparse_distributed",
]


# ---------------------------------------------------------------------------
# partition plan
# ---------------------------------------------------------------------------


def _band_halo(offsets) -> int:
    return max((abs(int(d)) for d in offsets), default=0)


def sparse_partition_plan(
    hierarchy: SparseHierarchy,
    n_dev: int,
    min_rows_per_device: int = 2,
    force: bool = False,
) -> tuple:
    """Which levels run row-partitioned (True) vs replicated (False).

    A banded level (``slot_offsets`` set) partitions iff its row count
    divides ``n_dev`` and the local block holds at least
    ``max(H, min_rows_per_device)`` rows so the halo slab fits in one
    ring hop.  An **irregular** ELL level (no slot offsets) partitions on
    the gathered-x tier (VERDICT r4 task 7): rows/data/cols shard, and
    each SpMV all-gathers the source vector first — the same collective
    the transfers already pay, so the smoother's marginal cost is the
    per-application gather (see the module docstring's cost note).  The
    coarsest level is always replicated (dense solve).  ``force=True``
    (``MeshConfig.force_partition``) keeps levels partitioned on a
    1-device mesh — the one-device validation mode of the stencil tier
    (core/config.py).
    """
    L = hierarchy.num_levels
    plan = []
    for i, l in enumerate(hierarchy.levels):
        ok = (
            (n_dev > 1 or force)
            and i < L - 1
            and isinstance(l.A, ELLMatrix)
            and l.n % n_dev == 0
        )
        if ok:
            m = l.n // n_dev
            if l.A.slot_offsets is not None:
                H = _band_halo(l.A.slot_offsets)
                ok = m >= max(H, min_rows_per_device, 1)
            else:
                ok = m >= max(min_rows_per_device, 1)
        if ok and i == 0:
            # the outer double-float residual runs on the fine operator's
            # own (full-precision-split) ELL: banded needs a halo that
            # fits the local block; irregular takes the gathered path
            fh = hierarchy.fine_hi
            if fh.slot_offsets is not None:
                ok = l.n // n_dev >= _band_halo(fh.slot_offsets)
        plan.append(bool(ok))
    return tuple(plan)


# ---------------------------------------------------------------------------
# local ops (run inside shard_map)
# ---------------------------------------------------------------------------


def _extend(x, H: int, axis_name, n_dev: int):
    """``[lo | x | hi]`` with ``H``-row halo slabs from the ring neighbors
    (zeros at the global domain edges — banded edge rows carry zero pads
    in the out-of-range slots, so the truncation is exact)."""
    if H == 0:
        return x
    lo, hi = halo_slabs(x, axis_name, n_dev, H)
    return jnp.concatenate([lo, x, hi])


def _spmv_banded_local(data, offsets, H: int, x, axis_name, n_dev: int):
    """Gather-free local SpMV of a banded level: per-slot static shifted
    slices of the halo-extended segment."""
    xe = _extend(x, H, axis_name, n_dev)
    m = x.shape[0]
    acc = None
    for j, d in enumerate(offsets):
        t = data[j] * lax.slice_in_dim(xe, H + int(d), H + int(d) + m)
        acc = t if acc is None else acc + t
    return acc


def _spmv_banded_full(data, offsets, H: int, x):
    """Gather-free SpMV of a banded REPLICATED level: zero-pad instead of
    halo exchange (every device holds the full vector — a ring exchange
    would splice in the wrong rows); banded levels never gather."""
    from openmg_tpu.ops.ell import spmv_banded_jnp

    return spmv_banded_jnp(data, offsets, x)


def _spmv_gather(data, cols, x_full):
    """Row-block (or full replicated) ELL SpMV against a FULL source
    vector — the transfer/irregular-level path (columns arbitrary)."""
    return jnp.sum(data * x_full[cols], axis=0)


def _gather_full(v, part: bool, axis_name, n_dev: int):
    if part and n_dev > 1:
        return lax.all_gather(v, axis_name, axis=0, tiled=True)
    return v


def _smooth_gen(Ax, invd, colors, num_colors, lam, b, x, iters, smoother,
                omega):
    """Smoothing on one level, layout-agnostic (``Ax`` closes over the
    partitioned-banded or replicated-gather SpMV).  Mirrors
    ``core.algebraic._smooth_sparse`` exactly — multicolor GS re-applies
    ``Ax`` per color, so partitioned runs re-exchange halos per color and
    match the single-device trajectory to fp reassociation."""
    if iters <= 0:
        return x
    if smoother == "chebyshev":
        r = b - Ax(x)
        d = (4.0 / 3.0) / lam * invd * r
        for k in range(1, iters + 1):
            x = x + d
            if k == iters:
                break
            r = r - Ax(d)
            d = ((2 * k - 1) / (2 * k + 3)) * d + (
                (8 * k + 4) / (2 * k + 3)
            ) / lam * invd * r
        return x
    if smoother == "jacobi" or colors is None:
        om = jnp.asarray(omega, dtype=x.dtype)
        for _ in range(iters):
            x = x + om * invd * (b - Ax(x))
        return x
    for _ in range(iters):
        for c in range(num_colors):
            upd = x + invd * (b - Ax(x))
            x = jnp.where(colors == c, upd, x)
    return x


# ---------------------------------------------------------------------------
# the distributed cycle (per-device body under shard_map)
# ---------------------------------------------------------------------------


def _sdist_cycle(
    level_data,
    coarse_inv,
    r,
    *,
    plan,
    offsets,
    halos,
    num_colors,
    nlevels,
    pre,
    post,
    smoother,
    omega,
    gamma,
    fmg,
    axis_name,
    n_dev,
    geoms=None,
):
    """One V/W/FMG cycle; vectors at level ``i`` are local ``(m,)`` blocks
    when ``plan[i]`` else full replicated ``(n,)``.  Unrolls at trace time
    over the static level tuple (T7)."""

    def Ax_at(i):
        ld = level_data[i]
        if plan[i]:
            if offsets[i] is not None:
                return lambda v: _spmv_banded_local(
                    ld["data"], offsets[i], halos[i], v, axis_name, n_dev
                )
            # gathered-x tier: irregular partitioned level — local rows
            # of data/cols against the all-gathered source vector
            return lambda v: _spmv_gather(
                ld["data"], ld["cols"],
                _gather_full(v, True, axis_name, n_dev),
            )
        if offsets[i] is not None:
            return lambda v: _spmv_banded_full(
                ld["data"], offsets[i], halos[i], v
            )
        return lambda v: _spmv_gather(ld["data"], ld["cols"], v)

    def smooth_at(i, b, x, iters):
        ld = level_data[i]
        return _smooth_gen(
            Ax_at(i),
            ld["invd"],
            ld.get("colors"),
            num_colors[i],
            ld.get("lam"),
            b,
            x,
            iters,
            smoother,
            omega,
        )

    def _local_rows(v_full, part_dest: bool):
        """Slice this device's contiguous row block out of a full vector
        (identity for replicated destinations or 1-device meshes)."""
        if not part_dest or n_dev == 1:
            return v_full
        m = v_full.shape[0] // n_dev
        idx = lax.axis_index(axis_name)
        return lax.dynamic_slice_in_dim(v_full, idx * m, m)

    def restrict_at(i, rr):
        ld = level_data[i]
        r_full = _gather_full(rr, plan[i], axis_name, n_dev)
        if geoms is not None and geoms[i] is not None:
            # separable strided grid transfer (gather-free; same values
            # as the explicit matrix — core.algebraic._restrict_level)
            from openmg_tpu.ops.transfer import restrict

            fs, cs, transfer = geoms[i]
            bc_full = restrict(r_full.reshape(fs), transfer).reshape(-1)
            return _local_rows(bc_full, plan[i + 1])
        return _spmv_gather(ld["Rd"], ld["Rc"], r_full)

    def prolong_at(i, ec):
        ld = level_data[i]
        e_full = _gather_full(ec, plan[i + 1], axis_name, n_dev)
        if geoms is not None and geoms[i] is not None:
            from openmg_tpu.ops.transfer import prolong

            fs, cs, transfer = geoms[i]
            xf_full = prolong(e_full.reshape(cs), fs, transfer).reshape(-1)
            return _local_rows(xf_full, plan[i])
        return _spmv_gather(ld["Pd"], ld["Pc"], e_full)

    def vc(i, b, x):
        if i == nlevels - 1:
            return dense_matvec(coarse_inv, b)  # coarsest always replicated
        x = smooth_at(i, b, x, pre)
        rr = b - Ax_at(i)(x)
        bc = restrict_at(i, rr)
        ec = jnp.zeros_like(bc)
        visits = 1 if i == nlevels - 2 else gamma
        for _ in range(visits):
            ec = vc(i + 1, bc, ec)
        x = x + prolong_at(i, ec)
        return smooth_at(i, b, x, post)

    if fmg:
        bs = [r]
        for i in range(nlevels - 1):
            bs.append(restrict_at(i, bs[-1]))
        x = dense_matvec(coarse_inv, bs[-1])
        for i in range(nlevels - 2, -1, -1):
            x = prolong_at(i, x)
            x = vc(i, bs[i], x)
        return x
    return vc(0, r, jnp.zeros_like(r))


def _sdist_pcg(level_data, coarse_inv, r0, *, iters, cycle_kwargs):
    """Distributed MG-preconditioned CG on the general-sparse engine —
    mirrors ``parallel.dist._dist_pcg``: one cycle + one fine-level SpMV
    per step, inner products psum'd across the row partition."""
    plan = cycle_kwargs["plan"]
    offsets = cycle_kwargs["offsets"]
    halos = cycle_kwargs["halos"]
    axis_name = cycle_kwargs["axis_name"]
    n_dev = cycle_kwargs["n_dev"]
    ld = level_data[0]

    def apply_A(v):
        if plan[0]:
            if offsets[0] is not None:
                return _spmv_banded_local(
                    ld["data"], offsets[0], halos[0], v, axis_name, n_dev
                )
            return _spmv_gather(
                ld["data"], ld["cols"],
                _gather_full(v, True, axis_name, n_dev),
            )
        if offsets[0] is not None:
            return _spmv_banded_full(ld["data"], offsets[0], halos[0], v)
        return _spmv_gather(ld["data"], ld["cols"], v)

    def pdot(a, b):
        s = jnp.sum(a * b)
        if plan[0] and n_dev > 1:
            s = lax.psum(s, axis_name)
        return s

    def precond(rr):
        return _sdist_cycle(level_data, coarse_inv, rr, **cycle_kwargs)

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


def _sdist_error_solve(
    level_data, coarse_inv, r, *, krylov, krylov_iters, cycle_kwargs
):
    if krylov == "pcg":
        return _sdist_pcg(
            level_data, coarse_inv, r,
            iters=krylov_iters, cycle_kwargs=cycle_kwargs,
        )
    return _sdist_cycle(level_data, coarse_inv, r, **cycle_kwargs)


def _sdist_residual_df(
    fine, b_hi, b_lo, x_hi, x_lo, *, offsets, H, part, axis_name, n_dev
):
    """Outer double-float residual ``b − A x`` on the fine level's
    full-precision two-f32 split operator, plus its psum'd norm (mirrors
    ``parallel.dist._dist_residual_df`` / ``ops.sparse.spmv_df``)."""
    fh, fl = fine["hi"], fine["lo"]
    acc = (b_hi, b_lo)
    if offsets:
        if part:
            xe_h = _extend(x_hi, H, axis_name, n_dev)
            xe_l = _extend(x_lo, H, axis_name, n_dev)
        else:  # banded but replicated: zero-pad, never gather (see
            # _spmv_banded_full)
            xe_h = jnp.pad(x_hi, (H, H)) if H else x_hi
            xe_l = jnp.pad(x_lo, (H, H)) if H else x_lo
        m = x_hi.shape[0]
        for j, d in enumerate(offsets):
            xs = (
                lax.slice_in_dim(xe_h, H + int(d), H + int(d) + m),
                lax.slice_in_dim(xe_l, H + int(d), H + int(d) + m),
            )
            acc = df_sub(acc, df_mul((fh[j], fl[j]), xs))
    else:
        # irregular: gathered-x tier when partitioned (fine["cols"] holds
        # this device's rows with global column ids), plain when full
        cols = fine["cols"]
        xh_full = _gather_full(x_hi, part, axis_name, n_dev)
        xl_full = _gather_full(x_lo, part, axis_name, n_dev)
        for j in range(fh.shape[0]):
            c = cols[j]
            acc = df_sub(acc, df_mul((fh[j], fl[j]), (xh_full[c], xl_full[c])))
    nsq = jnp.sum(acc[0] * acc[0])
    if n_dev > 1:
        nsq = lax.psum(nsq, axis_name)
    return acc[0], acc[1], jnp.sqrt(nsq)


def _sdist_solve_loop(
    level_data,
    coarse_inv,
    fine,
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
    """Whole-solve per-device body: df residuals, distributed cycles, the
    convergence check and history in ONE ``lax.while_loop`` program (no
    host round-trip per cycle — cf. ``parallel.dist._dist_solve_loop``).
    ``k``/``hist``/``done`` derive from the psum-replicated norm, hence
    identical on every device."""
    hist0 = jnp.full((limit + 1,), -1.0, dtype=jnp.float32)

    def cond_fn(st):
        _, _, k, _, done = st
        return jnp.logical_and(jnp.logical_not(done), k <= limit)

    def body_fn(st):
        xh, xl, k, hist, _ = st
        r_hi, _, rn = _sdist_residual_df(
            fine, b_hi, b_lo, xh, xl, **res_kwargs
        )
        hist = hist.at[k].set(rn.astype(jnp.float32))
        done = rn < threshold
        do_cycle = jnp.logical_and(jnp.logical_not(done), k < limit)

        def run(ops):
            xh_, xl_, r_ = ops
            e = _sdist_error_solve(
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


class DistributedAlgebraicSolver:
    """Multi-device general-sparse solver: same contract as
    :class:`openmg_tpu.core.algebraic.AlgebraicSolver`, with banded levels
    row-partitioned over the mesh (see module docstring for the plan).

    Requirements (validated at construction): ``fmt == "ell"`` hierarchy,
    ``residual_dtype='doublefloat'`` (the distributed 1e-10 mode), and a
    banded fine level that divides the mesh.  ``krylov='pcg'`` runs
    distributed MG-preconditioned CG (psum inner products).
    """

    def __init__(
        self,
        hierarchy: SparseHierarchy,
        config: SolverConfig,
        mesh_config: MeshConfig | None = None,
    ):
        if hierarchy.fmt != "ell":
            raise ValueError(
                f"format={hierarchy.fmt!r}: the distributed general-sparse "
                "engine runs on ELL hierarchies (banded slot-offset "
                "partitioning); build with format='ell' or solve "
                "single-device"
            )
        if hierarchy.fine_lo is None:
            raise ValueError(
                "distributed solver requires residual_dtype='doublefloat'"
            )
        if config.krylov not in (None, "none", "pcg"):
            raise ValueError(
                f"unknown krylov {config.krylov!r}; choose none|pcg"
            )
        if config.cycle_type not in ("v", "w", "f"):
            raise ValueError(
                f"unknown cycle_type {config.cycle_type!r}; choose v|w|f"
            )
        if config.smoother not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(f"unknown smoother {config.smoother!r}")
        self.hierarchy = hierarchy
        self.config = config
        self.mesh_config = mesh_config or MeshConfig()
        if self.mesh_config.mesh_shape is not None:
            self.mesh = make_mesh_2d(
                self.mesh_config.mesh_shape, self.mesh_config.axis_names
            )
            self.axis_name = tuple(self.mesh_config.axis_names)
        else:
            self.mesh = make_mesh(
                self.mesh_config.n_devices, self.mesh_config.axis_name
            )
            self.axis_name = self.mesh_config.axis_name
        self.n_dev = int(self.mesh.devices.size)
        self.plan = sparse_partition_plan(
            hierarchy,
            self.n_dev,
            self.mesh_config.min_rows_per_device,
            force=self.mesh_config.force_partition,
        )
        if not self.plan[0] and self.n_dev > 1:
            l0 = hierarchy.levels[0]
            raise ValueError(
                f"finest level cannot be row-partitioned: {l0.n} rows do "
                f"not split over {self.n_dev} devices with >= "
                f"max(halo, {self.mesh_config.min_rows_per_device}) "
                "rows/device; solve single-device (core.algebraic) instead"
            )
        self.n = hierarchy.n
        L = hierarchy.num_levels
        # offsets recorded for EVERY banded level (not just partitioned
        # ones): replicated banded levels take the gather-free padded
        # formula (_spmv_banded_full) — XLA's gather must never run on a
        # banded level
        self.offsets_per_level = tuple(
            (
                tuple(int(d) for d in l.A.slot_offsets)
                if isinstance(l.A, ELLMatrix)
                and l.A.slot_offsets is not None
                else None
            )
            for l in hierarchy.levels
        )
        self.halos_per_level = tuple(
            _band_halo(o) if o is not None else 0
            for o in self.offsets_per_level
        )
        self.num_colors = tuple(l.num_colors for l in hierarchy.levels)
        # factor-2 level pairs run the separable strided grid transfers
        # (no explicit R/P on device); irregular pairs keep the ELL SpMV
        self._geoms = tuple(
            hierarchy.geom_transfer(i) for i in range(L - 1)
        )
        self.fine_offsets = tuple(
            int(d) for d in hierarchy.fine_hi.slot_offsets or ()
        )
        self.fine_halo = _band_halo(self.fine_offsets)
        self.stats = hierarchy.stats

        # ---- shard the hierarchy per the plan -------------------------
        ax = self.axis_name

        def put(arr, spec):
            return jax.device_put(arr, NamedSharding(self.mesh, spec))

        smoother = config.smoother
        level_data, level_specs = [], []
        for i, l in enumerate(hierarchy.levels):
            d, s = {}, {}
            if self.plan[i]:
                # slot planes sharded along rows; banded levels carry no
                # cols on device, irregular (gathered-x tier) shard their
                # global-id cols alongside the data
                d["data"], s["data"] = put(l.A.data, P(None, ax)), P(None, ax)
                if self.offsets_per_level[i] is None:
                    d["cols"], s["cols"] = (
                        put(l.A.cols, P(None, ax)), P(None, ax)
                    )
                d["invd"], s["invd"] = put(l.inv_diag, P(ax)), P(ax)
                if smoother == "rbgs" and l.colors is not None:
                    d["colors"], s["colors"] = put(l.colors, P(ax)), P(ax)
            else:
                d["data"], s["data"] = put(l.A.data, P()), P()
                if self.offsets_per_level[i] is None:
                    d["cols"], s["cols"] = put(l.A.cols, P()), P()
                d["invd"], s["invd"] = put(l.inv_diag, P()), P()
                if smoother == "rbgs" and l.colors is not None:
                    d["colors"], s["colors"] = put(l.colors, P()), P()
            if smoother == "chebyshev":
                d["lam"], s["lam"] = put(l.lam_max, P()), P()
            if i < L - 1 and self._geoms[i] is None:
                # explicit transfer matrices only for non-factor-2 pairs:
                # R rows = coarse rows (dest layout plan[i+1]); P rows =
                # fine rows (dest layout plan[i]); cols stay global — the
                # source vector is always FULL at application time
                rs = P(None, ax) if self.plan[i + 1] else P()
                ps = P(None, ax) if self.plan[i] else P()
                d["Rd"], s["Rd"] = put(l.R.data, rs), rs
                d["Rc"], s["Rc"] = put(l.R.cols, rs), rs
                d["Pd"], s["Pd"] = put(l.P.data, ps), ps
                d["Pc"], s["Pc"] = put(l.P.cols, ps), ps
            level_data.append(d)
            level_specs.append(s)
        self.level_data = tuple(level_data)
        self._level_specs = tuple(level_specs)
        self.coarse_inv = put(hierarchy.coarse_inv, P())

        fspec = P(None, ax) if self.plan[0] else P()
        fine, fs = {}, {}
        fine["hi"], fs["hi"] = put(hierarchy.fine_hi.data, fspec), fspec
        fine["lo"], fs["lo"] = put(hierarchy.fine_lo.data, fspec), fspec
        if not self.fine_offsets:
            cspec = P(None, ax) if self.plan[0] else P()
            fine["cols"], fs["cols"] = (
                put(hierarchy.fine_hi.cols, cspec), cspec
            )
        self.fine = fine
        self._fine_spec = fs
        self._vec_spec = P(ax) if self.plan[0] else P()

        self._build_program()

    # ---- programs ----------------------------------------------------

    def _build_program(self):
        cfg = self.config
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        cycle_kwargs = dict(
            plan=self.plan,
            offsets=self.offsets_per_level,
            halos=self.halos_per_level,
            num_colors=self.num_colors,
            nlevels=self.hierarchy.num_levels,
            pre=cfg.pre_iterations,
            post=cfg.post_iterations,
            smoother=cfg.smoother,
            omega=cfg.omega,
            gamma={"v": 1, "w": 2, "f": 1}[cfg.cycle_type],
            fmg=cfg.cycle_type == "f",
            axis_name=self.axis_name,
            n_dev=self.n_dev,
            geoms=self._geoms,
        )
        res_kwargs = dict(
            offsets=self.fine_offsets,
            H=self.fine_halo,
            part=self.plan[0],
            axis_name=self.axis_name,
            n_dev=self.n_dev,
        )
        solve_impl = functools.partial(
            _sdist_solve_loop,
            limit=limit,
            threshold=float(cfg.threshold),
            res_kwargs=res_kwargs,
            cycle_kwargs=cycle_kwargs,
            krylov=cfg.krylov or "none",
            krylov_iters=cfg.krylov_iters,
        )
        vec = self._vec_spec
        self._solve_loop = jax.jit(
            jax.shard_map(
                solve_impl,
                mesh=self.mesh,
                in_specs=(
                    self._level_specs,
                    P(),
                    self._fine_spec,
                    vec,
                    vec,
                    vec,
                    vec,
                ),
                out_specs=(vec, vec, P()),
                check_vma=False,
            )
        )

    def _vec_sharding(self):
        return NamedSharding(self.mesh, self._vec_spec)

    def _zeros_vec(self, like):
        """Sharded zeros materialized on device (one tiny dispatch, no
        host upload)."""
        if not hasattr(self, "_zeros_prog"):
            self._zeros_prog = jax.jit(
                jnp.zeros_like, out_shardings=self._vec_sharding()
            )
        return self._zeros_prog(like)

    def _batch_sharding(self):
        spec = P(None, self.axis_name) if self.plan[0] else P()
        return NamedSharding(self.mesh, spec)

    # ---- solves ------------------------------------------------------

    def _info(self, k_fin, history, done, solve_time):
        h = self.hierarchy
        n_cycles = max(k_fin - 1, 0)
        return {
            "residual_norms": history,
            "cycles": n_cycles,
            "converged": bool(done),
            "final_norm": history[-1] if history else float("nan"),
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "format": h.fmt,
            "residual_mode": "doublefloat",
            "num_colors": self.num_colors,
            "cycle_times_s": [],
            "mean_cycle_time_s": solve_time / max(n_cycles, 1),
            "outer_loop": "device",
            "solve_time_s": solve_time,
            "n_devices": self.n_dev,
            "partition_plan": self.plan,
            "band_halos": self.halos_per_level,
        }

    def solve(self, b, x0=None):
        """Same contract as ``AlgebraicSolver.solve``.  A flat f32
        jax-array ``b`` (and optionally ``x0``) takes the device-native
        path — no host df_split, lo parts materialized on device; the
        result is then the f32 hi part with the full pair in
        ``info['x_df']``.  Host/numpy input returns the exact float64
        merge."""
        sh = self._vec_sharding()
        device_native = isinstance(b, jax.Array) and b.dtype == jnp.float32
        if device_native:
            b_hi = jax.device_put(b.reshape(-1), sh)
            b_lo = self._zeros_vec(b_hi)
            if x0 is None:
                x_hi, x_lo = self._zeros_vec(b_hi), self._zeros_vec(b_hi)
            elif isinstance(x0, jax.Array) and x0.dtype == jnp.float32:
                x_hi = jax.device_put(x0.reshape(-1), sh)
                x_lo = self._zeros_vec(b_hi)
            else:
                x_hi, x_lo = (
                    jax.device_put(a, sh)
                    for a in df_split(
                        np.asarray(x0, dtype=np.float64).reshape(-1)
                    )
                )
        else:
            b_np = np.asarray(b, dtype=np.float64).reshape(-1)
            x0_np = (
                np.zeros(self.n)
                if x0 is None
                else np.asarray(x0, dtype=np.float64).reshape(-1)
            )
            b_hi, b_lo = (jax.device_put(a, sh) for a in df_split(b_np))
            x_hi, x_lo = (jax.device_put(a, sh) for a in df_split(x0_np))

        from openmg_tpu.utils.observe import unpack_solve_meta

        t_start = time.perf_counter()
        xh, xl, meta = self._solve_loop(
            self.level_data, self.coarse_inv, self.fine,
            b_hi, b_lo, x_hi, x_lo,
        )
        k_fin, history, done = unpack_solve_meta(np.asarray(meta))
        solve_time = time.perf_counter() - t_start
        info = self._info(k_fin, history, done, solve_time)
        if device_native:
            info["x_df"] = (xh, xl)
            return xh, info
        return df_merge((xh, xl)), info

    def solve_many(self, bs, x0s=None):
        """Batch of right-hand sides in ONE cached ``jit(vmap(...))`` over
        the shard_map solve loop (same contract as
        ``AlgebraicSolver.solve_many``; hierarchy arrays are runtime
        arguments with ``in_axes=None``, never closures)."""
        sh = self._batch_sharding()
        device_native = isinstance(bs, jax.Array) and bs.dtype == jnp.float32
        if device_native:
            K = int(bs.shape[0])
            b_hi = jax.device_put(bs.reshape(K, -1), sh)
            b_lo = jnp.zeros_like(b_hi)
            if x0s is None:
                x_hi, x_lo = jnp.zeros_like(b_hi), jnp.zeros_like(b_hi)
            elif isinstance(x0s, jax.Array) and x0s.dtype == jnp.float32:
                x_hi = jax.device_put(x0s.reshape(K, -1), sh)
                x_lo = jnp.zeros_like(b_hi)
            else:
                # mixed case (host/f64 x0s with a device f32 batch):
                # df-split on host like AlgebraicSolver.solve_many does —
                # a raw .reshape on a list raises, and f64 jax x0s would
                # push an f64 x_hi into the f32 shard_map program.
                x0_np = np.stack(
                    [np.asarray(x, dtype=np.float64).reshape(-1) for x in x0s]
                )
                xh_np, xl_np = df_split(x0_np)
                x_hi = jax.device_put(xh_np, sh)
                x_lo = jax.device_put(xl_np, sh)
        else:
            b_np = np.stack(
                [np.asarray(b, dtype=np.float64).reshape(-1) for b in bs]
            )
            K = b_np.shape[0]
            x0_np = (
                np.zeros_like(b_np)
                if x0s is None
                else np.stack(
                    [np.asarray(x, dtype=np.float64).reshape(-1) for x in x0s]
                )
            )
            b_hi, b_lo = (jax.device_put(a, sh) for a in df_split(b_np))
            x_hi, x_lo = (jax.device_put(a, sh) for a in df_split(x0_np))

        t_start = time.perf_counter()
        if not hasattr(self, "_solve_many_prog"):
            self._solve_many_prog = jax.jit(
                jax.vmap(
                    lambda ld, ci, fn, bh1, bl1, xh1, xl1: self._solve_loop(
                        ld, ci, fn, bh1, bl1, xh1, xl1
                    ),
                    in_axes=(None, None, None, 0, 0, 0, 0),
                )
            )
        xh, xl, metas = self._solve_many_prog(
            self.level_data, self.coarse_inv, self.fine,
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
            "gridlevels": self.hierarchy.num_levels,
            "level_stats": self.stats,
            "format": self.hierarchy.fmt,
            "residual_mode": "doublefloat",
            "outer_loop": "device",
            "solve_time_s": solve_time,
            "n_devices": self.n_dev,
            "partition_plan": self.plan,
        }
        if device_native:
            info["x_df"] = (xh, xl)
            return xh, info
        return df_merge((xh, xl)), info


def setup_sparse_distributed(
    A,
    shape,
    config: SolverConfig | None = None,
    mesh_config: MeshConfig | None = None,
) -> DistributedAlgebraicSolver:
    """Build a :class:`DistributedAlgebraicSolver` for a banded sparse SPD
    ``A`` over the grid ``shape`` (the distributed analog of
    :func:`openmg_tpu.core.algebraic.setup_sparse`)."""
    from openmg_tpu.core.algebraic import build_sparse_hierarchy

    config = config or SolverConfig()
    hierarchy = build_sparse_hierarchy(
        A,
        shape,
        gridlevels=config.gridlevels,
        fmt="ell",
        transfer_name=config.transfer,
        dtype=np.dtype(config.dtype),
        residual_dtype="doublefloat",
        max_dense_coarse=config.max_dense_coarse,
        smoother=config.smoother,
    )
    return DistributedAlgebraicSolver(hierarchy, config, mesh_config)
