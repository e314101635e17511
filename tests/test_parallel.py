"""Distributed layer on the 8-fake-CPU-device mesh (SURVEY.md §4.2-3):
halo exchange, partition plan, and partitioned-vs-single-device parity
(T9/T10/T11/T16)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from openmg_tpu import SolverConfig, setup
from openmg_tpu.core.config import MeshConfig
from openmg_tpu.models.poisson import poisson_stencil, rhs_random
from openmg_tpu.ops.stencil import StencilOperator, apply, shift
from openmg_tpu.parallel.dist import DistributedSolver, distributed_setup, partition_plan
from openmg_tpu.parallel.halo import (
    apply_ext,
    apply_overlapped,
    halo_exchange,
    halo_planes,
)
from openmg_tpu.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (fake) devices"
)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_partition_plan():
    shapes = [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    plan = partition_plan(shapes, 8, min_rows_per_device=2)
    # 64/8=8 even ✓; 32/8=4 even ✓; 16/8=2 even ✓; 8/8=1 < 2 ✗; coarsest ✗
    assert plan == (True, True, True, False, False)
    assert partition_plan(shapes, 1) == (False,) * 5
    # once replicated, stays replicated
    plan2 = partition_plan([(8, 8), (64, 64), (32, 32)], 8)
    assert plan2 == (False, False, False)
    # force: 1-device mesh still marks levels partitioned (per-device
    # partitioned-program check; the coarsest stays replicated)
    assert partition_plan(shapes, 1, force=True) == (
        True, True, True, True, False
    )


def test_halo_exchange_matches_global_stencil():
    """shard_map halo SpMV == single-device SpMV, elementwise-identical."""
    shape = (32, 16)
    offsets, coeffs = poisson_stencil(shape, dtype=np.float32)
    x = rhs_random(shape, seed=0).astype(np.float32)
    op = StencilOperator(jnp.asarray(coeffs), offsets)
    expected = np.asarray(apply(op, jnp.asarray(x)))

    mesh = make_mesh()
    n = mesh.devices.size

    def local_spmv(c, v):
        v_ext = halo_exchange(v, "x", n)
        return apply_ext(StencilOperator(c, offsets), v_ext)

    f = jax.jit(
        jax.shard_map(
            local_spmv,
            mesh=mesh,
            in_specs=(P(None, "x"), P("x")),
            out_specs=P("x"),
        )
    )
    got = np.asarray(f(jnp.asarray(coeffs), jnp.asarray(x)))
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("exclude_diag", [False, True])
@pytest.mark.parametrize("constant", [False, True])
def test_overlapped_apply_matches_plain(exclude_diag, constant):
    """apply_overlapped == halo_exchange + apply_ext to fp roundoff (the
    halo terms are summed last instead of in offset order) — for both
    varying and constant operators (T10 overlap invariant)."""
    shape = (32, 16)
    offsets, coeffs = poisson_stencil(shape, dtype=np.float32)
    x = rhs_random(shape, seed=3).astype(np.float32)
    mesh = make_mesh()
    n = mesh.devices.size
    mid = tuple(s // 2 for s in shape)  # interior point: true stencil values
    vals = jnp.asarray([coeffs[k][mid] for k in range(len(offsets))])

    def make_op(c, local_shape):
        if constant:
            return StencilOperator(None, offsets, vals, tuple(local_shape))
        return StencilOperator(c, offsets)

    def plain(c, v):
        return apply_ext(make_op(c, v.shape), halo_exchange(v, "x", n), exclude_diag)

    def overlapped(c, v):
        lower, upper = halo_planes(v, "x", n)
        return apply_overlapped(make_op(c, v.shape), v, lower, upper, exclude_diag)

    specs = dict(in_specs=(P(None, "x"), P("x")), out_specs=P("x"))
    f_plain = jax.jit(jax.shard_map(plain, mesh=mesh, **specs))
    f_over = jax.jit(jax.shard_map(overlapped, mesh=mesh, **specs))
    a = np.asarray(f_plain(jnp.asarray(coeffs), jnp.asarray(x)))
    o = np.asarray(f_over(jnp.asarray(coeffs), jnp.asarray(x)))
    np.testing.assert_allclose(o, a, rtol=1e-6, atol=1e-6)
    if constant and not exclude_diag:
        # constant-op zero-truncation must also match the global stencil
        op_full = StencilOperator(None, offsets, vals, shape)
        ref = np.asarray(apply(op_full, jnp.asarray(x)))
        np.testing.assert_allclose(o, ref, rtol=1e-6, atol=1e-6)


def test_overlapped_solve_matches_reference_path():
    """Full distributed solve with overlap on == off (same trajectory)."""
    shape = (64, 32)
    cfg = SolverConfig(
        smoother="rbgs",
        transfer="linear",
        residual_dtype="doublefloat",
        cycles=40,
        gridlevels=3,
        max_dense_coarse=4096,
        threshold=1e-9,
    )
    b = rhs_random(shape, seed=4)
    single = setup(shape, cfg)
    d_over = DistributedSolver(
        single.hierarchy, cfg, MeshConfig(n_devices=8, overlap_halo=True)
    )
    d_ref = DistributedSolver(
        single.hierarchy, cfg, MeshConfig(n_devices=8, overlap_halo=False)
    )
    x_o, info_o = d_over.solve(b)
    x_r, info_r = d_ref.solve(b)
    assert info_o["converged"] and info_r["converged"]
    assert abs(info_o["cycles"] - info_r["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x_o), np.asarray(x_r), rtol=1e-8, atol=1e-10
    )


@pytest.mark.parametrize(
    "shape,transfer,smoother",
    [
        ((64,), "aggregate", "jacobi"),
        ((64, 32), "linear", "rbgs"),
        ((32, 16, 16), "linear", "rbgs"),
        ((16, 16), "linear", "jacobi"),
        # wide local planes on the partitioned constant fine level AND
        # the partitioned cornered Galerkin level
        ((32, 8, 256), "linear", "rbgs"),
        ((32, 8, 256), "aggregate", "jacobi"),
        # chebyshev: residual-based fast path on partitioned cornered levels
        ((32, 16, 16), "linear", "chebyshev"),
        # partitioned 2D local blocks
        ((32, 256), "linear", "rbgs"),
    ],
)
def test_distributed_matches_single_device(shape, transfer, smoother):
    """Partitioned solve == single-device solve: same cycle count and
    near-identical residual trajectory (norm reduction order differs)."""
    cfg = SolverConfig(
        smoother=smoother,
        transfer=transfer,
        residual_dtype="doublefloat",
        cycles=60,
        gridlevels=3,
        max_dense_coarse=4096,
        threshold=1e-9,
    )
    b = rhs_random(shape, seed=1)
    single = setup(shape, cfg)
    x1, info1 = single.solve(b)
    dist = DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))
    x8, info8 = dist.solve(b)
    assert info8["n_devices"] == 8
    assert info8["partition_plan"][0] is True
    assert info8["converged"] == info1["converged"]
    assert abs(info8["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x8), np.asarray(x1), rtol=1e-8, atol=1e-10
    )
    n = min(len(info1["residual_norms"]), len(info8["residual_norms"]))
    # norms differ only by fp reduction order; near the 1e-11 convergence
    # floor the relative difference grows, hence the atol term
    np.testing.assert_allclose(
        info1["residual_norms"][:n],
        info8["residual_norms"][:n],
        rtol=1e-4,
        atol=1e-12,
    )


def test_distributed_deep_fusion_matches_single():
    """(64, 16, 128): partitioned const and cornered levels above a
    partitioned coarser level (halo-tap restriction and prolongation on
    local (8, 16, 128) blocks) reproduce the single-device solve."""
    shape = (64, 16, 128)
    cfg = SolverConfig(
        smoother="rbgs",
        transfer="linear",
        residual_dtype="doublefloat",
        cycles=60,
        gridlevels=3,
        max_dense_coarse=4096,
        threshold=1e-9,
    )
    b = rhs_random(shape, seed=15)
    single = setup(shape, cfg)
    x1, info1 = single.solve(b)
    dist = DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))
    assert dist.plan[:2] == (True, True)
    x8, info8 = dist.solve(b)
    assert info8["converged"] == info1["converged"]
    assert abs(info8["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x8), np.asarray(x1), rtol=1e-8, atol=1e-10
    )


def test_distributed_cornered_deep_fusion_matches():
    """The K=27 cornered Galerkin level smooths and takes residuals
    partitioned over 8 devices — halo planes at the block edges, axis-0
    region fix-ups gated to the first device — identically to the
    single-device smoother and residual on the whole grid."""
    from openmg_tpu.ops.smoothers import smooth
    from openmg_tpu.ops.stencil import CorneredOperator, residual
    from openmg_tpu.parallel import fast
    from openmg_tpu.parallel.mesh import make_mesh

    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        cycles=60, gridlevels=4, max_dense_coarse=4096,
    )
    h = setup((128, 32, 64), cfg).hierarchy
    op = h.levels[1].A
    assert isinstance(op, CorneredOperator) and op.num_offsets == 27
    s = op.grid_shape  # (64, 16, 32)
    local = (s[0] // 8,) + s[1:]
    op_local = CorneredOperator(
        op.values, op.deltas, op.offsets, local, op.subsets
    )
    b = jnp.asarray(rhs_random(s, seed=3), jnp.float32)
    x = jnp.asarray(rhs_random(s, seed=4), jnp.float32)
    mesh = make_mesh(8)
    for name in ("rbgs", "jacobi", "chebyshev"):
        want = smooth(name, op, h.levels[1].inv_diag, b, x, 2, 2 / 3)
        f = jax.jit(
            jax.shard_map(
                lambda b_, x_: fast.smooth_part(
                    name, op_local, b_, x_, 2, 2 / 3, "x", 8
                ),
                mesh=mesh, in_specs=(P("x"), P("x")), out_specs=P("x"),
                check_vma=False,
            )
        )
        np.testing.assert_allclose(
            np.asarray(f(b, x)), np.asarray(want), atol=2e-5, err_msg=name
        )
    fr = jax.jit(
        jax.shard_map(
            lambda b_, x_: fast.residual_part(op_local, b_, x_, "x", 8),
            mesh=mesh, in_specs=(P("x"), P("x")), out_specs=P("x"),
            check_vma=False,
        )
    )
    np.testing.assert_allclose(
        np.asarray(fr(b, x)), np.asarray(residual(op, b, x)), atol=2e-5
    )


def test_distributed_vary_kernel_tier():
    """(32, 8, 256) diffusion: partitioned varying-coefficient levels
    (coefficient grids sharded with the rows) match the single-device
    solve (VERDICT r3 task 2)."""
    from openmg_tpu.models.poisson import diffusion_stencil

    shape = (32, 8, 256)
    rng = np.random.default_rng(5)
    kappa = np.exp(0.5 * rng.standard_normal(shape))
    offsets, coeffs = diffusion_stencil(kappa)
    cfg = SolverConfig(
        smoother="rbgs",
        transfer="linear",
        residual_dtype="doublefloat",
        cycles=60,
        gridlevels=3,
        max_dense_coarse=4096,
        threshold=1e-8,
    )
    b = rhs_random(shape, seed=6)
    single = setup((offsets, coeffs), cfg)
    x1, info1 = single.solve(b)
    dist = DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))
    assert dist.kinds[0] == "vary" and dist.plan[0] is True
    x8, info8 = dist.solve(b)
    assert info8["converged"] == info1["converged"]
    assert abs(info8["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x8), np.asarray(x1), rtol=1e-7, atol=1e-9
    )


def test_distributed_vary_chebyshev_kernel_tier():
    """Chebyshev on partitioned varying levels (λ_max pmax'd once across
    the devices), matching single-device (VERDICT r4 task 10 — the last
    smoother×kind×partitioned cell)."""
    from openmg_tpu.models.poisson import diffusion_stencil

    shape = (32, 8, 256)
    rng = np.random.default_rng(7)
    kappa = np.exp(0.5 * rng.standard_normal(shape))
    offsets, coeffs = diffusion_stencil(kappa)
    cfg = SolverConfig(
        smoother="chebyshev",
        transfer="linear",
        residual_dtype="doublefloat",
        cycles=60,
        gridlevels=3,
        max_dense_coarse=4096,
        threshold=1e-8,
    )
    b = rhs_random(shape, seed=8)
    single = setup((offsets, coeffs), cfg)
    x1, info1 = single.solve(b)
    dist = DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))
    assert dist.kinds[0] == "vary" and dist.plan[0] is True
    x8, info8 = dist.solve(b)
    assert info8["converged"] == info1["converged"]
    assert abs(info8["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x8), np.asarray(x1), rtol=1e-7, atol=1e-9
    )


@pytest.mark.parametrize("shape", [(32, 16, 16), (32, 8, 256)])
def test_force_partition_single_device_matches(shape):
    """MeshConfig(force_partition=True) on a 1-device mesh runs the exact
    per-device multi-device program (halo-aware sweeps + cornered fix-ups
    — parallel/fast.py) and must reproduce the single-device solve."""
    cfg = SolverConfig(
        smoother="rbgs",
        transfer="linear",
        residual_dtype="doublefloat",
        cycles=60,
        gridlevels=3,
        max_dense_coarse=4096,
        threshold=1e-9,
    )
    b = rhs_random(shape, seed=11)
    single = setup(shape, cfg)
    x1, info1 = single.solve(b)
    forced = DistributedSolver(
        single.hierarchy, cfg,
        MeshConfig(n_devices=1, force_partition=True),
    )
    assert forced.plan[0] is True and forced.n_dev == 1
    xf, infof = forced.solve(b)
    assert infof["converged"] == info1["converged"]
    assert abs(infof["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(xf), np.asarray(x1), rtol=1e-8, atol=1e-10
    )


def test_distributed_setup_convenience():
    shape = (32, 32)
    cfg = SolverConfig(transfer="linear", cycles=60, gridlevels=3,
                       max_dense_coarse=4096)
    solver = distributed_setup(shape, cfg, MeshConfig(n_devices=4))
    b = rhs_random(shape, seed=2)
    x, info = solver.solve(b)
    assert info["converged"]
    assert info["n_devices"] == 4
    assert info["final_norm"] < 1e-10


def test_distributed_rejects_indivisible():
    cfg = SolverConfig(residual_dtype="doublefloat", gridlevels=2,
                       max_dense_coarse=4096)
    single = setup((12, 12), cfg)  # 12 % 8 != 0
    with pytest.raises(ValueError):
        DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))


def test_distributed_device_loop_matches_host_loop():
    """The one-dispatch while_loop solve == the per-cycle host loop."""
    import dataclasses

    shape = (32, 16)
    cfg = SolverConfig(
        transfer="linear", cycles=60, gridlevels=3, max_dense_coarse=4096
    )
    b = rhs_random(shape, seed=7)
    dev = distributed_setup(shape, cfg, MeshConfig(n_devices=4))
    x_d, info_d = dev.solve(b)
    assert info_d["outer_loop"] == "device"
    host = distributed_setup(
        shape,
        dataclasses.replace(cfg, outer_loop="host"),
        MeshConfig(n_devices=4),
    )
    x_h, info_h = host.solve(b)
    assert info_h.get("outer_loop", "host") == "host"
    assert info_d["cycles"] == info_h["cycles"]
    assert info_d["converged"] == info_h["converged"]
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_h), rtol=0, atol=0)
    np.testing.assert_allclose(
        info_d["residual_norms"], info_h["residual_norms"], rtol=1e-6
    )


def test_distributed_pcg_matches_single_device():
    """krylov="pcg" on the distributed engine: MG-preconditioned CG with
    psum inner products == single-device pcg_solve (same cycle count,
    matching solutions).  Covers both the const-stencil fine level and a
    varying (diffusion) fine level."""
    from openmg_tpu.models.poisson import diffusion_stencil

    for make in (None, "diffusion"):
        shape = (32, 8, 8)
        cfg = SolverConfig(
            smoother="rbgs",
            transfer="linear",
            residual_dtype="doublefloat",
            krylov="pcg",
            krylov_iters=2,
            cycles=60,
            gridlevels=3,
            max_dense_coarse=4096,
            threshold=1e-9,
        )
        if make == "diffusion":
            rng = np.random.default_rng(3)
            kappa = np.exp(rng.standard_normal(shape))
            single = setup(diffusion_stencil(kappa), cfg)
        else:
            single = setup(shape, cfg)
        b = rhs_random(shape, seed=1)
        x1, info1 = single.solve(b)
        dist = DistributedSolver(
            single.hierarchy, cfg, MeshConfig(n_devices=8)
        )
        x8, info8 = dist.solve(b)
        assert info8["converged"] == info1["converged"]
        assert abs(info8["cycles"] - info1["cycles"]) <= 1
        np.testing.assert_allclose(
            np.asarray(x8), np.asarray(x1), rtol=1e-8, atol=1e-10
        )


def test_unknown_krylov_rejected_on_distributed_engine():
    import dataclasses

    good = SolverConfig(
        residual_dtype="doublefloat", gridlevels=2, max_dense_coarse=4096
    )
    single = setup((16, 16), good)
    # sidestep SolverConfig's own construction check to exercise the
    # engine-side guard
    bad = dataclasses.replace(good)
    object.__setattr__(bad, "krylov", "bogus")
    with pytest.raises(ValueError, match="krylov"):
        DistributedSolver(single.hierarchy, bad, MeshConfig(n_devices=4))


def test_device_resident_rhs_no_host_roundtrip(monkeypatch):
    """An f32 jax-array rhs must never be pulled to the host (df_split) —
    the lo part and zero guess are materialized on device — and the result
    must match the host-numpy path exactly (same hi trajectory), delivered
    as a device array with the full pair in info['x_df']."""
    import openmg_tpu.parallel.dist as dist_mod

    shape = (32, 16)
    cfg = SolverConfig(transfer="linear", cycles=60, gridlevels=3,
                       max_dense_coarse=4096)
    b_np = rhs_random(shape, seed=9)
    solver = distributed_setup(shape, cfg, MeshConfig(n_devices=4))
    x_host, info_host = solver.solve(b_np)

    b_dev = jnp.asarray(b_np, dtype=jnp.float32)
    # f32 rhs == df_split(f64 rhs).hi here only if b is exactly f32;
    # compare against a host solve of the f32-rounded rhs (run before the
    # monkeypatch — the host path legitimately calls df_split)
    x_host32, info_host32 = solver.solve(np.asarray(b_dev, dtype=np.float64))
    monkeypatch.setattr(
        dist_mod, "df_split",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("df_split called on the device-native path")),
    )
    x_dev, info_dev = solver.solve(b_dev)
    assert isinstance(x_dev, jax.Array) and x_dev.dtype == jnp.float32
    assert "x_df" in info_dev
    assert info_dev["cycles"] == info_host["cycles"]
    np.testing.assert_allclose(
        np.asarray(x_dev, dtype=np.float64)
        + np.asarray(info_dev["x_df"][1], dtype=np.float64),
        np.asarray(x_host32),
        rtol=1e-12, atol=1e-13,
    )


def test_two_axis_mesh_matches_single_device():
    """(host, chip) 2-axis mesh (SURVEY.md §4.2-3): the partition axis
    spans both mesh axes; same shard_map code, same solution as the
    single-device and 1D-mesh solves."""
    shape = (32, 16, 16)
    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        cycles=60, gridlevels=3, max_dense_coarse=4096, threshold=1e-9,
    )
    b = rhs_random(shape, seed=5)
    single = setup(shape, cfg)
    x1, info1 = single.solve(b)
    dist2d = DistributedSolver(
        single.hierarchy, cfg, MeshConfig(mesh_shape=(2, 4))
    )
    assert dist2d.n_dev == 8
    assert dist2d.mesh.axis_names == ("host", "chip")
    x2d, info2d = dist2d.solve(b)
    assert info2d["partition_plan"][0] is True
    assert info2d["converged"] == info1["converged"]
    assert abs(info2d["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x2d), np.asarray(x1), rtol=1e-8, atol=1e-10
    )
    # and bit-identical to the 1D 8-device mesh (same linearized ring)
    dist1d = DistributedSolver(
        single.hierarchy, cfg, MeshConfig(n_devices=8)
    )
    x1d, _ = dist1d.solve(b)
    np.testing.assert_array_equal(np.asarray(x2d), np.asarray(x1d))


def test_initialize_distributed_noop_paths():
    """Bootstrap wrapper: a no-op on single-process environments (no
    coordinator) and when already initialized — must never raise here."""
    from openmg_tpu.parallel.mesh import initialize_distributed

    initialize_distributed()
    initialize_distributed()  # idempotent


def test_initialize_distributed_reraises_genuine_errors(monkeypatch):
    """Only the benign already-initialized RuntimeError is swallowed; a
    genuine bootstrap failure (bad coordinator, port clash) must
    propagate, not silently degrade to a 1-process mesh."""
    import jax

    from openmg_tpu.parallel.mesh import initialize_distributed

    def boom(**kwargs):
        raise RuntimeError("Unable to connect to coordinator at 10.0.0.1")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="coordinator"):
        initialize_distributed()

    # the actual JAX 0.9.x re-init wording, plus older variants
    for wording in (
        "distributed.initialize should only be called once.",
        "jax.distributed.initialize() was called more than once",
        "Distributed system is already initialized",
    ):
        def already(_msg=wording, **kwargs):
            raise RuntimeError(_msg)

        monkeypatch.setattr(jax.distributed, "initialize", already)
        initialize_distributed()  # benign: swallowed


def test_weak_scaling_harness_schema():
    """Pin the weak-scaling harness (BASELINE north-star metric surface):
    record schema, efficiency formula (per-device throughput relative to
    1 device, == 1.0 at n=1), and device sequence on the fake mesh."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent / "examples"))
    try:
        from weak_scaling import run_weak_scaling
    finally:
        sys.path.pop(0)

    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", gridlevels=2,
        max_dense_coarse=1 << 20, cycles=8, threshold=0.0,
    )
    recs = run_weak_scaling(base=8, ny=8, nz=8, max_devices=4, cfg=cfg)
    assert [r["devices"] for r in recs] == [1, 2, 4]
    keys = {
        "devices", "shape", "fine_nnz", "cycles", "converged", "solve_s",
        "smoother_nnz_per_s_per_device", "weak_scaling_efficiency",
    }
    for r in recs:
        assert keys <= set(r), r
        assert r["shape"] == [8 * r["devices"], 8, 8]
        assert r["solve_s"] > 0 and r["smoother_nnz_per_s_per_device"] > 0
        # efficiency formula: per-device nnz/s relative to the n=1 run
        np.testing.assert_allclose(
            r["weak_scaling_efficiency"],
            r["smoother_nnz_per_s_per_device"]
            / recs[0]["smoother_nnz_per_s_per_device"],
        )
    assert recs[0]["weak_scaling_efficiency"] == 1.0


def test_distributed_fmg_matches_single_device():
    """Distributed FMG (per-level rhs restriction with halo taps +
    redistribution all_gather) == single-device FMG."""
    shape = (32, 16, 16)
    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        cycle_type="f", cycles=40, gridlevels=3, max_dense_coarse=4096,
        threshold=1e-9,
    )
    b = rhs_random(shape, seed=6)
    single = setup(shape, cfg)
    x1, info1 = single.solve(b)
    dist = DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))
    x8, info8 = dist.solve(b)
    assert info8["converged"] == info1["converged"]
    assert abs(info8["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x8), np.asarray(x1), rtol=1e-8, atol=1e-10
    )


def test_distributed_rejects_wide_halo():
    """Operators reaching more than one row across the partition boundary
    (axis-0 offset radius > 1) must be rejected at construction — the
    halo exchange is one plane each way."""
    import numpy as np
    from openmg_tpu.models.poisson import poisson_stencil

    shape = (32, 16)
    offsets, coeffs = poisson_stencil(shape, dtype=np.float64)
    # add a radius-2 axis-0 coupling
    ext = np.zeros((2,) + shape)
    ext[0, :-2, :] = -0.1  # (+2, 0) neighbor
    ext[1, 2:, :] = -0.1   # (−2, 0) neighbor
    offsets = tuple(offsets) + ((2, 0), (-2, 0))
    coeffs = np.concatenate([coeffs, ext])
    cfg = SolverConfig(residual_dtype="doublefloat", gridlevels=2,
                       max_dense_coarse=4096)
    single = setup((offsets, coeffs), cfg)
    with pytest.raises(ValueError, match="radius-1"):
        DistributedSolver(single.hierarchy, cfg, MeshConfig(n_devices=8))


def test_distributed_checkpoint_resume(tmp_path):
    """Distributed solve interrupted after 3 cycles and resumed with a
    higher cap reproduces the uninterrupted distributed solve exactly
    (same contract as the single-device checkpoint/resume, SURVEY §5.4)."""
    from openmg_tpu.utils.checkpoint import config_hash, load_checkpoint

    shape = (32, 16)
    b = rhs_random(shape, seed=11)
    mc = MeshConfig(n_devices=4)
    full = SolverConfig(smoother="rbgs", transfer="linear", cycles=40,
                        gridlevels=3, max_dense_coarse=4096)
    x_ref, info_ref = distributed_setup(shape, full, mc).solve(b)
    assert info_ref["converged"]

    p = tmp_path / "dist_state.npz"
    short = SolverConfig(smoother="rbgs", transfer="linear", cycles=3,
                         gridlevels=3, max_dense_coarse=4096)
    _, info3 = distributed_setup(shape, short, mc).solve(
        b, checkpoint_path=str(p)
    )
    assert not info3["converged"]
    import dataclasses

    # distributed_setup normalizes residual_dtype to "doublefloat"
    short_norm = dataclasses.replace(short, residual_dtype="doublefloat")
    _, cyc, _ = load_checkpoint(p, config_hash(short_norm, shape))
    assert cyc == 3

    x_res, info_res = distributed_setup(shape, full, mc).solve(
        b, checkpoint_path=str(p), resume=True
    )
    assert info_res["converged"]
    np.testing.assert_allclose(
        np.asarray(x_res), np.asarray(x_ref), rtol=0, atol=1e-13
    )


def test_distributed_solve_many_matches_scalar():
    """Distributed batched serving (one cached jit(vmap) over the
    shard_map program) == per-rhs scalar distributed solves to fp
    reassociation tolerance (the outer jit fuses across the vmap, so
    batch-vs-scalar is no longer bit-identical — run-to-run determinism
    of each program is pinned elsewhere), with identical cycle counts."""
    shape = (32, 16)
    cfg = SolverConfig(transfer="linear", residual_dtype="doublefloat",
                       cycles=60, gridlevels=3, max_dense_coarse=4096)
    solver = distributed_setup(shape, cfg, MeshConfig(n_devices=8))
    rhs = [rhs_random(shape, seed=s) for s in (13, 14)]
    rhs[1] = rhs[1] * 1e-3
    xs, info = solver.solve_many(rhs)
    assert info["batch"] == 2 and info["n_devices"] == 8
    for k, b in enumerate(rhs):
        xk, infok = solver.solve(b)
        np.testing.assert_allclose(
            np.asarray(xs[k]), np.asarray(xk), rtol=1e-11, atol=1e-13
        )
        assert info["cycles"][k] == infok["cycles"]
    assert info["cycles"][1] < info["cycles"][0]
    # run-to-run determinism of the batched program itself is bitwise
    xs2, _ = solver.solve_many(rhs)
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(xs2))


def test_distributed_solve_many_device_native(monkeypatch):
    """A (K, *grid) f32 jax-array batch must never touch the host
    (df_split) — the lo parts and zero guesses materialize on device —
    and must match the host-path batch on the f32-rounded rhs, delivered
    as an f32 device array with the full pair in info['x_df']."""
    import openmg_tpu.parallel.dist as dist_mod

    shape = (32, 16)
    cfg = SolverConfig(transfer="linear", residual_dtype="doublefloat",
                       cycles=60, gridlevels=3, max_dense_coarse=4096)
    solver = distributed_setup(shape, cfg, MeshConfig(n_devices=8))
    rhs = np.stack([rhs_random(shape, seed=s) for s in (21, 22)])
    bs_dev = jnp.asarray(rhs, dtype=jnp.float32)
    x_host, info_host = solver.solve_many(np.asarray(bs_dev, np.float64))
    monkeypatch.setattr(
        dist_mod, "df_split",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("df_split called on the device-native batch path")
        ),
    )
    xs_dev, info_dev = solver.solve_many(bs_dev)
    assert isinstance(xs_dev, jax.Array) and xs_dev.dtype == jnp.float32
    assert "x_df" in info_dev
    assert info_dev["cycles"] == info_host["cycles"]
    np.testing.assert_allclose(
        np.asarray(xs_dev, dtype=np.float64)
        + np.asarray(info_dev["x_df"][1], dtype=np.float64),
        np.asarray(x_host),
        rtol=1e-12, atol=1e-13,
    )


@pytest.mark.parametrize("overlap", [True, False])
def test_distributed_partial_fusion_matches_single(overlap):
    """(32, 16, 32): RB-GS on partitioned const/cornered levels with the
    overlapped halo scheme on and off reproduces the single-device
    solve."""
    shape = (32, 16, 32)
    cfg = SolverConfig(smoother="rbgs", transfer="linear",
                       residual_dtype="doublefloat", cycles=60,
                       gridlevels=3, max_dense_coarse=4096,
                       threshold=1e-9)
    b = rhs_random(shape, seed=11)
    single = setup(shape, cfg)
    x1, info1 = single.solve(b)
    dist = DistributedSolver(
        single.hierarchy, cfg, MeshConfig(n_devices=8, overlap_halo=overlap)
    )
    x8, info8 = dist.solve(b)
    assert info8["converged"] == info1["converged"]
    assert abs(info8["cycles"] - info1["cycles"]) <= 1
    np.testing.assert_allclose(
        np.asarray(x8), np.asarray(x1), rtol=1e-8, atol=1e-10
    )
