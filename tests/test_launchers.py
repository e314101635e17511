"""The launchers' shared pieces on the CPU: the compile-cache helper,
``chip_smoke.py``'s phase functions at tiny sizes (and its refusal to run
without a GPU), and the full-precision dense products of the coarse
solves."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from openmg_tpu.models.poisson import poisson  # noqa: E402
from openmg_tpu.utils import cache  # noqa: E402


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_is_left_to_jax(monkeypatch, tmp_path,
                                           restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cache.use_compile_cache(tmp_path) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch, tmp_path,
                                        restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.use_compile_cache(tmp_path)
    assert path == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path: a second call names the same directory
    assert cache.use_compile_cache(tmp_path) == path


def test_cache_root_is_the_checkout():
    assert (cache.CHECKOUT_ROOT / "chip_smoke.py").is_file()
    assert (cache.CHECKOUT_ROOT / "openmg_tpu").is_dir()
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no gpu device"):
        cs.device_check(jax)
    d = cs.device_check(jax, "cpu")
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_main_fails_without_gpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError, match="no gpu device"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(9,), (6, 7), (5, 4, 3)])
def test_poisson_residual_matches_scipy(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    want = np.linalg.norm(b.ravel() - poisson(shape) @ x.ravel())
    assert cs.poisson_residual(b, x) == pytest.approx(want, rel=1e-12)


def test_unit_rhs_has_unit_norm_per_rhs():
    b = cs.unit_rhs((4, 6), batch=3)
    assert b.shape == (3, 4, 6) and b.dtype == jnp.float32
    norms = np.linalg.norm(np.asarray(b, np.float64).reshape(3, -1), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-6)
    np.testing.assert_array_equal(cs.unit_rhs((4, 6)), cs.unit_rhs((4, 6)))


@pytest.mark.parametrize("krylov", ["none", "pcg"])
def test_phase_poisson_tiny(krylov):
    rec = cs.phase_poisson("t", (16, 16, 16), krylov=krylov, reps=1)
    assert rec["host_f64_residual"] <= cs.HOST_RESIDUAL_TOL
    assert rec["cycles"] >= 1
    json.dumps(rec, default=float)
    with pytest.raises(AssertionError, match="cycles"):
        cs.phase_poisson("t", (16, 16, 16), krylov=krylov, reps=0,
                         expect=rec["cycles"] + 1)


def test_phase_solve_many_tiny():
    rec = cs.phase_solve_many((8, 8, 16), 3, reps=1)
    assert len(rec["cycles"]) == 3
    assert rec["max_rel_diff_vs_scalar"] <= 1e-6


def test_phase_sparse_engines_tiny():
    ell = cs.phase_ell((8, 8, 8))
    bsr = cs.phase_bsr((8, 8))
    assert ell["rows"] == 512 and bsr["rows"] == 128
    for rec in (ell, bsr):
        assert rec["host_f64_residual"] <= cs.HOST_RESIDUAL_TOL


def test_phase_residual_modes_tiny():
    df, f64 = cs.phase_residual_modes((16, 16, 16))
    assert df["phase"] == "residual_doublefloat"
    assert f64["phase"] == "residual_float64"
    assert abs(df["cycles"] - f64["cycles"]) <= 1


def test_phase_distributed_tiny():
    rec = cs.phase_distributed((16, 16, 16), 4, reps=1)
    assert rec["devices"] == 4 and rec["rel_diff_vs_one_device"] <= 1e-6


def test_phase_distributed_sparse_tiny():
    rec = cs.phase_distributed_sparse((32, 32), 4, reps=1)
    assert rec["devices"] == 4 and rec["rel_diff_vs_one_device"] <= 1e-6


def test_compare_rejects_cycle_mismatch():
    x = jnp.ones((4,), jnp.float32)
    with pytest.raises(AssertionError, match="cycles"):
        cs._compare("t", x, {"cycles": 3}, x, {"cycles": 4})
    with pytest.raises(AssertionError, match="relative"):
        cs._compare("t", x, {"cycles": 3}, 2 * x, {"cycles": 3})


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the script exits
    non-zero and prints no result line (here it already stops at the
    device check; on a GPU at the package import)."""
    import subprocess

    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# full-precision dense products
# ---------------------------------------------------------------------------


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _highest(p):
    return p is not None and all(q == lax.Precision.HIGHEST for q in p)


def _stencil_coarse():
    from openmg_tpu import SolverConfig, setup
    from openmg_tpu.core.cycle import coarse_solve

    h = setup((16, 16), SolverConfig(gridlevels=2)).hierarchy
    b = jnp.ones(h.levels[-1].grid_shape, jnp.float32)
    return (lambda v: coarse_solve(h, v)), b


def _algebraic_coarse():
    from openmg_tpu import SolverConfig
    from openmg_tpu.core.algebraic import setup_sparse

    s = setup_sparse(poisson((16, 16)), (16, 16),
                     SolverConfig(format="ell", gridlevels=2))
    h = s.hierarchy
    n = h.coarse_inv.shape[0]
    from openmg_tpu.ops.sparse import dense_matvec

    return (lambda v: dense_matvec(h.coarse_inv, v)), jnp.ones((n,),
                                                                jnp.float32)


def _dense_spmv():
    from openmg_tpu.ops.sparse import dense_from_scipy, spmv

    M = dense_from_scipy(poisson((6, 6)))
    return (lambda v: spmv(M, v)), jnp.ones((36,), jnp.float32)


def _bsr_gather_spmv():
    import scipy.sparse as sp

    from openmg_tpu.ops.sparse import bsr_from_scipy, spmv

    rng = np.random.default_rng(0)
    A = sp.random(16, 16, density=0.3, random_state=1) + sp.eye(16)
    # non-square blocks take the gathered einsum path
    M = bsr_from_scipy(sp.csr_matrix(A), (2, 4))
    assert M.slot_offsets is None
    return (lambda v: spmv(M, v)), jnp.asarray(rng.standard_normal(16),
                                               jnp.float32)


@pytest.mark.parametrize(
    "make", [_stencil_coarse, _algebraic_coarse, _dense_spmv,
             _bsr_gather_spmv],
    ids=["coarse_solve", "algebraic_coarse", "dense_spmv", "bsr_einsum"],
)
def test_dense_products_run_at_highest_precision(make):
    fn, arg = make()
    precs = _dot_precisions(fn, arg)
    assert precs, "no dense product traced"
    assert all(_highest(p) for p in precs), precs
