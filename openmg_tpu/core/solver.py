"""Driver / public API (component R7, plus the mixed-precision outer loop).

Two entry points:

* :func:`mg_solve` — reference-compatible: ``mg_solve(A, b, parameters)``
  with the reference's parameters-dict vocabulary (SURVEY.md R7).  ``A`` may
  be a scipy sparse matrix (its exact stencil form is extracted when it is
  grid-structured) or ``None`` to assemble Poisson from ``problemshape``.
* :func:`setup` / :func:`solve` — the native API: build a :class:`Solver`
  once (hierarchy + jitted cycle), then solve many right-hand sides.

Convergence loop (defect-correction form): because every cycle component is
linear, ``V(b, x) == x + V(b − A x, 0)``, so the driver iterates
``x ← x + V(r, 0)`` with the residual ``r = b − A x`` evaluated at high
precision while the V-cycle itself runs in f32.  This is classical
iterative refinement and is how an f32 cycle reaches the reference's
1e-10 absolute tolerance (SURVEY.md §7 "Hard parts", Plan A).  The
accelerator default for the high-precision residual is **double-float**
(two-f32 compensated arithmetic, :mod:`openmg_tpu.ops.doublefloat`);
native float64 and float32 modes are selectable.
"""

from __future__ import annotations

import functools
import time
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from openmg_tpu.core.config import ProblemConfig, SolverConfig
from openmg_tpu.core.cycle import pcg_solve, run_cycle, v_cycle
from openmg_tpu.core.hierarchy import Hierarchy, build_hierarchy
from openmg_tpu.models.poisson import poisson_stencil, stencil_from_csr
from openmg_tpu.ops.doublefloat import (
    df_add_f32,
    df_merge,
    df_mul,
    df_split,
    df_sub,
    pow2_terms,
)
from openmg_tpu.ops.stencil import apply as stencil_apply
from openmg_tpu.ops.stencil import shift
from openmg_tpu.ops.transfer import TRANSFERS
from openmg_tpu.utils.observe import pack_solve_meta

__all__ = ["Solver", "setup", "solve", "mg_solve"]


def _inner_solve(
    h, r, *, cycle_type, pre, post, smoother, omega, krylov, krylov_iters
):
    """Inner error solver of the defect-correction loop: one MG cycle
    (reference-parity) or krylov_iters MG-preconditioned CG steps."""
    if krylov == "pcg":
        return pcg_solve(
            h, r, krylov_iters, cycle_type, pre, post, smoother, omega
        )
    if krylov not in (None, "none"):
        raise ValueError(f"unknown krylov {krylov!r}; choose none|pcg")
    return run_cycle(h, r, cycle_type, pre, post, smoother, omega)


def _resolve_residual_mode(name, warn: bool = True):
    """Resolve a residual_dtype config value to 'doublefloat' or a dtype."""
    if name in (None, ""):
        return None
    if name == "doublefloat":
        return "doublefloat"
    if name == "auto":
        if jax.default_backend() == "cpu" and jax.config.jax_enable_x64:
            return jnp.dtype(jnp.float64)
        return "doublefloat"
    dt = jnp.dtype(name)
    if dt == jnp.float64 and not jax.config.jax_enable_x64:
        if warn:
            warnings.warn(
                "residual_dtype=float64 requested but jax_enable_x64 is off; "
                "falling back to float32 (1e-10 absolute tolerances may be "
                "unreachable). Consider residual_dtype='doublefloat'.",
                stacklevel=3,
            )
        return jnp.dtype(jnp.float32)
    return dt


class Solver:
    """A configured multigrid solver bound to one operator hierarchy.

    Holds the static level pytree and the jitted cycle/residual programs;
    ``solve`` runs the outer defect-correction loop as one device program
    (or, for verbose streaming and checkpoints, on the host with one sync
    per cycle); both record the per-cycle residual history, matching the
    reference driver's observable behavior.
    """

    def __init__(self, hierarchy: Hierarchy, config: SolverConfig):
        self.hierarchy = hierarchy
        self.config = config
        self.dtype = jnp.dtype(config.dtype)
        self.residual_mode = (
            _resolve_residual_mode(config.residual_dtype, warn=False) or self.dtype
        )
        if self.residual_mode == "doublefloat" and hierarchy.fine_hi_lo is None:
            raise ValueError(
                "hierarchy was not built with residual_dtype='doublefloat'"
            )

        self._exact_terms = (
            exact_residual_terms(hierarchy)
            if self.residual_mode == "doublefloat"
            else None
        )
        self._cycle = functools.partial(
            _cycle_step,
            pre=config.pre_iterations,
            post=config.post_iterations,
            smoother=config.smoother,
            cycle_type=config.cycle_type,
            krylov=config.krylov,
            krylov_iters=config.krylov_iters,
            omega=config.omega,
            cycle_dtype=self.dtype,
        )

    @property
    def grid_shape(self):
        return self.hierarchy.grid_shape

    def solve(
        self,
        b,
        x0=None,
        *,
        checkpoint_path=None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ):
        """Solve ``A x = b`` to the configured threshold.

        ``b`` is grid-shaped (or flat; it is reshaped).  Returns
        ``(x, info)`` with the per-cycle residual-norm history (component
        R10/T15 observability surface).

        Result type follows the input (see :meth:`_deliver`): numpy/f64
        ``b`` → exact float64 numpy ``x`` (reference-parity surface);
        float32 jax-array ``b`` → float32 device ``x`` (device-native
        surface; the full-precision pair is in ``info['x_df']``).

        Checkpoint/resume (SURVEY.md §5.4): with ``checkpoint_path``, the
        full-precision iterate + cycle counter are written atomically every
        ``checkpoint_every`` cycles; ``resume=True`` restarts from the file
        when it exists (the config hash is validated — a checkpoint resumes
        only into an identical solver on an identical problem).
        """
        cfg = self.config
        h = self.hierarchy
        shape = self.grid_shape
        df = self.residual_mode == "doublefloat"

        # Keep device-resident inputs on device: a float32 jax array splits
        # exactly as (b, 0) with no host round-trip.
        if isinstance(b, jax.Array) and b.dtype == jnp.float32:
            b_np = None
        else:
            b_np = np.asarray(b, dtype=np.float64).reshape(shape)
        x0_np = (
            None
            if x0 is None
            else np.asarray(x0, dtype=np.float64).reshape(shape)
        )

        cfg_hash = None
        history = []
        start_cycle = 0
        if checkpoint_path is not None:
            from openmg_tpu.utils.checkpoint import (
                config_hash,
                load_checkpoint,
                save_checkpoint,
            )
            import os

            cfg_hash = config_hash(cfg, shape)
            if resume and os.path.exists(checkpoint_path):
                x0_np, start_cycle, loaded = load_checkpoint(
                    checkpoint_path, cfg_hash
                )
                x0_np = x0_np.reshape(shape)
                history = loaded

        # None components (zero x0 / exactly-representable rhs lo part) are
        # materialized inside the device programs, not transferred
        if df:
            if b_np is None:
                b_dev = (b.reshape(shape), None)
            else:
                b_dev = df_split(b_np)
            x = None if x0_np is None else df_split(x0_np)
        else:
            b_dev = (
                b.reshape(shape).astype(self.residual_mode)
                if b_np is None
                else jnp.asarray(b_np, dtype=self.residual_mode)
            )
            x = (
                None
                if x0_np is None
                else jnp.asarray(x0_np, dtype=self.residual_mode)
            )

        limit = cfg.cycles if cfg.cycles > 0 else 10_000

        # Device-side outer loop (the default fast path): the whole solve —
        # cycles, residuals, convergence check, history — is ONE jitted
        # program; no host round-trip per cycle.  The host loop below is
        # kept for verbose streaming and checkpoint/resume.
        use_device_loop = checkpoint_path is None and (
            cfg.outer_loop == "device"
            or (cfg.outer_loop == "auto" and not cfg.verbose)
        )
        if use_device_loop:
            from openmg_tpu.utils.observe import unpack_solve_meta

            t_start = time.perf_counter()
            x, meta = _solve_device(
                h,
                b_dev,
                x,
                limit=limit,
                threshold=float(cfg.threshold),
                pre=cfg.pre_iterations,
                post=cfg.post_iterations,
                smoother=cfg.smoother,
                cycle_type=cfg.cycle_type,
                krylov=cfg.krylov,
                krylov_iters=cfg.krylov_iters,
                omega=cfg.omega,
                cycle_dtype=self.dtype,
                df=df,
                exact_terms=self._exact_terms,
            )
            k_fin, history, done = unpack_solve_meta(meta)
            solve_time = time.perf_counter() - t_start
            n_cycles = max(k_fin - 1, 0)
            info = {
                "residual_norms": history,
                "cycles": n_cycles,
                "converged": bool(done),
                "final_norm": history[-1] if history else float("nan"),
                "gridlevels": h.num_levels,
                "level_stats": h.stats,
                "transfer": h.transfer.name,
                "residual_mode": (
                    "doublefloat" if df else str(self.residual_mode)
                ),
                "cycle_times_s": [],
                "mean_cycle_time_s": solve_time / max(n_cycles, 1),
                "outer_loop": "device",
                "solve_time_s": solve_time,
            }
            return self._deliver(x, df, b_np is None, info), info

        # the host loop consumes concrete arrays
        if df:
            if b_dev[1] is None:
                b_dev = (b_dev[0], jnp.zeros_like(b_dev[0]))
            if x is None:
                x = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
        elif x is None:
            x = jnp.zeros(shape, self.residual_mode)

        cycle_times = []
        converged = False
        t_start = time.perf_counter()
        for k in range(start_cycle, limit + 1):
            if df:
                if self._exact_terms is not None:
                    r_pair, rnorm = _residual_norm_df_exact(
                        h.fine_hi.offsets, self._exact_terms, b_dev, x
                    )
                else:
                    r_pair, rnorm = _residual_norm_df(
                        h.fine_hi, h.fine_hi_lo, b_dev, x
                    )
                r = r_pair[0]
            else:
                r, rnorm = _residual_norm(h.fine_hi, b_dev, x)
            rnorm = float(rnorm)
            history.append(rnorm)
            if cfg.verbose:
                print(f"[openmg_tpu] cycle {k}: ‖r‖ = {rnorm:.3e}")
            if rnorm < cfg.threshold:
                converged = True
                break
            if k == limit:
                break
            t0 = time.perf_counter()
            e = self._cycle(h, r)
            if df:
                x = df_add_f32(x, e)
                x[0].block_until_ready()
            else:
                x = x + e.astype(self.residual_mode)
                x.block_until_ready()
            cycle_times.append(time.perf_counter() - t0)
            if checkpoint_path is not None and (k + 1) % checkpoint_every == 0:
                save_checkpoint(
                    checkpoint_path,
                    df_merge(x) if df else np.asarray(x, dtype=np.float64),
                    k + 1,
                    history,
                    cfg_hash,
                )

        info = {
            "residual_norms": history,
            "cycles": len(history) - 1,
            "converged": converged,
            "final_norm": history[-1],
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "transfer": h.transfer.name,
            "residual_mode": "doublefloat" if df else str(self.residual_mode),
            "cycle_times_s": cycle_times,
            "mean_cycle_time_s": (
                float(np.mean(cycle_times[1:] or cycle_times))
                if cycle_times
                else float("nan")
            ),
            "outer_loop": "host",
            "solve_time_s": time.perf_counter() - t_start,
        }
        return self._deliver(x, df, b_np is None, info), info

    def solve_many(self, bs, x0s=None):
        """Solve ``A x = b`` for a batch of right-hand sides in ONE
        vmapped device program (the production many-rhs serving path).

        ``bs``: ``(K, *grid)`` (or a list of grid arrays).  The batched
        ``lax.while_loop`` runs lockstep until every rhs converges (a
        converged lane's iterate is frozen by the in-loop ``lax.cond``),
        so wall time tracks the slowest rhs — but all K solves share one
        dispatch, one sync, and every kernel launch, which at small-to-
        medium grids is dominant.  On the CPU, batched == scalar solves
        bit-exactly (tests/test_solver.py).

        Returns ``(xs, info)``: ``xs`` stacked like :meth:`solve` returns
        (f32 device array for f32 jax-array input, else float64 numpy);
        ``info`` carries per-rhs ``cycles``/``converged``/``final_norm``
        lists and the per-rhs ``residual_norms`` histories.
        """
        cfg = self.config
        h = self.hierarchy
        shape = self.grid_shape
        df = self.residual_mode == "doublefloat"
        limit = cfg.cycles if cfg.cycles > 0 else 10_000

        device_native = isinstance(bs, jax.Array) and bs.dtype == jnp.float32
        if device_native:
            b_dev = bs.reshape((bs.shape[0],) + shape)
        else:
            b_np = np.stack(
                [np.asarray(b, dtype=np.float64).reshape(shape) for b in bs]
            )
        K = int(b_dev.shape[0]) if device_native else b_np.shape[0]
        if x0s is not None:
            x0_np = np.stack(
                [np.asarray(x, dtype=np.float64).reshape(shape) for x in x0s]
            )
        else:
            x0_np = None

        if df:
            b_in = (
                (b_dev, None)
                if device_native
                else df_split(b_np)
            )
            x_in = None if x0_np is None else df_split(x0_np)
        else:
            b_in = (
                b_dev.astype(self.residual_mode)
                if device_native
                else jnp.asarray(b_np, dtype=self.residual_mode)
            )
            x_in = (
                None
                if x0_np is None
                else jnp.asarray(x0_np, dtype=self.residual_mode)
            )

        static = dict(
            limit=limit,
            threshold=float(cfg.threshold),
            pre=cfg.pre_iterations,
            post=cfg.post_iterations,
            smoother=cfg.smoother,
            cycle_type=cfg.cycle_type,
            krylov=cfg.krylov,
            krylov_iters=cfg.krylov_iters,
            omega=cfg.omega,
            cycle_dtype=self.dtype,
            df=df,
            exact_terms=self._exact_terms,
        )

        t_start = time.perf_counter()
        # The vmapped program is CACHED on the solver: a bare
        # ``jax.vmap(lambda ...)`` would re-run the batching transform
        # over the whole solve jaxpr on every call.  The hierarchy is a
        # runtime ARGUMENT (in_axes=None), never a closure — a closed-over
        # hierarchy bakes every level array into the lowered module as
        # HLO constants.
        key = x_in is None
        if not hasattr(self, "_solve_many_prog"):
            self._solve_many_prog = {}
        if key not in self._solve_many_prog:
            if key:
                fn = lambda h_, b1: _solve_device(h_, b1, None, **static)
                axes = (None, 0)
            else:
                fn = lambda h_, b1, x1: _solve_device(h_, b1, x1, **static)
                axes = (None, 0, 0)
            self._solve_many_prog[key] = jax.jit(jax.vmap(fn, in_axes=axes))
        if x_in is None:
            x_out, metas = self._solve_many_prog[key](h, b_in)
        else:
            x_out, metas = self._solve_many_prog[key](h, b_in, x_in)

        from openmg_tpu.utils.observe import unpack_solve_meta

        metas_np = np.asarray(metas)  # one D2H sync for the whole batch
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
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "transfer": h.transfer.name,
            "residual_mode": "doublefloat" if df else str(self.residual_mode),
            "outer_loop": "device",
            "solve_time_s": solve_time,
        }
        if not df:
            xs = x_out
            return (
                xs if device_native else np.asarray(xs, dtype=np.float64)
            ), info
        if device_native:
            info["x_df"] = x_out
            return x_out[0], info
        return df_merge(x_out), info

    @staticmethod
    def _deliver(x, df, device_native, info):
        """Result delivery policy: a host caller (numpy/f64 input — the
        reference-parity path) gets the exact float64 merge on host; a
        device-native caller (f32 jax-array input) gets the f32 solution
        as a device array with the full-precision ``(hi, lo)`` pair in
        ``info['x_df']`` — never a device→host→device round trip."""
        if not df:
            if device_native:
                return x
            return np.asarray(x, dtype=np.float64)
        if device_native:
            info["x_df"] = x
            return x[0]
        return df_merge(x)


@functools.partial(
    jax.jit,
    static_argnames=(
        "limit",
        "threshold",
        "pre",
        "post",
        "smoother",
        "cycle_type",
        "krylov",
        "krylov_iters",
        "omega",
        "cycle_dtype",
        "df",
        "exact_terms",
    ),
)
def _solve_device(
    h,
    b,
    x,
    *,
    limit,
    threshold,
    pre,
    post,
    smoother,
    cycle_type,
    krylov,
    krylov_iters,
    omega,
    cycle_dtype,
    df,
    exact_terms=None,
):
    """Whole-solve program: outer defect-correction loop as a
    ``lax.while_loop`` with a device-side convergence check and in-loop
    residual-history recording — one dispatch per solve and no host
    round-trip for the norm check.

    ``x`` is the iterate pytree — a ``(hi, lo)`` double-float pair when
    ``df`` else a plain array; ``None`` components (zero initial guess /
    exactly-representable rhs) are materialized *inside* the program, so
    they are never transferred from the host.  History slot k holds ‖r‖
    *before* cycle k; semantics match the host loop cycle for cycle.
    """
    from jax import lax

    if df:
        b_hi, b_lo = b
        if b_lo is None:
            b_lo = jnp.zeros_like(b_hi)
        b = (b_hi, b_lo)
        if x is None:
            x = (jnp.zeros_like(b_hi), jnp.zeros_like(b_hi))
    elif x is None:
        x = jnp.zeros_like(b)

    def resid(xx):
        if df:
            if exact_terms is not None:
                r_pair, rn = _residual_norm_df_exact_t(
                    h.fine_hi.offsets, exact_terms, b, xx
                )
            else:
                r_pair, rn = _residual_norm_df_t(
                    h.fine_hi, h.fine_hi_lo, b, xx
                )
            return r_pair[0], rn
        return _residual_norm_t(h.fine_hi, b, xx)

    def apply_cycle(xx, r):
        e = _inner_solve(
            h,
            r.astype(cycle_dtype),
            cycle_type=cycle_type,
            pre=pre,
            post=post,
            smoother=smoother,
            omega=omega,
            krylov=krylov,
            krylov_iters=krylov_iters,
        )
        if df:
            return df_add_f32(xx, e)
        return xx + e.astype(b.dtype)

    hist0 = jnp.full((limit + 1,), -1.0, dtype=jnp.float32)

    def cond_fn(st):
        _, k, _, done = st
        return jnp.logical_and(jnp.logical_not(done), k <= limit)

    def body_fn(st):
        xx, k, hist, _ = st
        r, rn = resid(xx)
        hist = hist.at[k].set(rn.astype(jnp.float32))
        done = rn < threshold
        do_cycle = jnp.logical_and(jnp.logical_not(done), k < limit)
        xx = lax.cond(
            do_cycle,
            lambda op: apply_cycle(op[0], op[1]),
            lambda op: op[0],
            (xx, r),
        )
        return (xx, k + 1, hist, done)

    x, k, hist, done = lax.while_loop(
        cond_fn, body_fn, (x, jnp.int32(0), hist0, jnp.bool_(False))
    )
    return x, pack_solve_meta(k, hist, done)


def _residual_norm_t(fine_hi, b, x):
    from openmg_tpu.ops.stencil import residual as stencil_residual

    r = stencil_residual(fine_hi, b, x)
    return r, jnp.sqrt(jnp.sum(r * r))


def _residual_norm_df_t(A_hi, A_lo, b_df, x_df):
    """Double-float residual ``r = b − A x`` with compensated accumulation;
    all-f32 code (the accelerator's default 1e-10 path).  Works for both varying
    and constant operators (scalar coefficients broadcast)."""
    acc = b_df
    for k, off in enumerate(A_hi.offsets):
        xs = (shift(x_df[0], off), shift(x_df[1], off))
        term = df_mul((A_hi.coeff(k), A_lo.coeff(k)), xs)
        acc = df_sub(acc, term)
    rn = jnp.sqrt(jnp.sum(acc[0] * acc[0]))
    return acc, rn


def _residual_norm_df_exact_t(offsets, terms, b_df, x_df):
    """Double-float residual for a constant operator whose taps are sums
    of signed powers of two (``terms[k] = pow2_terms(values[k])``, static):
    every product ``p·x`` is exact in f32, so the whole Dekker two_prod
    machinery drops away and only compensated adds remain — ~2.5× fewer
    VPU flops than :func:`_residual_norm_df_t` (measured 6.7 → ~2.5 ms at
    256³).  Exactness: scaling both components of a double-float by the
    same power of two preserves the non-overlapping (hi, lo) invariant."""
    acc = b_df
    for off, tp in zip(offsets, terms):
        xh = shift(x_df[0], off)
        xl = shift(x_df[1], off)
        for p in tp:
            pf = jnp.float32(p)
            acc = df_sub(acc, (pf * xh, pf * xl))
    rn = jnp.sqrt(jnp.sum(acc[0] * acc[0]))
    return acc, rn


def exact_residual_terms(hierarchy):
    """Static per-tap power-of-two decompositions of the fine operator, or
    None when the exact fast path does not apply (varying coefficients, a
    nonzero double-float lo part, or non-dyadic taps)."""
    fh, fl = hierarchy.fine_hi, hierarchy.fine_hi_lo
    if fl is None or not fh.is_constant or not fl.is_constant:
        return None
    if np.any(np.asarray(fl.values)):
        return None
    terms = tuple(pow2_terms(float(v)) for v in np.asarray(fh.values))
    if any(t is None for t in terms):
        return None
    return terms


@functools.partial(
    jax.jit,
    static_argnames=(
        "pre",
        "post",
        "smoother",
        "cycle_type",
        "krylov",
        "krylov_iters",
        "omega",
        "cycle_dtype",
    ),
)
def _cycle_step(
    hierarchy,
    r,
    *,
    pre,
    post,
    smoother,
    cycle_type,
    krylov,
    krylov_iters,
    omega,
    cycle_dtype,
):
    """One error-correction step: e ~= A^-1 r in the cycle dtype."""
    return _inner_solve(
        hierarchy,
        r.astype(cycle_dtype),
        cycle_type=cycle_type,
        pre=pre,
        post=post,
        smoother=smoother,
        omega=omega,
        krylov=krylov,
        krylov_iters=krylov_iters,
    )


_residual_norm = jax.jit(_residual_norm_t)
_residual_norm_df = jax.jit(_residual_norm_df_t)
_residual_norm_df_exact = jax.jit(
    _residual_norm_df_exact_t, static_argnums=(0, 1)
)


def setup(
    problem, config: SolverConfig | None = None, *, faced: bool = True
) -> Solver:
    """Build a :class:`Solver`.

    ``problem`` is a :class:`ProblemConfig`, a grid shape tuple (Poisson is
    assembled), or an ``(offsets, coeffs)`` stencil pair.  ``faced`` allows
    the boundary-corrected constant level representation (see
    build_hierarchy_structured); the distributed builder disables it.
    """
    config = config or SolverConfig()
    if config.transfer not in TRANSFERS:
        raise ValueError(
            f"unknown transfer {config.transfer!r}; choose from {sorted(TRANSFERS)}"
        )
    rmode = _resolve_residual_mode(config.residual_dtype) or jnp.dtype(config.dtype)
    # Poisson problems: assemble + coarsen with jnp (the structured builder
    # places the work; the f32 assembly is exact — Poisson coefficients
    # are small integers)
    shape_like = (
        problem.shape
        if isinstance(problem, ProblemConfig)
        else problem
        if isinstance(problem, tuple)
        and all(isinstance(s, (int, np.integer)) for s in problem)
        else None
    )
    common = dict(
        gridlevels=config.gridlevels,
        dtype=jnp.dtype(config.dtype),
        residual_dtype=rmode,
        transfer=TRANSFERS[config.transfer],
        max_dense_coarse=config.max_dense_coarse,
        min_coarse_dim=config.min_coarse_dim,
    )
    if shape_like is not None:
        from openmg_tpu.core.hierarchy import build_hierarchy_structured
        from openmg_tpu.models.poisson import poisson_offsets

        d = len(shape_like)
        fine_values = [2.0 * d] + [-1.0] * (2 * d)
        hierarchy = build_hierarchy_structured(
            poisson_offsets(d),
            fine_values,
            shape_like,
            faced=faced,
            **common,
        )
    elif isinstance(problem, tuple) and len(problem) == 2:
        offsets, coeffs = problem
        hierarchy = build_hierarchy(
            offsets, coeffs, setup_dtype=config.setup_dtype, **common
        )
    else:
        raise TypeError(f"unsupported problem spec: {type(problem)}")
    return Solver(hierarchy, config)


def solve(problem, b, config: SolverConfig | None = None, x0=None):
    """One-shot native API: setup + solve."""
    return setup(problem, config).solve(b, x0)


def mg_solve(A, b, parameters: dict):
    """Reference-compatible driver (SURVEY.md R7 vocabulary).

    ``A``: scipy sparse / dense matrix over the grid named by
    ``parameters['problemshape']``, or ``None`` to assemble the Poisson
    operator.  ``b``: flat or grid-shaped right-hand side.  Returns
    ``(x, info)`` with ``x`` flat, matching the reference's
    vector-in/vector-out surface.

    Engine selection (``parameters["format"]`` / ``SolverConfig.format``):
    with the default ``"auto"``, the exact stencil form of ``A`` is
    extracted and the gather-free stencil engine runs; matrices that are
    not stencil-representable (or an explicit ``format`` of
    "ell"/"csr"/"bsr") fall back to the general padded-static-nnz sparse
    engine (:mod:`openmg_tpu.core.algebraic`) — the reference accepts any
    sparse SPD matrix over the grid, so both paths are first-class.
    """
    if "problemshape" not in parameters:
        raise ValueError("parameters must include 'problemshape'")
    shape = tuple(int(s) for s in parameters["problemshape"])
    config = SolverConfig.from_parameters(parameters)
    fmt = config.format
    if A is None and fmt in ("auto", "stencil"):
        solver = setup(poisson_stencil(shape), config)
    elif fmt in ("ell", "csr", "bsr", "dense"):
        from openmg_tpu.core.algebraic import setup_sparse
        from openmg_tpu.models.poisson import poisson

        A_in = poisson(shape) if A is None else A
        solver = setup_sparse(A_in, shape, config)
    else:
        import scipy.sparse as sp

        A_sp = sp.csr_matrix(A)
        try:
            stencil = stencil_from_csr(A_sp, shape)
        except ValueError:
            if fmt == "stencil":
                raise
            from openmg_tpu.core.algebraic import setup_sparse

            solver = setup_sparse(A_sp, shape, config)
        else:
            solver = setup(stencil, config)
    x, info = solver.solve(b)
    return np.asarray(x).reshape(-1), info
