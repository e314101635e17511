"""Solver / problem / mesh configuration (components T14, §5.6).

The reference drives everything from a ``parameters`` dict with defaults
filled in by the driver (``problemshape``, ``gridlevels``, ``iterations``,
``cycles``, ``threshold``, ``verbose`` — SURVEY.md R7/§5.6).  The build uses
frozen dataclasses with the same vocabulary so reference configs translate
1:1; :func:`SolverConfig.from_parameters` performs that translation and
:func:`openmg_tpu.core.solver.mg_solve` accepts the raw dict directly.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["SolverConfig", "ProblemConfig", "MeshConfig"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Multigrid solver configuration.

    gridlevels: number of levels (None → full depth by factor-2 coarsening).
    pre_iterations: pre-smoothing sweeps per level visit (reference
        ``iterations``).
    post_iterations: post-smoothing sweeps (reference default had none;
        build default 1 for a symmetric cycle).
    cycles: max outer V-cycles (0 → unlimited-with-safety-cap).
    threshold: absolute ‖r‖₂ convergence target (reference semantics).
    smoother: "jacobi" | "rbgs" | "chebyshev" (4th-kind Chebyshev
        polynomial smoothing — order-free like Jacobi but with an
        optimal-polynomial damping schedule; `iterations` is the
        polynomial degree).
    cycle_type: "v" (reference-parity V-cycle) | "w" (W-cycle: two coarse
        visits per level — more robust, ~2x coarse work) | "f" (full
        multigrid: coarsest-first pass, ~1.3x a V-cycle per pass and
        roughly halves the outer cycle count).
    krylov: "none" (pure multigrid, reference-parity) | "pcg" — each outer
        defect-correction step runs `krylov_iters` MG-preconditioned
        conjugate-gradient iterations instead of one bare cycle; the
        robust choice for rough/jumping coefficients.
    krylov_iters: CG iterations (= cycles) per outer step with krylov="pcg".
    omega: weighted-Jacobi damping (2/3 is optimal for 1D Poisson; a robust
        all-round default).
    dtype: cycle computation dtype (f32 by default).
    transfer: intergrid transfer spec — "aggregate" is the reference's
        piecewise-constant scheme (parity default); "linear" is
        vertex-centered full-weighting/linear interpolation (much better
        convergence rate; recommended for performance runs).
    residual_dtype: outer residual / iterative-refinement precision; the
        f32 V-cycle acts as the preconditioner of a defect-correction loop
        evaluated at this precision, which is how 1e-10 absolute residuals
        are reached (SURVEY.md §7 "Hard parts", Plan A).  Choices:
        "doublefloat" (two-f32 compensated arithmetic, no f64 on
        device), "float64" (requires jax_enable_x64), "float32", None
        (same as dtype), or "auto" (default: float64 on CPU when x64 is
        enabled, else doublefloat).
    max_dense_coarse: largest coarsest-level size solved by the
        precomputed dense solve (T8).
    outer_loop: where the outer defect-correction loop runs — "device"
        (one jitted program: ``lax.while_loop`` with on-device convergence
        check and history recording; no host round-trip per cycle),
        "host" (Python loop, one sync per cycle — required for verbose
        streaming and checkpointing), or "auto" (default: device unless
        verbose or checkpointing asks for the host loop).
    format: operator storage for the cycle — "auto" (stencil fast path
        when the matrix is grid-structured, else ELL), or force one of
        "stencil" | "ell" | "csr" | "bsr" (the padded-static-nnz general
        containers, SURVEY.md T1) | "dense" (the reference's
        ``dense=True`` debug mode — densified operators, SpMV as one
        matmul; small problems only).
    blocksize: BSR block edge (square blocks) when format="bsr".
    """

    gridlevels: Optional[int] = None
    pre_iterations: int = 2
    post_iterations: int = 2
    cycles: int = 100
    threshold: float = 1e-10
    smoother: str = "rbgs"
    cycle_type: str = "v"
    krylov: str = "none"
    krylov_iters: int = 2
    omega: float = 2.0 / 3.0
    transfer: str = "aggregate"  # "aggregate" (reference-parity) | "linear"
    dtype: str = "float32"
    residual_dtype: Optional[str] = "auto"
    setup_dtype: str = "float32"  # RAP-chain precision (see build_hierarchy)
    max_dense_coarse: int = 512
    min_coarse_dim: int = 1
    format: str = "auto"
    blocksize: int = 4
    outer_loop: str = "auto"
    verbose: bool = False

    def __post_init__(self):
        # fail at construction, not hours later at trace time
        _check = {
            "smoother": ("jacobi", "rbgs", "chebyshev"),
            "cycle_type": ("v", "w", "f"),
            "krylov": ("none", "pcg", None),
            "transfer": ("aggregate", "linear"),
            "format": ("auto", "stencil", "ell", "csr", "bsr", "dense"),
            "outer_loop": ("auto", "device", "host"),
        }
        for field, allowed in _check.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"{field}={v!r}; choose from "
                    f"{sorted(str(a) for a in allowed if a is not None)}"
                )

    @staticmethod
    def from_parameters(parameters: dict) -> "SolverConfig":
        """Translate a reference-style ``parameters`` dict (R7 vocabulary)."""
        p = dict(parameters)
        known = {
            "gridlevels": p.pop("gridlevels", None),
            "pre_iterations": p.pop("iterations", 2),
            "cycles": p.pop("cycles", 100),
            "threshold": p.pop("threshold", 1e-10),
            "verbose": p.pop("verbose", False),
        }
        p.pop("problemshape", None)  # carried by ProblemConfig
        if p.pop("dense", False):  # reference debug toggle → dense engine
            known["format"] = "dense"
        for extra in (
            "post_iterations",
            "smoother",
            "cycle_type",
            "krylov",
            "krylov_iters",
            "omega",
            "transfer",
            "dtype",
            "residual_dtype",
            "setup_dtype",
            "max_dense_coarse",
            "min_coarse_dim",
            "format",
            "blocksize",
            "outer_loop",
        ):
            if extra in p:
                known[extra] = p.pop(extra)
        if p:
            raise ValueError(f"unknown parameters: {sorted(p)}")
        return SolverConfig(**known)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "SolverConfig":
        return SolverConfig(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Problem description: a Poisson grid (reference `problemshape`)."""

    shape: Tuple[int, ...]
    rhs: str = "random"  # "random" | "ones"
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed solver (T9/T16).

    n_devices: mesh size along the partition axis (None → all local devices).
    axis_name: mesh axis name used by shard_map collectives.
    min_rows_per_device: levels whose axis-0 extent per device would fall
        below this (or lose factor-2 divisibility) are replicated instead of
        partitioned (coarse-level redistribution, T11).
    overlap_halo: structure partitioned smoothing/SpMV so the ppermute halo
        exchange carries no dependency from the interior compute (the
        BASELINE T10 overlap); False selects the plain
        exchange-then-compute reference path.
    mesh_shape: optional (n_hosts, devices_per_host) for a 2-level mesh
        (SURVEY.md §4.2-3/§5.8): the solver's partition axis spans BOTH
        mesh axes — collectives take the axis-name tuple, and neighbor
        ppermute traffic crosses hosts only at host boundaries.  None → 1D
        mesh of ``n_devices``.
    axis_names: mesh axis names used with ``mesh_shape``.
    force_partition: debug/validation mode — mark levels *partitioned*
        even on a 1-device mesh.  ``halo_planes`` degenerates to zero
        planes with no collective there, so the compiled program is
        exactly the per-device multi-device program (halo-aware sweeps +
        cornered fix-ups), which lets one device compile-check the
        partitioned path.
    """

    n_devices: Optional[int] = None
    axis_name: str = "x"
    min_rows_per_device: int = 2
    overlap_halo: bool = True
    mesh_shape: Optional[tuple] = None
    axis_names: tuple = ("host", "chip")
    force_partition: bool = False
