#!/usr/bin/env python
"""Per-level profile of the 3D Poisson solve on one NVIDIA GPU.

    python bench.py [--shape 256 256 256] [--out chiprun_out/bench]

Configuration: the ``chip_smoke.py`` main path (RB-GS 2+2, linear
transfers, double-float outer residual, ‖b‖ = 1 from a seed, absolute
threshold 1e-10).  It measures, in one process on one card:

* the copy bandwidth the card reaches (``y = a·x`` on a 1 GiB f32 array,
  read + write bytes over the median time);
* the warm solve time (``block_until_ready``) and the cycle count;
* per-level device time from one ``jax.profiler`` trace of a warm solve:
  kernel durations on the device timeline, attributed to V-cycle levels
  through each event's ``hlo_op`` and the ``level<k>`` name scopes
  (:mod:`openmg_tpu.core.cycle`) in the compiled program's metadata;
  kernels outside every level scope are the outer defect-correction step;
* for each level, the bytes one visit must move if every operation makes
  one pass over its arrays (:func:`level_bytes`), and that traffic over the
  measured copy bandwidth.

It fails unless the first JAX device is a GPU.  Every line it prints is
JSON and names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import re
import time
from pathlib import Path

import numpy as np

from chip_smoke import card_names, device_check, main_config, unit_rhs


def copy_bandwidth(n_bytes: int = 1 << 30, reps: int = 20) -> float:
    """Bytes per second of ``y = a·x`` (read + write) on an f32 array."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((n_bytes // 4,), jnp.float32)
    a = jnp.float32(1.0000001)
    scale = jax.jit(lambda v, s: v * s)
    jax.block_until_ready(scale(x, a))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(scale(x, a))
        times.append(time.perf_counter() - t0)
    return 2 * n_bytes / float(np.median(times))


def level_bytes(n: int, pre: int, post: int, coarse_n: int) -> int:
    """Bytes one visit of an n-point f32 level moves when every operation
    makes one pass: each RB-GS half-sweep reads x and b and writes x (3n),
    the residual reads b and x and writes r (3n), restriction reads r and
    writes the coarse rhs (n + c), prolongation + add reads x and the
    coarse correction and writes x (2n + c), with c the next level's
    points.  Constant-coefficient levels read no coefficient arrays."""
    half_sweeps = 2 * (pre + post)
    floats = 3 * n * half_sweeps + 3 * n + (n + coarse_n) + (2 * n + coarse_n)
    return 4 * floats


def hlo_levels(hlo_text: str) -> dict:
    """Instruction name → ``level<k>`` / ``outer`` / ``unattributed`` for
    a compiled module's text.  A fusion takes the most common level among
    the ``op_name`` metadata of the instructions it calls, since the
    fusion instruction itself often carries none."""
    comp_ops = collections.defaultdict(list)
    insts = {}
    cur = None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            cur = re.sub(r"^ENTRY\s+", "", line).split()[0].lstrip("%")
            continue
        m = re.match(r"\s+(?:ROOT\s+)?%?([\w.\-]+) = ", line)
        if m is None or cur is None:
            continue
        ops = re.findall(r'op_name="([^"]*)"', line)
        calls = re.findall(r"calls=%?([\w.\-]+)", line)
        comp_ops[cur].extend(ops)
        insts[m.group(1)] = (ops, calls)

    levels = {}
    for name, (ops, calls) in insts.items():
        names = list(ops)
        for c in calls:
            names += comp_ops.get(c, [])
        lv = collections.Counter(
            f"level{re.findall(r'level(\d+)', o)[-1]}"
            for o in names if re.search(r"level\d+", o)
        )
        if lv:
            levels[name] = lv.most_common(1)[0][0]
        else:
            levels[name] = "outer" if names else "unattributed"
        # kernel names are the fusion names with "." → "_"
        levels.setdefault(name.replace(".", "_"), levels[name])
    return levels


def compiled_hlo(solver, b) -> str:
    """Text of the compiled solve program ``solver.solve(b)`` runs (same
    arguments, so the same instruction names as in a trace of it)."""
    from openmg_tpu.core.solver import _solve_device

    c = solver.config
    static = dict(
        limit=c.cycles, threshold=float(c.threshold), pre=c.pre_iterations,
        post=c.post_iterations, smoother=c.smoother, cycle_type=c.cycle_type,
        krylov=c.krylov, krylov_iters=c.krylov_iters, omega=c.omega,
        cycle_dtype=solver.dtype, df=True, exact_terms=solver._exact_terms,
    )
    return _solve_device.lower(
        solver.hierarchy, (b, None), None, **static
    ).compile().as_text()


def device_time_by_level(xplane_path: str, levels: dict,
                         plane_prefix: str = "/device:GPU") -> tuple:
    """Sum kernel and copy durations (seconds) per level over the planes
    whose name starts with ``plane_prefix``, keyed through each event's
    ``hlo_op`` — or, inside a command buffer (CUDA graph), where that is
    the buffer, through the kernel's own name; also returns up to 5 event
    names with no known instruction."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = collections.Counter()
    missed = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = str(dict(ev.stats).get("hlo_op"))
                key = levels.get(op) or levels.get(ev.name, "unattributed")
                out[key] += ev.duration_ns * 1e-9
                if key == "unattributed" and len(missed) < 5:
                    if ev.name not in missed:
                        missed.append(ev.name)
    return dict(out), missed


def busy_share(xplane_path: str, plane_prefix: str = "/device:GPU") -> tuple:
    """``(busy_s, window_s)`` of the matching planes: the union of event
    intervals, and the span from the first event's start to the last
    event's end.  The idle share is ``1 - busy_s / window_s``."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    iv = sorted(
        (ev.start_ns, ev.end_ns)
        for plane in pd.planes
        if plane.name.startswith(plane_prefix)
        for line in plane.lines
        for ev in line.events
    )
    if not iv:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy * 1e-9, (max(e for _, e in iv) - iv[0][0]) * 1e-9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs="+", default=[256, 256, 256])
    ap.add_argument("--out", default="chiprun_out/bench")
    args = ap.parse_args(argv)

    import jax

    device = device_check(jax)
    card = card_names().splitlines()[0]
    jax.config.update("jax_enable_x64", True)

    from openmg_tpu import setup
    from openmg_tpu.utils.cache import use_compile_cache

    use_compile_cache()

    def emit(rec):
        print(json.dumps({"card": card, **rec}, default=float), flush=True)

    emit({"device": device})
    bw = copy_bandwidth()
    emit({"copy_bandwidth_B_per_s": bw})

    shape = tuple(args.shape)
    cfg = main_config()
    solver = setup(shape, cfg)
    b = unit_rhs(shape)
    x, info = solver.solve(b)
    jax.block_until_ready(info["x_df"])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        jax.block_until_ready(info["x_df"])
        times.append(time.perf_counter() - t0)
    cycles = info["cycles"]
    emit({"shape": list(shape), "cycles": cycles,
          "solve_s": float(np.median(times)), "solve_s_all": times})

    outdir = Path(args.out) / "trace"
    with jax.profiler.trace(str(outdir)):
        x, info = solver.solve(b)
        jax.block_until_ready(info["x_df"])
    xplane = sorted(glob.glob(str(outdir / "**" / "*.xplane.pb"),
                              recursive=True))[-1]
    hlo = compiled_hlo(solver, b)
    (outdir / "solve_device.hlo.txt").write_text(hlo)
    by_level, missed = device_time_by_level(xplane, hlo_levels(hlo))

    sizes = [int(np.prod(s[0])) for s in solver.hierarchy.stats]
    for lv, n in enumerate(sizes):
        key = f"level{lv}"
        rec = {"level": lv, "points": n,
               "device_s_per_cycle": by_level.get(key, 0.0) / max(cycles, 1)}
        if lv < len(sizes) - 1:
            nbytes = level_bytes(n, cfg.pre_iterations, cfg.post_iterations,
                                 sizes[lv + 1])
            rec["one_pass_bytes"] = nbytes
            rec["one_pass_bytes_over_copy_bw_s"] = nbytes / bw
        emit(rec)
    busy, window = busy_share(xplane)
    emit({"device_busy_s": busy, "device_window_s": window,
          "device_idle_share": 1.0 - busy / window if window else None,
          "outer_device_s_per_solve": by_level.get("outer", 0.0),
          "unattributed_device_s": by_level.get("unattributed", 0.0),
          "unattributed_names": missed,
          "kernel_s_sum": sum(by_level.values())})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
