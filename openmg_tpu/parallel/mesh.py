"""Device mesh construction and multi-host bootstrap (component T16).

The reference has no distribution layer at all (SURVEY.md §2A: no MPI/NCCL).
Here the communication substrate is JAX/XLA collectives (NCCL on GPUs):
a ``jax.sharding.Mesh`` over the devices in ``jax.devices()`` order,
``jax.distributed.initialize`` for multi-process bootstrap, and
``shard_map``-scoped ``lax.ppermute`` / ``all_gather`` / ``psum`` used by
the halo-exchange and coarse-redistribution layers (SURVEY.md §5.8).

The solver partitions along a single named axis (grid axis 0 ↔ mesh axis
``"x"``): halo traffic is neighbor-only.  The cards of one host are joined
all to all by NVLink, so the device order needs no topology mapping.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "initialize_distributed",
    "row_sharding",
    "replicated_sharding",
]


def make_mesh(n_devices=None, axis_name: str = "x", devices=None) -> Mesh:
    """1D solver mesh over the first ``n_devices`` of ``jax.devices()``
    (default: all); explicit ``devices`` are laid out in the order given.
    """
    if devices is None:
        all_devices = jax.devices()
        n = n_devices or len(all_devices)
        if n > len(all_devices):
            raise ValueError(f"requested {n} devices, have {len(all_devices)}")
        devices = np.array(all_devices[:n])
    return Mesh(np.asarray(devices).reshape(-1), (axis_name,))


def make_mesh_2d(shape, axis_names=("host", "chip"), devices=None) -> Mesh:
    """2-level ``(n_hosts, devices_per_host)`` mesh (SURVEY.md
    §4.2-3/§5.8).  The solver partitions grid axis 0 across BOTH axes
    (collectives take the axis-name tuple; ``lax.axis_index`` over the
    tuple is the linearized host-major device index, verified on the
    virtual 8-device mesh), so ring-neighbor halo ppermutes cross hosts
    only at the host boundary of the contiguous-row-block layout."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if devices is None:
        all_devices = jax.devices()
        if n > len(all_devices):
            raise ValueError(f"requested {n} devices, have {len(all_devices)}")
        devices = np.array(all_devices[:n]).reshape(shape)
    return Mesh(np.asarray(devices).reshape(shape), tuple(axis_names))


def initialize_distributed(**kwargs) -> None:
    """Multi-host bootstrap: one process per host, same program everywhere.

    Thin wrapper over ``jax.distributed.initialize``; pass
    ``coordinator_address``, ``num_processes`` and ``process_id`` where no
    cluster environment provides them.  Call before any device use; no-op
    if already initialized.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # Only benign re-initialization is swallowed; a genuine bootstrap
        # failure (bad coordinator address, port clash, …) must surface
        # here, not later as a confusing 1-process mesh.
        msg = str(e).lower()
        # JAX has used several wordings across versions: "already
        # initialized", "was called more than once", and (0.9.x)
        # "distributed.initialize should only be called once."
        if (
            "already initialized" in msg
            or "more than once" in msg
            or "only be called once" in msg
        ):
            return
        if "must be called before" in msg:
            # the XLA backend is already up in this process (e.g. tests,
            # or a late call after device use) — bootstrap is impossible
            # now; warn so a multi-host user notices instead of running
            # a 1-process mesh
            import warnings

            warnings.warn(
                "initialize_distributed() called after the XLA backend "
                "was initialized — running single-process",
                RuntimeWarning,
                stacklevel=2,
            )
            return
        raise
    except ValueError:
        # single-process environment with no coordinator (e.g. local CPU
        # or a lone card): nothing to bootstrap — a true no-op
        pass


def row_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    """NamedSharding partitioning grid axis ``axis`` across the mesh."""
    spec = [None] * ndim
    spec[axis] = mesh.axis_names[0]
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
