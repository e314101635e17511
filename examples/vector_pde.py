#!/usr/bin/env python
"""Vector-PDE solves through BSR hierarchies (models/elasticity.py).

The reference is a scalar-Poisson testbed; this framework adds
dense-block vector operators — the case BSR exists for (``ops/bsr.py``:
a scalar layout pads the block structure ~B×; the blocked-band BSR SpMV
reads no indices):

* 2D plane-strain linear elasticity (2 dofs/node, the ∂xy cross term
  couples components through purely off-diagonal 2×2 corner blocks);
* a B-species coupled reaction–diffusion system (every node-pair block
  dense B×B, SPD by construction).

``setup_sparse(..., dofs=B)`` treats the shape as the NODE grid and
builds block transfers ``R_node ⊗ I_B``, keeping every Galerkin level
block-banded.

    python examples/vector_pde.py [--shape 64 64]
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs="+", default=[64, 64])
    args = ap.parse_args()
    shape = tuple(args.shape)

    import scipy.sparse.linalg as spla

    from openmg_tpu import SolverConfig, elasticity, setup_sparse

    A = elasticity(shape, lam=1.0, mu=1.0)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    b /= np.linalg.norm(b)

    cfg = SolverConfig(
        smoother="rbgs", transfer="linear", format="bsr", blocksize=2,
        gridlevels=3, max_dense_coarse=4096, cycles=200, threshold=1e-9,
    )
    solver = setup_sparse(A, shape, cfg, dofs=2)
    fine = solver.hierarchy.levels[0].A
    print(f"elasticity {shape}: {A.shape[0]} dofs, fine BSR "
          f"kb={fine.kb} blocksize={fine.blocksize} "
          f"banded={fine.slot_offsets is not None}")

    x, info = solver.solve(b)
    x_dir = spla.spsolve(A.tocsc(), b)
    print(f"converged={info['converged']} cycles={info['cycles']} "
          f"final={info['final_norm']:.2e} "
          f"max|x - x_direct|={np.abs(x - x_dir).max():.2e}")


if __name__ == "__main__":
    main()
