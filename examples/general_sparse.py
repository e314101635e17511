#!/usr/bin/env python
"""General-sparse engine tour: solving with ELL/CSR/BSR operators.

The reference accepts any sparse SPD matrix over the grid
(``mg_solve(A, b, parameters)``, SURVEY.md R7); this framework routes
stencil-representable matrices to the gather-free stencil engine and
everything else to the padded-static-nnz sparse engine
(``core/algebraic.py``).  Matrices whose ELL slots are offset-regular
(``col == row + d_j`` per slot — the Poisson/banded family) additionally
take the gather-free banded SpMV (``ops/ell.py``): static shifted slices
of ``x`` instead of a gather.

    python examples/general_sparse.py [--shape 32 32 32]
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs="+", default=[32, 32, 32])
    args = ap.parse_args()
    shape = tuple(args.shape)

    import scipy.sparse.linalg as spla

    from openmg_tpu import mg_solve
    from openmg_tpu.models.poisson import poisson, rhs_random
    from openmg_tpu.ops.sparse import ell_from_scipy

    A = poisson(shape)
    b = rhs_random(shape, seed=0).ravel()

    # the ELL container detects the offset structure at build time
    M = ell_from_scipy(A)
    print(
        f"ELL: n={M.shape[0]} k={M.k} slot_offsets={M.slot_offsets} "
        f"banded={M.slot_offsets is not None}"
    )

    x_direct = spla.spsolve(A.tocsc(), b)
    for fmt in ("ell", "csr", "bsr", "dense" if A.shape[0] <= 4096 else None):
        if fmt is None:
            continue
        x, info = mg_solve(
            A,
            b,
            {
                "problemshape": shape,
                "format": fmt,
                "cycles": 100,
                "threshold": 1e-10,
            },
        )
        err = np.abs(x - x_direct).max()
        print(
            f"format={fmt:5s}: cycles={info['cycles']:2d} "
            f"converged={info['converged']} |x - direct|_inf = {err:.2e}"
        )


if __name__ == "__main__":
    main()
