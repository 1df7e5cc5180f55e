"""Dirichlet-constrained CSR matrices for the surrogate GMG route.

Only `constrained_csr` so far: attach_lattice_gmg's A_override route
constrains a DIFFERENT matrix (Helmholtz's shifted Laplacian) before its
stencil is probed into a hierarchy. The algebraic multigrid of the
reference (unstructured meshes) is not ported yet.

Port of part of pdebench_tpu/solvers/amg.py (numpy/scipy, host side).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps


def constrained_csr(A: sps.spmatrix, mask: np.ndarray) -> sps.csr_matrix:
    """Zero Dirichlet rows/cols, unit diagonal — matches the matrix-free
    constrained_operator so the hierarchy preconditions the right system.

    Computed as D_f A D_f + D_c with diagonal masks (pure sparse
    products — no slow lil indexing at 10^5+ dofs).
    """
    m = np.asarray(mask, dtype=bool)
    free = sps.diags((~m).astype(np.float64))
    fixed = sps.diags(m.astype(np.float64))
    return (free @ A @ free + fixed).tocsr()
