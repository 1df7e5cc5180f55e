"""Host sparse-direct fallback (scipy SuperLU).

TPUs have no sparse LU; the reference leans on UMFPACK/MUMPS for
saddle-point and `preonly/lu` cases (reference: dealii stokes.cc:338-369,
oracle/stokes.py:253-257). We mirror that capability with a host-side
factorization reached from the normal numpy path (oracle solves
orchestrate on host; only the iterative hot loops live on device).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla


def _splu(A_csc):
    """splu with a switchable fill-reducing ordering.

    scipy's default is COLAMD; for the symmetric-pattern saddle systems
    the NS/Stokes oracles factor, MMD_AT_PLUS_A orders on the pattern of
    A^T+A and typically yields sparser factors (SuperLU user guide).
    Opt-in via PDEBENCH_TPU_SPLU_PERMC until A/B'd on the bench host
    (PLAN_r4 #3c).
    """
    permc = os.environ.get("PDEBENCH_TPU_SPLU_PERMC", "")
    if permc:
        return spla.splu(A_csc, permc_spec=permc)
    return spla.splu(A_csc)


def solve_direct_constrained(
    A: sps.spmatrix,
    b: np.ndarray,
    mask: Optional[np.ndarray] = None,
    g: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Solve A x = b with Dirichlet dofs (mask) pinned to values g.

    Eliminates constrained dofs symmetrically: A_ff x_f = b_f - A_fg g.
    """
    A = A.tocsr()
    n = A.shape[0]
    if mask is None:
        return _splu(A.tocsc()).solve(np.asarray(b))
    mask = np.asarray(mask, dtype=bool)
    g = np.zeros(n) if g is None else np.asarray(g, dtype=np.float64)
    free = np.nonzero(~mask)[0]
    fixed = np.nonzero(mask)[0]
    A_ff = A[free][:, free].tocsc()
    rhs = np.asarray(b)[free] - A[free][:, fixed] @ g[fixed]
    x = np.array(g, dtype=np.float64)
    x[free] = _splu(A_ff).solve(rhs)
    return x


def lu_factorization(A_ff: sps.spmatrix):
    """Cache-friendly handle for repeated solves (transient problems)."""
    return _splu(A_ff.tocsc())


class ConstrainedLU:
    """Reusable constrained factorization: factor once, back-substitute
    many times.

    The Shamanskii/frozen-Jacobian Newton variant in the NS oracle
    (oracle/navier_stokes.py) re-uses one SuperLU factorization for
    several Newton steps — a back-substitution is ~50x cheaper than a
    fresh factor on this host, and each stale step is accepted only if
    it still reduces the residual. Semantics match
    solve_direct_constrained(A, b, mask, g) exactly on the first solve.
    """

    def __init__(self, A: sps.spmatrix, mask: Optional[np.ndarray] = None):
        A = A.tocsr()
        self.n = A.shape[0]
        if mask is None:
            self.mask = None
            self.lu = _splu(A.tocsc())
            return
        mask = np.asarray(mask, dtype=bool)
        self.mask = mask
        self.free = np.nonzero(~mask)[0]
        self.fixed = np.nonzero(mask)[0]
        self.A_fg = A[self.free][:, self.fixed]
        self.lu = _splu(A[self.free][:, self.free].tocsc())

    def solve(
        self, b: np.ndarray, g: Optional[np.ndarray] = None
    ) -> np.ndarray:
        if self.mask is None:
            return self.lu.solve(np.asarray(b))
        g = np.zeros(self.n) if g is None else np.asarray(g, np.float64)
        rhs = np.asarray(b)[self.free] - self.A_fg @ g[self.fixed]
        x = np.array(g, dtype=np.float64)
        x[self.free] = self.lu.solve(rhs)
        return x
