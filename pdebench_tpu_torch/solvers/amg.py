"""Smoothed-aggregation algebraic multigrid (SA-AMG) preconditioner, the
solve route of meshes whose dofs form no lattice (the hypre / ilu roles of
the dataset's solver configs).

  - SETUP on the host (numpy / scipy), the reference's own: a
    strength-of-connection graph, greedy aggregation, the tentative
    prolongator from a near-nullspace (ones, or elasticity's rigid-body
    modes), the smoothed prolongator P = (I - omega D^-1 A) P0, Galerkin
    coarse operators A_c = P^T A P, down to a dense pseudo-inverse of the
    coarsest operator. Array-equal to the reference's hierarchy.
  - APPLY on the device: a V-cycle of damped Jacobi (one pre- and one
    post-sweep, each level's omega) in PyTorch ops. Every level's A, P and
    P^T is its own row-ordered `DeviceCSR` (the restriction is a row
    gather, not a scatter), each row summed in a fixed order, so a V-cycle
    gives the same bits on every call; the coarsest level is one dense
    matrix product.

Also `constrained_csr`: the Dirichlet-constrained CSR matrix that the
lattice route's surrogate hierarchy is probed from.

Port of pdebench_tpu/solvers/amg.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.sparse as sps
import torch

# ---------------------------------------------------------------------------
# device-side sparse matvec (padded rows, a fixed summation order)
# ---------------------------------------------------------------------------


class DeviceCSR:
    """A host sparse matrix on the device as padded rows: each row's
    column indices and values in CSR order, padded to the widest row with
    a column that reads the zero appended to x. y = A x is one gather, one
    product and one sum along each row: the same order on every call (a
    scatter-add's atomics would vary the last bits from call to call)."""

    def __init__(self, A: sps.spmatrix, device, dtype=torch.float64):
        A = sps.csr_matrix(A)
        n, m = A.shape
        counts = np.diff(A.indptr)
        width = max(int(counts.max()) if n else 0, 1)
        rows = np.repeat(np.arange(n), counts)
        slot = np.arange(A.nnz) - A.indptr[rows]
        cols = np.full((n, width), m, dtype=np.int64)
        vals = np.zeros((n, width))
        cols[rows, slot] = A.indices
        vals[rows, slot] = A.data
        self.shape = (n, m)
        self.nnz = int(A.nnz)
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, dtype=dtype, device=device)

    def astype(self, dtype) -> "DeviceCSR":
        out = object.__new__(DeviceCSR)
        out.shape, out.nnz, out.cols = self.shape, self.nnz, self.cols
        out.vals = self.vals.to(dtype)
        return out

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xz = torch.cat([x, x.new_zeros(1)])
        return (self.vals * xz[self.cols]).sum(dim=1)

    def to_scipy(self) -> sps.csr_matrix:
        """The stored matrix back on the host (padding dropped)."""
        cols = self.cols.cpu().numpy()
        vals = self.vals.cpu().numpy()
        keep = cols < self.shape[1]
        rows = np.nonzero(keep)[0]
        return sps.csr_matrix((vals[keep], (rows, cols[keep])), shape=self.shape)


# ---------------------------------------------------------------------------
# setup (host)
# ---------------------------------------------------------------------------


def _strength_graph(A: sps.csr_matrix, theta: float) -> sps.csr_matrix:
    """Symmetric strength-of-connection filter."""
    d = np.sqrt(np.abs(A.diagonal()))
    d[d == 0] = 1.0
    coo = A.tocoo()
    scale = d[coo.row] * d[coo.col]
    keep = (np.abs(coo.data) > theta * scale) | (coo.row == coo.col)
    return sps.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape
    )


def _aggregate(S: sps.csr_matrix) -> np.ndarray:
    """Greedy standard aggregation; returns agg id per node (-1 none)."""
    n = S.shape[0]
    agg = -np.ones(n, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    next_agg = 0
    # pass 1: roots with no aggregated neighbors
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if np.any(agg[nbrs] != -1):
            continue
        agg[i] = next_agg
        agg[nbrs] = next_agg
        next_agg += 1
    # pass 2: attach stragglers to a neighboring aggregate
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        assigned = agg[nbrs]
        good = assigned[assigned != -1]
        if len(good):
            agg[i] = good[0]
        else:
            agg[i] = next_agg
            next_agg += 1
    return agg


def _condense_blocks(A: sps.csr_matrix, bs: int) -> sps.csr_matrix:
    """Node-level graph from a blocked dof matrix: |block| Frobenius."""
    coo = A.tocoo()
    rows = coo.row // bs
    cols = coo.col // bs
    n_nodes = A.shape[0] // bs
    return sps.csr_matrix(
        (coo.data**2, (rows, cols)), shape=(n_nodes, n_nodes)
    ).sqrt()


def _tentative_prolongator(
    agg: np.ndarray, B: np.ndarray
) -> Tuple[sps.csr_matrix, np.ndarray]:
    """SA tentative prolongator from near-nullspace B (n, k).

    Per aggregate: QR of B's rows -> k orthonormal columns of P0; R
    stacks into the coarse-level near-nullspace. Aggregates are batched
    by size so the QR runs as a few batched np.linalg.qr calls.
    """
    n, k = B.shape
    nc = int(agg.max()) + 1
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=nc)
    starts = np.concatenate([[0], np.cumsum(sizes)])

    rows = np.empty(n * k, dtype=np.int64)
    cols = np.empty(n * k, dtype=np.int64)
    vals = np.empty(n * k, dtype=np.float64)
    Bc = np.zeros((nc * k, k))
    ptr = 0

    for size in np.unique(sizes):
        aggs = np.nonzero(sizes == size)[0]
        if size == 0 or len(aggs) == 0:
            continue
        # (m, size) node indices for all aggregates of this size
        idx = np.stack(
            [order[starts[a] : starts[a] + size] for a in aggs]
        )
        Ba = B[idx]  # (m, size, k)
        kk = min(k, size)
        Q, R = np.linalg.qr(Ba)  # Q (m, size, k'), R (m, k', k)
        m = len(aggs)
        # scatter Q into P0 columns [a*k, a*k+kk)
        r = np.repeat(idx[:, :, None], kk, axis=2).reshape(-1)
        c = (
            aggs[:, None, None] * k + np.arange(kk)[None, None, :]
        )
        c = np.broadcast_to(c, (m, size, kk)).reshape(-1)
        v = Q[:, :, :kk].reshape(-1)
        cnt = len(v)
        rows[ptr : ptr + cnt] = r
        cols[ptr : ptr + cnt] = c
        vals[ptr : ptr + cnt] = v
        ptr += cnt
        for j, a in enumerate(aggs):
            Bc[a * k : a * k + kk, :] = R[j, :kk, :]

    P0 = sps.csr_matrix(
        (vals[:ptr], (rows[:ptr], cols[:ptr])), shape=(n, nc * k)
    )
    return P0, Bc


def _jacobi_omega(A: sps.csr_matrix, iters: int = 10) -> float:
    """Damping 1/rho(D^-1 A) (x 0.9) via power iteration — keeps the
    smoother contractive even when off-diagonal coupling is strong
    (near-incompressible elasticity breaks the usual 2/3 choice)."""
    d = A.diagonal()
    d[d == 0] = 1.0
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        x = (A @ x) / d
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        lam = nrm
        x /= nrm
    return float(0.9 / max(lam, 1e-12))


@dataclass
class AMGLevel:
    A: DeviceCSR
    diag_inv: torch.Tensor
    P: DeviceCSR  # to the NEXT (coarser) level
    R: DeviceCSR  # P^T, its own row-ordered copy (restriction)
    omega: float = 2.0 / 3.0  # level-specific damped-Jacobi weight


@dataclass
class AMG:
    levels: List[AMGLevel]
    coarse_inv: torch.Tensor  # dense pseudo-inverse of the coarsest operator
    pre_smooth: int = 1
    post_smooth: int = 1

    def precond(self) -> Callable:
        """One V-cycle r -> M r (in the levels' dtype)."""

        def vcycle(level: int, r: torch.Tensor) -> torch.Tensor:
            if level == len(self.levels):
                return self.coarse_inv @ r
            lv = self.levels[level]
            x = torch.zeros_like(r)
            for _ in range(self.pre_smooth):
                x = x + lv.omega * lv.diag_inv * (r - lv.A.matvec(x))
            res = r - lv.A.matvec(x)
            xc = vcycle(level + 1, lv.R.matvec(res))
            x = x + lv.P.matvec(xc)
            for _ in range(self.post_smooth):
                x = x + lv.omega * lv.diag_inv * (r - lv.A.matvec(x))
            return x

        return lambda r: vcycle(0, r)

    def astype(self, dtype) -> "AMG":
        """Every level cast to `dtype` (the f32 V-cycle of mixed-precision
        refinement)."""
        return AMG(
            levels=[
                AMGLevel(
                    A=lv.A.astype(dtype),
                    diag_inv=lv.diag_inv.to(dtype),
                    P=lv.P.astype(dtype),
                    R=lv.R.astype(dtype),
                    omega=lv.omega,
                )
                for lv in self.levels
            ],
            coarse_inv=self.coarse_inv.to(dtype),
            pre_smooth=self.pre_smooth,
            post_smooth=self.post_smooth,
        )


def setup_amg(
    A: sps.spmatrix,
    theta: float = 0.08,
    max_levels: int = 12,
    coarse_size: int = 300,
    omega_smooth: float = 2.0 / 3.0,
    B: Optional[np.ndarray] = None,
    block_size: int = 1,
    device="cpu",
) -> AMG:
    """Build the SA-AMG hierarchy from a (constrained) CSR matrix, its
    levels on `device` in float64.

    B: near-nullspace (n, k) — ones for scalar diffusion (default),
    rigid-body modes for elasticity (see rigid_body_modes). block_size:
    dofs per mesh node at the finest level (aggregation happens on the
    node graph so vector components stay together).

    NOTE: Dirichlet identity rows are decoupled singletons that stall
    aggregation — strip them first (setup_amg_masked) or pass an
    unconstrained SPD matrix.
    """
    A = A.tocsr()
    if B is None:
        B = np.ones((A.shape[0], 1))
    B = np.asarray(B, dtype=np.float64)
    bs = int(block_size)
    levels: List[AMGLevel] = []
    while A.shape[0] > coarse_size and len(levels) < max_levels:
        An = _condense_blocks(A, bs) if bs > 1 else A
        S = _strength_graph(An, theta)
        agg_nodes = _aggregate(S)
        agg = np.repeat(agg_nodes, bs) if bs > 1 else agg_nodes
        P0, Bc = _tentative_prolongator(agg, B)
        if P0.shape[1] >= 0.85 * A.shape[0]:  # aggregation stalled
            break
        d = A.diagonal()
        d[d == 0] = 1.0
        Dinv = sps.diags(1.0 / d)
        P = P0 - omega_smooth * (Dinv @ (A @ P0))
        Ac = (P.T @ A @ P).tocsr()
        Ac.eliminate_zeros()
        diag = A.diagonal()
        diag[diag == 0] = 1.0
        levels.append(
            AMGLevel(
                A=DeviceCSR(A, device),
                diag_inv=torch.as_tensor(1.0 / diag, device=device),
                P=DeviceCSR(P, device),
                R=DeviceCSR(P.T, device),
                omega=_jacobi_omega(A),
            )
        )
        A = Ac
        B = Bc
        bs = B.shape[1]
    coarse_inv = torch.as_tensor(np.linalg.pinv(A.toarray()), device=device)
    return AMG(levels=levels, coarse_inv=coarse_inv)


def rigid_body_modes(dof_coords: np.ndarray, ncomp: int) -> np.ndarray:
    """Rigid-body near-nullspace for elasticity, blocked-interleaved.

    dof_coords: (n_nodes, dim) scalar-dof coordinates. 2-D: two
    translations + one rotation (3 modes); 3-D: three + three (6).
    """
    x = np.asarray(dof_coords)
    n, dim = x.shape
    if ncomp != dim:
        raise ValueError(f"rigid-body modes need ncomp == dim, got {ncomp} and {dim}")
    k = 3 if dim == 2 else 6
    B = np.zeros((n * dim, k))
    for c in range(dim):  # translations
        B[c::dim, c] = 1.0
    if dim == 2:
        B[0::2, 2] = -x[:, 1]
        B[1::2, 2] = x[:, 0]
    else:
        # rotations about z, x, y
        B[0::3, 3] = -x[:, 1]
        B[1::3, 3] = x[:, 0]
        B[1::3, 4] = -x[:, 2]
        B[2::3, 4] = x[:, 1]
        B[0::3, 5] = x[:, 2]
        B[2::3, 5] = -x[:, 0]
    return B


def _free_hierarchy(A, mask, B, block_size, device, kwargs) -> Tuple[AMG, np.ndarray]:
    """The hierarchy of the free-dof submatrix A_ff (Dirichlet rows would
    be permanent aggregation singletons), and the mask as a bool array."""
    m = np.asarray(mask, dtype=bool)
    free = np.nonzero(~m)[0]
    A_ff = A.tocsr()[free][:, free]
    if B is not None:
        B = np.asarray(B)[free]
    if block_size > 1 and len(free) % block_size != 0:
        # partial-node constraints: fall back to scalar aggregation
        block_size = 1
    return setup_amg(A_ff, B=B, block_size=block_size, device=device, **kwargs), m


def setup_amg_masked(
    A: sps.spmatrix,
    mask: np.ndarray,
    B: Optional[np.ndarray] = None,
    block_size: int = 1,
    device="cpu",
    **kwargs,
) -> Callable:
    """AMG preconditioner for the constrained system: the hierarchy of
    the free-dof submatrix, as a closure on full-length residuals (V-cycle
    on the free part, identity on constrained entries).

    With block_size > 1, constrained dofs are eliminated per whole node
    (vector BCs constrain all components together in this benchmark),
    keeping the node-block structure intact on the submatrix.
    """
    amg, m = _free_hierarchy(A, mask, B, block_size, device, kwargs)
    return masked_precond(amg, m)


def masked_precond(amg: AMG, mask: np.ndarray) -> Callable:
    """Wrap a free-dof AMG hierarchy as a full-length preconditioner."""
    m = np.asarray(mask, dtype=bool)
    device = amg.coarse_inv.device
    free = torch.as_tensor(np.nonzero(~m)[0], device=device)
    mask_t = torch.as_tensor(m, device=device)
    vcycle = amg.precond()
    n = len(m)

    def precond(r: torch.Tensor) -> torch.Tensor:
        # in r's dtype: a float32 vector through a float64 hierarchy (the
        # saddle preconditioner in MINRES-IR's float32 recurrence) comes
        # back float32, as the reference's `.at[free].set` casts it
        out = r.new_zeros(n)
        out[free] = vcycle(r[free]).to(r.dtype)
        return torch.where(mask_t, r, out)

    return precond


def setup_amg_masked_pair(
    A: sps.spmatrix,
    mask: np.ndarray,
    B: Optional[np.ndarray] = None,
    block_size: int = 1,
    device="cpu",
    **kwargs,
):
    """(M64, M32) preconditioner closures sharing one hierarchy setup —
    the f32 variant feeds mixed-precision iterative refinement; and the
    hierarchy itself."""
    amg, m = _free_hierarchy(A, mask, B, block_size, device, kwargs)
    return masked_precond(amg, m), masked_precond(amg.astype(torch.float32), m), amg


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
