"""Quadrature-batched FEM assembly as dense cell-local tensors (scalar part).

Assembly stays *regular*: geometry factors (n_cells, nq, ...), local
matrices (n_cells, nl, nl) from one einsum, and the operator apply as
gather -> batched matvec -> scatter-add. The local-matrix batch IS the
sparse matrix; a CSR export feeds the host sparse-direct fallback.

Host data stays host data: `xeinsum` runs numpy for numpy operands and
torch (on the operand's device) as soon as one operand is a tensor, so
the geometry and the constant-coefficient fast paths run in numpy while
coefficients evaluated onto a device (fem/symbolic.py) keep the einsum
on that device.

Port of the scalar half of pdebench_tpu/fem/assemble.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import refelem
from .mesh import Mesh


def _any_torch(*ops) -> bool:
    """True when any operand is a torch tensor."""
    return any(isinstance(o, torch.Tensor) for o in ops)


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    """`a` as a float64 tensor on ref's device."""
    return torch.as_tensor(a, dtype=torch.float64, device=ref.device)


def xeinsum(spec: str, *ops):
    """einsum that stays on the HOST for host data.

    All-numpy operands run np.einsum; if any operand is a tensor, the
    numpy ones move to its device and torch.einsum runs there."""
    ts = [o for o in ops if isinstance(o, torch.Tensor)]
    if ts:
        return torch.einsum(spec, *[_like(o, ts[0]) for o in ops])
    return np.einsum(spec, *ops, optimize=True)


# ---------------------------------------------------------------------------
# Geometry factors
# ---------------------------------------------------------------------------


@dataclass
class CellBatch:
    """Static tabulation + per-cell geometry, ready for batched assembly.

    Shapes: nq quadrature points, nl local basis fns, d spatial dim.
    For affine cells (simplices) the per-q geometry axis has extent 1 and
    broadcasts. All arrays are host numpy.
    """

    cell_type: str
    degree: int
    phi: np.ndarray  # (nq, nl)
    dphi: np.ndarray  # (nq, nl, d)
    d2phi: np.ndarray  # (nq, nl, d, d) reference hessians
    qw: np.ndarray  # (nq,)
    qpts: np.ndarray  # (n_cells, nq, d) physical quadrature points
    invJ: np.ndarray  # (n_cells, nq|1, d, d); matrix inverse of J, so
    #                    dxi_k/dx_d = invJ[..., d, k]
    detJ: np.ndarray  # (n_cells, nq|1) |det J|

    @property
    def n_cells(self) -> int:
        return self.qpts.shape[0]

    @property
    def wdetJ(self) -> np.ndarray:  # (n_cells, nq)
        return self.qw[None, :] * np.broadcast_to(
            self.detJ, (self.qpts.shape[0], self.qw.shape[0])
        )

    def grad_phys(self) -> np.ndarray:
        """Physical basis gradients (n_cells, nq, nl, d), computed once
        host-side and cached."""
        gp = getattr(self, "_grad_phys", None)
        if gp is None:
            gp = np.einsum("qik,cqdk->cqid", self.dphi, self.invJ)
            object.__setattr__(self, "_grad_phys", gp)
        return gp

    def affine_host(self):
        """(invJ_c, detJ_c) for the affine-host fast paths, else None.

        Affine cells (simplices) carry per-cell-constant geometry
        (q-axis extent 1), so weak forms separate into a small
        reference-element tensor times a per-cell metric — assembly
        becomes ONE host GEMM instead of an einsum over the materialized
        (c, nq, nl, d) physical-gradient array."""
        if self.invJ.shape[1] != 1 or self.detJ.shape[1] != 1:
            return None
        return self.invJ[:, 0], self.detJ[:, 0]

    def _ref_tensor(self, name: str, builder):
        t = getattr(self, name, None)
        if t is None:
            t = builder()
            object.__setattr__(self, name, t)
        return t


def _det_inv(J: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batched explicit det/inverse for 1x1/2x2/3x3 trailing dims."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = 1.0 / det[..., None, None]
        return det, inv
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = (
            np.stack([np.stack([e, -b], -1), np.stack([-c, a], -1)], -2)
            / det[..., None, None]
        )
        return det, inv
    if d == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv = (
            np.stack(
                [
                    np.stack([c00, c10, c20], -1),
                    np.stack([c01, c11, c21], -1),
                    np.stack([c02, c12, c22], -1),
                ],
                -2,
            )
            / det[..., None, None]
        )
        return det, inv
    raise ValueError(f"unsupported dim {d}")


def cell_batch(mesh: Mesh, degree: int, qdegree: Optional[int] = None) -> CellBatch:
    """Build geometry factors for a mesh/element/quadrature combination
    (host numpy)."""
    if qdegree is None:
        qdegree = 2 * degree + 2
    t = refelem.element_tables(mesh.cell_type, degree, qdegree)
    verts = np.asarray(mesh.coords[mesh.cells])  # (c, nv, d)
    gphi = np.asarray(t.geom_phi)
    gdphi = np.asarray(t.geom_dphi)
    qpts = np.einsum("qv,cvd->cqd", gphi, verts, optimize=True)
    if refelem.is_simplex(mesh.cell_type):
        # affine: evaluate Jacobian at a single point
        J = np.einsum(
            "vk,cvd->ckd", gdphi[0], verts, optimize=True
        )[:, None]  # (c,1,k,d)
    else:
        J = np.einsum("qvk,cvd->cqkd", gdphi, verts, optimize=True)
    det, invJ = _det_inv(J)
    detJ = np.abs(det)
    return CellBatch(
        cell_type=mesh.cell_type,
        degree=degree,
        phi=np.asarray(t.phi),
        dphi=np.asarray(t.dphi),
        d2phi=np.asarray(t.d2phi),
        qw=np.asarray(t.qweights),
        qpts=qpts,
        invJ=invJ,
        detJ=detJ,
    )


# ---------------------------------------------------------------------------
# Local (cell-batched) weak-form kernels — each one einsum
# ---------------------------------------------------------------------------


def _weights(cb: CellBatch, coef_q):
    """cb.wdetJ times an optional coefficient (numpy, or tensor on its
    device)."""
    if coef_q is None:
        return cb.wdetJ
    if isinstance(coef_q, torch.Tensor):
        return _like(cb.wdetJ, coef_q) * coef_q
    return cb.wdetJ * coef_q


def local_stiffness(cb: CellBatch, coef_q=None):
    """∫ coef ∇u·∇v : (n_cells, nl, nl)."""
    aff = cb.affine_host()
    if aff is not None and not _any_torch(coef_q):
        iJ, detJ = aff  # iJ: (c, d, k) with dxi_k/dx_d = iJ[c, d, k]
        c = iJ.shape[0]
        nq, nl, d = cb.dphi.shape
        C = np.matmul(iJ.transpose(0, 2, 1), iJ)  # metric (c, k, l)
        if coef_q is None:
            S = cb._ref_tensor(
                "_S_stiff",
                lambda: np.einsum(
                    "q,qik,qjl->klij", cb.qw, cb.dphi, cb.dphi
                ).reshape(d * d, nl * nl),
            )
            A = C.reshape(c, d * d) @ S
        else:
            S2 = cb._ref_tensor(
                "_S_stiff_q",
                lambda: np.einsum(
                    "qik,qjl->qklij", cb.dphi, cb.dphi
                ).reshape(nq * d * d, nl * nl),
            )
            wq = np.broadcast_to(cb.qw[None, :] * np.asarray(coef_q), (c, nq))
            W2 = (wq[:, :, None] * C.reshape(c, 1, d * d)).reshape(
                c, nq * d * d
            )
            A = W2 @ S2
        return A.reshape(c, nl, nl) * detJ[:, None, None]
    g = cb.grad_phys()
    return xeinsum("cqid,cqjd,cq->cij", g, g, _weights(cb, coef_q))


def local_load(cb: CellBatch, f_q):
    """∫ f v : (n_cells, nl)."""
    return xeinsum("qi,cq->ci", cb.phi, _weights(cb, f_q))


# ---------------------------------------------------------------------------
# Matrix-free global operator
# ---------------------------------------------------------------------------


def scatter_add(
    cell_vals: torch.Tensor, dofmap: torch.Tensor, ndof: int
) -> torch.Tensor:
    """(n_cells, nl) local contributions -> (ndof,) global vector.

    index_add_ sums duplicates in an unspecified order on CUDA (atomics),
    so the last bits may change from run to run there."""
    out = torch.zeros(ndof, dtype=cell_vals.dtype, device=cell_vals.device)
    return out.index_add_(0, dofmap.reshape(-1), cell_vals.reshape(-1))


class LocalOperator:
    """Global linear operator stored as cell-local dense matrices.

    apply:  y = scatter( A_c @ u[dofmap_c] ).
    """

    def __init__(self, A_local: torch.Tensor, dofmap: np.ndarray, ndof: int):
        self.A = A_local  # (n_cells, nl, nl)
        self.dofmap = torch.as_tensor(
            np.asarray(dofmap), dtype=torch.int64, device=A_local.device
        )
        self.ndof = int(ndof)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        ue = u[self.dofmap]  # (c, nl)
        ve = torch.einsum("cij,cj->ci", self.A, ue)
        return scatter_add(ve, self.dofmap, self.ndof)

    def diagonal(self) -> torch.Tensor:
        d = torch.einsum("cii->ci", self.A)
        return scatter_add(d, self.dofmap, self.ndof)

    def to_scipy(self):
        """COO -> CSR on host, for the sparse-direct fallback."""
        import scipy.sparse as sps

        nl = self.A.shape[1]
        dm = self.dofmap.cpu().numpy()
        rows = np.repeat(dm, nl, axis=1).reshape(-1)
        cols = np.tile(dm, (1, nl)).reshape(-1)
        vals = self.A.detach().cpu().numpy().reshape(-1)
        return sps.coo_matrix(
            (vals, (rows, cols)), shape=(self.ndof, self.ndof)
        ).tocsr()


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions (symmetric elimination, matrix-free)
# ---------------------------------------------------------------------------


def bc_mask_values(
    ndof: int, dofs: np.ndarray, values: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    mask = np.zeros(ndof, dtype=bool)
    vals = np.zeros(ndof)
    mask[dofs] = True
    vals[dofs] = values
    return (
        torch.as_tensor(mask, device=device),
        torch.as_tensor(vals, device=device),
    )


def constrained_operator(apply_A: Callable, mask: torch.Tensor) -> Callable:
    """A with Dirichlet rows/cols replaced by identity (keeps SPD)."""

    def op(v):
        vz = torch.where(mask, 0.0, v)
        y = apply_A(vz)
        return torch.where(mask, v, y)

    return op


def constrained_rhs(
    apply_A: Callable, b: torch.Tensor, mask: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """b - A g on free dofs; g on constrained dofs."""
    gz = torch.where(mask, g, 0.0)
    r = b - apply_A(gz)
    return torch.where(mask, g, r)
