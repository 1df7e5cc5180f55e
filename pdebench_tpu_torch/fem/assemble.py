"""Quadrature-batched FEM assembly as dense cell-local tensors.

Assembly stays *regular*: geometry factors (n_cells, nq, ...), local
matrices (n_cells, nl, nl) from one einsum, and the operator apply as
gather -> batched matvec -> scatter-add. The local-matrix batch IS the
sparse matrix; a CSR export feeds the host sparse-direct fallback.

Host data stays host data: `xeinsum` runs numpy for numpy operands and
torch (on the operand's device) as soon as one operand is a tensor, so
the geometry and the constant-coefficient fast paths run in numpy while
coefficients evaluated onto a device (fem/symbolic.py) keep the einsum
on that device.

Port of the scalar, convection-diffusion (advection, SUPG), elasticity
and Taylor-Hood forms of pdebench_tpu/fem/assemble.py.
"""

from __future__ import annotations

import copy
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

    def on(self, name: str, device) -> torch.Tensor:
        """A float64 copy on `device` of one of this batch's host arrays
        ("phi", "wdetJ", "grad_phys"; "wphi" is wdetJ[c, q] phi[q, i]),
        made once per device: a per-step assembly on the device reads it
        every step and must not copy it from the host each time."""
        device = torch.device(device)
        cache = self._ref_tensor("_on_device", dict)
        key = (name, str(device))
        if key not in cache:
            host = {
                "phi": lambda: self.phi,
                "wdetJ": lambda: self.wdetJ,
                "grad_phys": self.grad_phys,
                "wphi": lambda: self.wdetJ[:, :, None] * self.phi[None],
            }[name]()
            cache[key] = torch.as_tensor(np.ascontiguousarray(host), dtype=torch.float64, device=device)
        return cache[key]

    def laplace_phys(self) -> np.ndarray:
        """Physical basis Laplacians (n_cells, nq, nl), exact for affine
        cell maps (simplices, axis-aligned rectangles): d2phi/dx_a dx_a =
        invJ[a, k] invJ[a, l] d2phi/dxi_k dxi_l. Computed once and cached."""
        return self._ref_tensor(
            "_laplace_phys",
            lambda: np.einsum("qikl,cqak,cqal->cqi", self.d2phi, self.invJ, self.invJ),
        )


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
    device, where wdetJ's device copy is made once)."""
    if coef_q is None:
        return cb.wdetJ
    if isinstance(coef_q, torch.Tensor):
        return cb.on("wdetJ", coef_q.device) * coef_q
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


def local_mass(cb: CellBatch, coef_q=None):
    """∫ coef u v : (n_cells, nl, nl); on coef_q's device when it is a
    tensor (a Newton Jacobian's R'(u) term, every iteration)."""
    if isinstance(coef_q, torch.Tensor):
        phi = cb.on("phi", coef_q.device)
        return torch.einsum("qi,qj,cq->cij", phi, phi, _weights(cb, coef_q))
    return xeinsum("qi,qj,cq->cij", cb.phi, cb.phi, _weights(cb, coef_q))


def local_load(cb: CellBatch, f_q):
    """∫ f v : (n_cells, nl)."""
    return xeinsum("qi,cq->ci", cb.phi, _weights(cb, f_q))


# The convection-diffusion forms take host numpy operands and run on the
# host, as the reference's do: a device beta would turn the (SUPG)
# assembly into dozens of small device einsums. `local_advection` also
# takes a device beta, for the per-step batch of Burgers' lagged
# convection.


def local_advection(cb: CellBatch, beta_q):
    """∫ (β·∇u) v with β (n_cells, nq, d) : (n_cells, nl, nl), row index
    = test function v. A tensor β keeps the whole form on its device: two
    contractions, (β·∇φ_j) at every quadrature point, then the batched
    product with wdetJ φ_i (the device copies of the geometry made once,
    `CellBatch.on`)."""
    if isinstance(beta_q, torch.Tensor):
        dev = beta_q.device
        bg = torch.einsum("cqjd,cqd->cqj", cb.on("grad_phys", dev), beta_q)
        return torch.einsum("cqi,cqj->cij", cb.on("wphi", dev), bg)
    aff = cb.affine_host()
    if aff is not None:
        iJ, detJ = aff
        c = iJ.shape[0]
        nq, nl, d = cb.dphi.shape
        # β pulled back to reference coordinates: Bk[c, q, k] = β·(dxi_k/dx)
        Bk = np.einsum("cqd,cdk->cqk", beta_q, iJ)
        T = cb._ref_tensor(
            "_T_adv",
            lambda: np.einsum("q,qi,qjk->qkij", cb.qw, cb.phi, cb.dphi).reshape(nq * d, nl * nl),
        )
        Wb = (detJ[:, None, None] * Bk).reshape(c, nq * d)
        return (Wb @ T).reshape(c, nl, nl)
    g = cb.grad_phys()
    return xeinsum("qi,cqjd,cqd,cq->cij", cb.phi, g, beta_q, cb.wdetJ)


def local_supg(
    cb: CellBatch, beta_q: np.ndarray, tau_c: np.ndarray, epsilon: float
) -> np.ndarray:
    """SUPG stabilization ∫ tau (β·∇v)(β·∇u - ε Δu) : (n_cells, nl, nl);
    beta_q (n_cells, nq, d), tau_c (n_cells,) cell-wise tau. Δu from the
    exact physical basis Laplacians, nonzero from degree 2 on."""
    aff = cb.affine_host()
    if aff is not None:
        # β·∇φ via the reference pull-back (no (c, nq, nl, d) gradients)
        iJ, _ = aff
        Bk = np.einsum("cqd,cdk->cqk", beta_q, iJ)
        bg = np.einsum("qik,cqk->cqi", cb.dphi, Bk)
    else:
        bg = xeinsum("cqid,cqd->cqi", cb.grad_phys(), beta_q)  # β·∇φ
    w = cb.wdetJ * tau_c[:, None]
    out = xeinsum("cqi,cqj,cq->cij", bg, bg, w)
    if epsilon != 0.0:
        out = out - epsilon * xeinsum("cqi,cqj,cq->cij", bg, cb.laplace_phys(), w)
    return out


def local_supg_load(
    cb: CellBatch, beta_q: np.ndarray, tau_c: np.ndarray, f_q: np.ndarray
) -> np.ndarray:
    """SUPG right-hand side ∫ tau (β·∇v) f : (n_cells, nl)."""
    bg = xeinsum("cqid,cqd->cqi", cb.grad_phys(), beta_q)
    return xeinsum("cqi,cq->ci", bg, cb.wdetJ * tau_c[:, None] * f_q)


def _cellwise(cb: CellBatch, coef) -> Optional[np.ndarray]:
    """coef as a per-cell (c,) host array, or None if it varies per
    quadrature point or lives on a device."""
    if _any_torch(coef):
        return None
    a = np.asarray(coef)
    if a.ndim == 0:
        return np.full(cb.n_cells, float(a))
    if a.ndim == 1 and a.shape[0] == cb.n_cells:
        return a
    if a.ndim == 2 and a.shape == (cb.n_cells, 1):
        return a[:, 0]
    if a.ndim == 2 and np.all(a == a[:, :1]):
        return a[:, 0]
    return None


def local_elasticity(cb: CellBatch, mu, lam):
    """∫ 2 mu eps(u):eps(v) + lam div(u) div(v) over blocked vector dofs.

    mu/lam: scalars or (n_cells, nq) fields. Returns (n_cells, nl*d, nl*d)
    in the interleaved ordering of FunctionSpace.dofmap (node-major,
    component-minor). Expanded index form:
      K[(ia),(jb)] = ∫ mu (dphi_i/dx_b dphi_j/dx_a
                          + delta_ab grad phi_i . grad phi_j)
                     + lam dphi_i/dx_a dphi_j/dx_b
    """
    aff = cb.affine_host()
    mu_c = _cellwise(cb, mu)
    lam_c = _cellwise(cb, lam)
    if aff is not None and mu_c is not None and lam_c is not None:
        # separated form (see affine_host): with per-cell-constant
        # geometry AND coefficients, every elasticity term is (per-cell
        # d^2 x d^2 metric) @ (reference tensor): three GEMMs
        iJ, detJ = aff
        c = iJ.shape[0]
        nq, nl, d = cb.dphi.shape
        S = cb._ref_tensor(
            "_S_stiff4",
            lambda: np.einsum("q,qik,qjl->klij", cb.qw, cb.dphi, cb.dphi),
        )  # (k, l, i, j)
        S2 = S.reshape(d * d, nl * nl)
        wm = (detJ * mu_c)[:, None, None]
        wl = (detJ * lam_c)[:, None, None]
        # t2 (grad.grad) term: metric C[k,l] contraction
        C = np.matmul(iJ.transpose(0, 2, 1), iJ)  # (c, k, l)
        t2 = (C.reshape(c, d * d) @ S2).reshape(c, nl, nl) * wm
        # t1: E[(a,b),(k,l)] = iJ[b,k] iJ[a,l];  t3: iJ[a,k] iJ[b,l]
        E1 = np.einsum("cbk,cal->cabkl", iJ, iJ).reshape(c * d * d, d * d)
        E3 = np.einsum("cak,cbl->cabkl", iJ, iJ).reshape(c * d * d, d * d)
        t1 = (E1 @ S2).reshape(c, d, d, nl, nl) * wm[..., None, None]
        t3 = (E3 @ S2).reshape(c, d, d, nl, nl) * wl[..., None, None]
        # K[c, (i,a), (j,b)] from t1/t3 [c, a, b, i, j], plus the
        # delta_ab grad.grad term on the component diagonal
        K = (t1 + t3).transpose(0, 3, 1, 4, 2)
        for a in range(d):
            K[:, :, a, :, a] += t2
        return np.ascontiguousarray(K).reshape(c, nl * d, nl * d)
    g = cb.grad_phys()  # (c, q, i, d)
    wmu = _weights(cb, mu)
    wlam = _weights(cb, lam)
    d = g.shape[-1]
    t1 = xeinsum("cqib,cqja,cq->ciajb", g, g, wmu)
    t2 = xeinsum("cqid,cqjd,cq->cij", g, g, wmu)
    t3 = xeinsum("cqia,cqjb,cq->ciajb", g, g, wlam)
    K = t1 + t3 + xeinsum("cij,ab->ciajb", t2, np.eye(d))
    c, nl = K.shape[0], K.shape[1]
    return K.reshape(c, nl * d, nl * d)


def local_vector_load(cb: CellBatch, f_q):
    """∫ f . v with f_q (n_cells, nq, d) -> (n_cells, nl*d) interleaved."""
    b = xeinsum("qi,cqa,cq->cia", cb.phi, f_q, cb.wdetJ)
    c, nl, d = b.shape
    return b.reshape(c, nl * d)


# ---------------------------------------------------------------------------
# Matrix-free global operator
# ---------------------------------------------------------------------------


def scatter_add(
    cell_vals: torch.Tensor, dofmap: torch.Tensor, ndof: int
) -> torch.Tensor:
    """(n_cells, nl) local contributions -> (ndof,) global vector: the
    plain version GatherSum is held to (the port sums through GatherSum).

    index_add_ sums duplicates in an unspecified order on CUDA (atomics),
    so the last bits may change from run to run there."""
    out = torch.zeros(ndof, dtype=cell_vals.dtype, device=cell_vals.device)
    return out.index_add_(0, dofmap.reshape(-1), cell_vals.reshape(-1))


# GatherSum.many gathers at most this many values at once (its
# intermediate (rows, width, S) tensor stays a few hundred MB at f64)
GATHER_CHUNK = 1 << 24


class GatherSum:
    """scatter_add with a fixed summation order: (n_cells, nl) local
    contributions -> (ndof,) global vector, each dof the sum of its
    gathered contributions (index lists built once on the host from the
    dofmap). Same values as scatter_add up to rounding, the same on every
    call: index_add_'s atomics on CUDA vary the last bits from call to
    call, and a Newton loop's step and Krylov counts with them."""

    def __init__(self, dofmap: np.ndarray, ndof: int, device):
        self.ndof = int(ndof)
        flat = np.asarray(dofmap, dtype=np.int64).reshape(-1)
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=int(ndof))
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        seg = np.full((int(ndof), max(int(counts.max()), 1)), len(flat), dtype=np.int64)
        rows = np.repeat(np.arange(int(ndof)), counts)
        seg[rows, np.arange(len(flat)) - start[rows]] = order
        self.seg = torch.as_tensor(seg, device=device)

    def __call__(self, cell_vals: torch.Tensor) -> torch.Tensor:
        src = torch.cat([cell_vals.reshape(-1), cell_vals.new_zeros(1)])
        return src[self.seg].sum(dim=1)

    def many(self, cell_vals: torch.Tensor) -> torch.Tensor:
        """(S, ...) batch of S contributions -> (S, ndof), each row as
        __call__ sums it (a fixed order), the dofs taken in chunks of at
        most GATHER_CHUNK gathered values."""
        S = cell_vals.shape[0]
        src = torch.cat([cell_vals.reshape(S, -1), cell_vals.new_zeros(S, 1)], dim=1).T
        out = cell_vals.new_empty((self.ndof, S))
        rows = max(1, GATHER_CHUNK // (self.seg.shape[1] * S))
        for lo in range(0, self.ndof, rows):
            out[lo:lo + rows] = src[self.seg[lo:lo + rows]].sum(dim=1)
        return out.T.contiguous()


class LocalOperator:
    """Global linear operator stored as cell-local dense matrices.

    apply:  y = sum over cells of A_c @ u[dofmap_c], each dof's
    contributions summed through `gather_sum` in a fixed order: the same
    bits on every call on every device (index_add_'s atomics on CUDA vary
    the last ones).
    """

    def __init__(self, A_local: torch.Tensor, dofmap: np.ndarray, ndof: int):
        self.A = A_local  # (n_cells, nl, nl)
        self.dofmap = torch.as_tensor(
            np.asarray(dofmap), dtype=torch.int64, device=A_local.device
        )
        self.ndof = int(ndof)
        self._gather: Optional[GatherSum] = None
        self._cast = {}  # dtype -> this operator in that dtype: astype

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        ve = torch.einsum("cij,cj->ci", self.A, u[self.dofmap])
        return self.gather_sum()(ve)

    def diagonal(self) -> torch.Tensor:
        return self.gather_sum()(torch.einsum("cii->ci", self.A))

    def gather_sum(self) -> GatherSum:
        """The fixed-order sum into this operator's dofs, built once."""
        if self._gather is None:
            self._gather = GatherSum(self.dofmap.cpu().numpy(), self.ndof, self.A.device)
        return self._gather

    def with_local(self, A_local: torch.Tensor) -> "LocalOperator":
        """The operator of another cell batch on the same dofs (a step
        loop's fresh batch each step or Newton iteration), sharing the
        dofmap and the fixed-order sum: no gather plan is rebuilt."""
        self.gather_sum()
        twin = copy.copy(self)
        twin.A, twin._cast = A_local, {}
        return twin

    def astype(self, dtype) -> "LocalOperator":
        """This operator with its cell matrices in `dtype` (made once),
        sharing the dofmap and the fixed-order sum."""
        if self.A.dtype == dtype:
            return self
        if dtype not in self._cast:
            self._cast[dtype] = self.with_local(self.A.to(dtype))
        return self._cast[dtype]

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


# ---------------------------------------------------------------------------
# Taylor-Hood (mixed velocity / pressure) forms
# ---------------------------------------------------------------------------


def local_vector_laplacian(cb: CellBatch, coef=1.0) -> np.ndarray:
    """∫ coef grad(u):grad(v) over blocked vector dofs (component-diagonal).

    K[(ia),(jb)] = delta_ab * coef * ∫ grad phi_i . grad phi_j, interleaved
    ordering: the nu * inner(grad(u), grad(v)) block of Stokes and of the
    Navier-Stokes Jacobian."""
    Ks = local_stiffness(cb) * coef  # (c, nl, nl)
    d = cb.dphi.shape[-1]
    K = np.einsum("cij,ab->ciajb", Ks, np.eye(d))
    c, nl = Ks.shape[0], Ks.shape[1]
    return K.reshape(c, nl * d, nl * d)


def local_divergence(cb: CellBatch, psi: np.ndarray) -> np.ndarray:
    """Pressure-velocity coupling G[(ia), j] = -∫ psi_j dphi_i/dx_a.

    psi: (nq, nlp) pressure basis at the SAME quadrature points. The
    saddle system is [[A, G], [G^T, 0]] (a = ... - p div v - q div u)."""
    psi = np.asarray(psi)
    aff = cb.affine_host()
    if aff is not None:
        iJ, detJ = aff  # (c, d, k), (c,)
        nq, nl, d = cb.dphi.shape
        nlp = psi.shape[-1]
        T = np.einsum("q,qik,qj->kij", cb.qw, cb.dphi, psi).reshape(d, nl * nlp)
        G = -(iJ.reshape(-1, d) @ T).reshape(len(detJ), d, nl, nlp) * detJ[
            :, None, None, None
        ]
        return np.ascontiguousarray(G.transpose(0, 2, 1, 3)).reshape(
            len(detJ), nl * d, nlp
        )
    g = cb.grad_phys()  # (c, q, i, d)
    G = -np.einsum("cqia,qj,cq->ciaj", g, psi, cb.wdetJ, optimize=True)
    c, nl, d, nlp = G.shape
    return G.reshape(c, nl * d, nlp)
