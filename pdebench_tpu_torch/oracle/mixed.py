"""Shared Taylor-Hood (mixed velocity/pressure) machinery.

Layout: the mixed unknown is one flat vector x = [u_blocked ; p], with
velocity dofs interleaved (node-major, component-minor) followed by
pressure dofs. The coupled operator is applied matrix-free from
cell-local blocks (A velocity block, G coupling):

    r_u = A u + G p        r_p = G^T u

Dirichlet velocity rows and one pinned pressure dof are eliminated
symmetrically (constrained_operator). The direct path assembles a global
CSR on the host and factorizes with SuperLU.

The Stokes MINRES takes a block-diagonal SPD preconditioner: on 2-D
lattices `saddle_gmg_precond_parts` (per velocity component a chain of
SADDLE_VCYCLES V-cycles of the constrained scalar stiffness's hierarchy,
kernel #3 where the hierarchy halves at every level; the lumped
pressure-mass Schur diagonal), elsewhere `saddle_amg_precond` (one SA-AMG
V-cycle of the velocity block and the same Schur diagonal) or
`saddle_diag_precond` (diag(A) and the lumped pressure mass over nu).

Port of pdebench_tpu/oracle/mixed.py without the reference's Chebyshev
pressure-mass solve (`Mp_solve`, read only by the Navier-Stokes opt-in
PDEBENCH_TPU_NS_SCHUR=mass).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..fem import refelem, sampling
from ..fem.assemble import CellBatch, LocalOperator, cell_batch, local_stiffness
from ..fem.mesh import Mesh
from ..fem.spaces import FunctionSpace
from ..solvers import dispatch
from ..solvers.amg import constrained_csr
from ..solvers.gmg import LatticeGMG, setup_gmg
from ..solvers.stencil import Lattice, LatticeOperator, detect_lattice
from . import base

# V-cycles per velocity-component application of the saddle preconditioner
# (the reference's PDEBENCH_TPU_SADDLE_VCYCLES, at its default)
SADDLE_VCYCLES = 2


@dataclass
class TaylorHoodContext:
    config: Dict[str, Any]
    device: torch.device
    mesh: Mesh
    V: FunctionSpace  # velocity (vector, degree_u)
    Q: FunctionSpace  # pressure (scalar, degree_p)
    cb: CellBatch  # tabulated at degree_u quadrature
    psi: np.ndarray  # (nq, nlp) pressure basis at the same points
    grid: Dict[str, Any]
    loc: sampling.PointLocation
    mask: torch.Tensor  # (N,) combined Dirichlet + pressure-pin mask
    g: torch.Tensor  # (N,) constrained values
    pin_dof: int
    t_setup: float

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def N(self) -> int:
        return self.V.ndof + self.Q.ndof

    def qpts(self) -> np.ndarray:
        return self.cb.qpts

    def sample_velocity_magnitude(self, x) -> np.ndarray:
        u = np.asarray(x)[: self.V.ndof]
        return sampling.sample_on_grid(self.V, u, self.grid, loc=self.loc)


def setup_taylor_hood(
    config: Dict[str, Any], device, pin_pressure: bool = True
) -> TaylorHoodContext:
    device = torch.device(device)
    t_start = time.perf_counter()
    fem_cfg = config.get("fem", {})
    deg_u = int(fem_cfg.get("degree_u", 2))
    deg_p = int(fem_cfg.get("degree_p", 1))
    grid = config["output"]["grid"]

    def _build_geom():
        mesh_ = base.build_mesh(config["domain"], config.get("mesh", {}))
        V_ = FunctionSpace(mesh_, deg_u, ncomp=mesh_.dim)
        Q_ = FunctionSpace(mesh_, deg_p)
        tables = refelem.element_tables(mesh_.cell_type, deg_u, 2 * deg_u + 2)
        psi_, _ = refelem.tabulate(mesh_.cell_type, deg_p, tables.qpoints)
        pts, _ = sampling.grid_points(grid)
        loc_ = sampling.locate_points(mesh_, pts)
        return mesh_, V_, Q_, np.asarray(psi_), loc_

    mesh, V, Q, psi, loc = base.memo_geometry(
        ["th-geom", config["domain"], config.get("mesh", {}), deg_u, deg_p, grid],
        _build_geom,
    )

    # velocity Dirichlet
    bc_dofs, bc_values, _ = base.dirichlet_dofs_values(V, config.get("bc", {}))
    N = V.ndof + Q.ndof
    mask = np.zeros(N, dtype=bool)
    g = np.zeros(N)
    mask[bc_dofs] = True
    g[bc_dofs] = bc_values

    # pressure point-fixing at the dof nearest the origin
    pin = -1
    if pin_pressure:
        pin = int(np.argmin(np.linalg.norm(Q.dof_coords, axis=1)))
        mask[V.ndof + pin] = True
        g[V.ndof + pin] = 0.0

    cb = base.memo_geometry(
        ["th-cb", config["domain"], config.get("mesh", {}), deg_u],
        lambda: cell_batch(mesh, deg_u),
    )
    mask_t = torch.as_tensor(mask, device=device)
    g_t = torch.as_tensor(g, device=device)
    base.synchronize(device)
    return TaylorHoodContext(
        config=config, device=device, mesh=mesh, V=V, Q=Q, cb=cb, psi=psi,
        grid=grid, loc=loc, mask=mask_t, g=g_t, pin_dof=pin,
        t_setup=time.perf_counter() - t_start,
    )


def saddle_apply(
    A_loc: torch.Tensor,
    G_loc: torch.Tensor,
    dofmap_u: torch.Tensor,
    dofmap_p: torch.Tensor,
    sum_u: Callable,
    sum_p: Callable,
) -> Callable:
    """Matrix-free [[A, G], [G^T, 0]] on the stacked vector: cell-batched
    gather, batched matvecs, then sum_u / sum_p map the velocity and
    pressure cell contributions to global vectors (fem.assemble.GatherSum:
    a fixed summation order; the reference scatter-adds)."""

    def apply(x):
        u, p = x[: sum_u.ndof], x[sum_u.ndof :]
        ue = u[dofmap_u]  # (c, nlu)
        pe = p[dofmap_p]  # (c, nlp)
        ru_loc = torch.einsum("cij,cj->ci", A_loc, ue) + torch.einsum("cij,cj->ci", G_loc, pe)
        rp_loc = torch.einsum("cij,ci->cj", G_loc, ue)
        return torch.cat([sum_u(ru_loc), sum_p(rp_loc)])

    return apply


def schur_diag(
    cb: CellBatch,
    psi: np.ndarray,
    dofmap_p: np.ndarray,
    np_dofs: int,
    nu_visc: float,
    mask: np.ndarray,
    nu_dofs: int,
) -> np.ndarray:
    """The lumped pressure-mass Schur diagonal inv_p = nu / diag(M_p) of
    `saddle_gmg_precond_parts`, 1 on constrained pressure dofs (host)."""
    Mp = np.einsum("qi,qj,cq->cij", psi, psi, cb.wdetJ, optimize=True)
    dMp = np.bincount(
        np.asarray(dofmap_p).reshape(-1),
        weights=np.einsum("cii->ci", Mp).reshape(-1),
        minlength=np_dofs,
    )
    dMp = dMp / max(nu_visc, 1e-300)
    dMp = np.where(np.asarray(mask)[nu_dofs:], 1.0, dMp)
    return 1.0 / np.where(np.abs(dMp) > 1e-300, dMp, 1.0)


def saddle_diag_precond(
    A_loc: np.ndarray,
    cb: CellBatch,
    psi: np.ndarray,
    dofmap_u: np.ndarray,
    dofmap_p: np.ndarray,
    nu_dofs: int,
    np_dofs: int,
    nu_visc: float,
    mask: np.ndarray,
) -> np.ndarray:
    """The block-diagonal SPD preconditioner diag(A)^-1 (+) nu *
    Mp_lumped^-1 as its diagonal (host), 1 on constrained dofs; M(r) is
    this vector times r."""
    dA = np.bincount(
        np.asarray(dofmap_u).reshape(-1),
        weights=np.einsum("cii->ci", np.asarray(A_loc)).reshape(-1),
        minlength=nu_dofs,
    )
    Mp = np.einsum("qi,qj,cq->cij", psi, psi, cb.wdetJ, optimize=True)
    dMp = np.bincount(
        np.asarray(dofmap_p).reshape(-1),
        weights=np.einsum("cii->ci", Mp).reshape(-1),
        minlength=np_dofs,
    )
    diag = np.concatenate([dA, dMp / max(nu_visc, 1e-300)])
    diag = np.where(np.asarray(mask), 1.0, diag)
    return 1.0 / np.where(np.abs(diag) > 1e-300, diag, 1.0)


def saddle_amg_precond(
    A_loc: np.ndarray,
    cb: CellBatch,
    psi: np.ndarray,
    dofmap_u: np.ndarray,
    dofmap_p: np.ndarray,
    nu_dofs: int,
    np_dofs: int,
    nu_visc: float,
    mask: np.ndarray,
    device,
):
    """The block preconditioner AMG(A) (+) nu * lumped(Mp)^-1 for MINRES,
    on `device`: (M, None), or (None, why) where the velocity block's
    hierarchy cannot be built (the coarsest level's pseudo-inverse fails)
    and the caller takes saddle_diag_precond, as the reference does (its
    mixed.py:205-245), naming the reason in solver_info.

    The velocity block gets one float64 SA-AMG V-cycle of its constrained
    matrix (SPD, so MINRES stays valid; scalar aggregation over the
    interleaved velocity dofs, no near-nullspace, as the reference
    builds it), the identity on constrained dofs; the pressure block the
    lumped pressure-mass Schur diagonal (1 on the pinned pressure dof)."""
    from ..solvers.amg import setup_amg_masked

    device = torch.device(device)
    mask_np = np.asarray(mask, dtype=bool)
    op_u = LocalOperator(torch.as_tensor(np.asarray(A_loc)), np.asarray(dofmap_u), nu_dofs)
    try:
        amg_u = setup_amg_masked(op_u.to_scipy(), mask_np[:nu_dofs], device=device)
    except np.linalg.LinAlgError as e:
        return None, f"{e}"
    inv_p = torch.as_tensor(
        schur_diag(cb, psi, dofmap_p, np_dofs, nu_visc, mask_np, nu_dofs), device=device
    )

    def M(r):
        return torch.cat([amg_u(r[:nu_dofs]), inv_p * r[nu_dofs:]])

    return M, None


def velocity_lattice(V: FunctionSpace) -> Optional[Lattice]:
    """The lattice of V's scalar nodes where the stencil-GMG saddle
    preconditioner takes it (2-D, every site a node: the meshes the port
    builds), else None."""
    lat = detect_lattice(V.dof_coords, allow_masked=False)
    return lat if lat is not None and len(lat.shape) == 2 else None


@dataclass
class SaddlePrecondParts:
    """The stencil-GMG saddle preconditioner's pieces, on a device.

    `Mv` applies the per-component velocity solve to the blocked flat
    velocity vector, `Mv_grid` to the (fine..., d) velocity lattice (the
    component planes are the scalar hierarchy's grids: no dof <-> lattice
    gather); `inv_p` is the lumped pressure-mass Schur diagonal (nu /
    diag(M_p), float64); `mask_full` marks constrained mixed entries.
    `route` names the velocity solve: "fused-richardson-cuda" (kernel #3,
    SADDLE_VCYCLES V-cycles a launch), "fused-richardson-torch" (its plain
    version, CPU tensors) or "vcycle" (an identity-padded hierarchy, or one
    with no level above its dense coarse solve: one V-cycle in PyTorch
    ops, as the reference takes one where its kernel builder refuses the
    hierarchy)."""

    Mv: Callable
    Mv_grid: Callable
    inv_p: torch.Tensor
    mask_full: torch.Tensor
    gmg: LatticeGMG
    route: str


def saddle_gmg_precond_parts(
    V: FunctionSpace,
    nu_visc: float,
    cb: CellBatch,
    psi: np.ndarray,
    dofmap_p: np.ndarray,
    np_dofs: int,
    mask: np.ndarray,
    device,
) -> Optional[SaddlePrecondParts]:
    """Stencil-GMG block preconditioner for Stokes on 2-D lattices, or None
    where V's nodes do not form one (3-D, unstructured).

    The velocity block is nu x blockdiag(scalar stiffness), so one scalar
    hierarchy, coarsened from the constrained scalar stiffness stencil
    (float32, a node constrained if any of its components is),
    preconditions every component. Its solve is a linear chain of
    SADDLE_VCYCLES V-cycles per component (z += V(r - A z)): kernel #3 on
    hierarchies that halve at every level (dispatch.fused_gate), built
    once per hierarchy; one PyTorch V-cycle on the others."""
    lat = velocity_lattice(V)
    if lat is None:
        return None
    device = torch.device(device)
    d = V.ncomp
    nu_dofs = V.ndof
    mask_np = np.asarray(mask, dtype=bool)
    mask_u = mask_np[:nu_dofs].reshape(-1, d).any(axis=1)
    Ks = torch.as_tensor(local_stiffness(cb) * nu_visc)
    A_bc = constrained_csr(LocalOperator(Ks, V.dofmap_scalar, V.n_scalar_dofs).to_scipy(), mask_u)
    lat_bc = LatticeOperator(A_bc, lat, "cpu", dtype=torch.float32)
    W_bc = lat_bc.W.numpy().astype(np.float64)
    gmg = lat_bc.gmg = setup_gmg(W_bc, lat_bc.offsets, lat_bc.shape, device)
    shape = lat_bc.shape
    inv = torch.as_tensor(lat.inv, device=device)
    fused = None
    if dispatch.fused_gate(lat_bc):
        from ..solvers.gmg_fused import build_fused_richardson

        # None where the hierarchy has no level above the dense coarse one
        fused = dispatch._fused(
            gmg, ("richardson", SADDLE_VCYCLES),
            lambda: build_fused_richardson(gmg, SADDLE_VCYCLES, device),
        )
    if fused is not None:
        route = f"fused-richardson-{'cuda' if device.type == 'cuda' else 'torch'}"
        solve_plane = lambda r: fused(r.reshape(-1)).reshape(shape)
    else:
        solve_plane, route = gmg.precond(), "vcycle"

    def Mv(ru_flat):
        ru = ru_flat.reshape(-1, d)
        comps = [
            solve_plane(lat.embed(ru[:, c].to(torch.float32), 0.0).reshape(shape)).reshape(-1)[inv]
            for c in range(d)
        ]
        return torch.stack(comps, dim=1).reshape(-1).to(ru_flat.dtype)

    def Mv_grid(r_grid):
        comps = [solve_plane(r_grid[..., c].to(torch.float32).contiguous()) for c in range(d)]
        return torch.stack(comps, dim=-1).to(r_grid.dtype)

    inv_p = schur_diag(cb, psi, dofmap_p, np_dofs, nu_visc, mask_np, nu_dofs)
    return SaddlePrecondParts(
        Mv=Mv, Mv_grid=Mv_grid,
        inv_p=torch.as_tensor(inv_p, dtype=torch.float64, device=device),
        mask_full=torch.as_tensor(mask_np, device=device),
        gmg=gmg, route=route,
    )


def saddle_to_scipy(
    A_loc: np.ndarray,
    G_loc: np.ndarray,
    dofmap_u: np.ndarray,
    dofmap_p: np.ndarray,
    nu_dofs: int,
    np_dofs: int,
):
    """Global sparse [[A, G], [G^T, 0]] CSR on host."""
    import scipy.sparse as sps

    A_loc = np.asarray(A_loc)
    G_loc = np.asarray(G_loc)
    dmu = np.asarray(dofmap_u, dtype=np.int64)
    dmp = np.asarray(dofmap_p, dtype=np.int64) + nu_dofs
    nlu = dmu.shape[1]
    nlp = dmp.shape[1]
    N = nu_dofs + np_dofs

    rows_A = np.repeat(dmu, nlu, axis=1).reshape(-1)
    cols_A = np.tile(dmu, (1, nlu)).reshape(-1)
    rows_G = np.repeat(dmu, nlp, axis=1).reshape(-1)
    cols_G = np.tile(dmp, (1, nlu)).reshape(-1)

    rows = np.concatenate([rows_A, rows_G, cols_G])
    cols = np.concatenate([cols_A, cols_G, rows_G])
    vals = np.concatenate([A_loc.reshape(-1), G_loc.reshape(-1), G_loc.reshape(-1)])
    return sps.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
