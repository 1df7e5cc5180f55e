"""Stokes oracle: steady incompressible Stokes, Taylor-Hood.

  -nu Lap(u) + grad(p) = f,  div(u) = 0
  a((u,p),(v,q)) = nu grad u : grad v - p div v - q div u

Taylor-Hood spaces from fem.degree_u / degree_p; velocity Dirichlet
segments through the side-selector DSL; the pressure pinned at the dof
nearest the origin; MMS source f = -nu Lap(u_exact) + grad(p_exact); the
output field is the velocity magnitude.

Routes, decided in `StokesProblem` before any solve and recorded in
solver_info["inner"]:

  minres+fused-richardson-cuda / -torch, minres+vcycle
      2-D lattices (unit_square), whatever the case's ksp asks (a
      preonly/lu request too, as the reference does): MINRES-IR (the
      Lanczos recurrence in f32, restarts from the true f64 residual) on
      the constrained saddle system, preconditioned by the block-diagonal
      M = (per velocity component a chain of 2 V-cycles of the constrained
      scalar stiffness's hierarchy) (+) the lumped pressure-mass Schur
      diagonal. The chain is kernel #3 on hierarchies that halve at every
      level (its plain version on CPU tensors), one PyTorch V-cycle on
      padded ones. Where the Taylor-Hood dof sets are nested lattices
      (P2-P1) every Krylov vector stays in lattice layout
      (`LatticeSaddleVectors`): the saddle apply's A block is one launch of
      kernel #1's d = 2 block form, in the f32 recurrence and in the f64
      residual alike. Elsewhere (P3-P2, nesting ratio 3/2) the vectors are
      flat and the saddle apply is the cell-based one.
  minres+amg, minres+diag
      no GMG preconditioner (3-D lattices, masked lattices, meshes whose
      dofs form no lattice), not asking for a direct solve: MINRES-IR with
      `mixed.saddle_amg_precond` (one float64 SA-AMG V-cycle of the
      velocity block, built here, before any solve; the lumped
      pressure-mass Schur diagonal) from AMG_MIN_DOFS dofs on, the
      diagonal preconditioner diag(A) (+) nu / diag(Mp) below (and where
      the AMG hierarchy cannot be built: solver_info["amg_failed"] says
      why); the saddle apply on flat vectors, its A block kernel #1's
      d = 2 or 3 block form where the Taylor-Hood dofs form nested
      lattices, the cell-based apply elsewhere.
  host-lu
      a direct request without the GMG preconditioner: the host SuperLU.

The port takes the lattice layout on every device, where the reference
takes it only on the TPU (its CPU default is flat: the CPU parity tests
pin it with PDEBENCH_TPU_SADDLE_LAT=1). A MINRES that does not converge
raises on CUDA tensors; on CPU tensors the solve goes to the host LU and
records `iterative_failed`, as the reference does.

Port of pdebench_tpu/oracle/stokes.py.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import (
    GatherSum,
    constrained_operator,
    constrained_rhs,
    local_divergence,
    local_vector_laplacian,
    local_vector_load,
)
from ..solvers import direct as directmod
from ..solvers import dispatch
from ..solvers.krylov import minres
from ..solvers.saddle_stencil import LatticeSaddleVectors, build_saddle_stencil
from . import base, mixed, scalar
from .types import OracleResult, compute_rel_L2_grid

# a saddle MINRES that has not converged in this many preconditioned
# iterations (over all restarts) will not: the reference's cap
MAXITER = 5000
# without the GMG preconditioner, SA-AMG from this many dofs on and the
# diagonal preconditioner below (the reference's stokes.py:113-123)
AMG_MIN_DOFS = 20000
ROUTE_AMG = "minres+amg"
ROUTE_DIAG = "minres+diag"
ROUTE_HOST_LU = "host-lu"


def stokes_source(u_exprs: List, p_expr, nu: float, dim: int) -> List[sp.Expr]:
    """f = -nu Lap(u_exact) + grad(p_exact) componentwise."""
    sv = [symbolic.X, symbolic.Y, symbolic.Z][:dim]
    u = [symbolic.parse(e) for e in u_exprs]
    p = symbolic.parse(p_expr if p_expr is not None else 0)
    return [
        sp.simplify(-nu * symbolic.laplacian(u[a], dim) + sp.diff(p, sv[a]))
        for a in range(dim)
    ]


def reference_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The no-exact baseline's re-solve: the case's reference_config,
    capped at resolution 128 and P2-P1 unless the reference solver is
    already direct (the reference's own robustness cap)."""
    ref_cfg = scalar.merge_reference_config(config)
    ref_solver = ref_cfg.get("oracle_solver", {})
    already_direct = ref_solver.get("ksp_type") == "preonly" or ref_solver.get("pc_type") in ("lu", "mumps")
    if not already_direct:
        mres = int(ref_cfg.get("mesh", {}).get("resolution", 128))
        ref_cfg.setdefault("mesh", {})["resolution"] = min(mres, 128)
        fem_cfg = ref_cfg.setdefault("fem", {})
        fem_cfg["degree_u"] = min(int(fem_cfg.get("degree_u", 2)), 2)
        fem_cfg["degree_p"] = min(int(fem_cfg.get("degree_p", 1)), 1)
    return ref_cfg


class StokesProblem:
    """One case's discrete problem on a device: the Taylor-Hood context,
    the load vector, and the route with its operators and preconditioner,
    all built here, before any solve (only the load is charged to
    t_setup, as in the reference)."""

    def __init__(self, config: Dict[str, Any], device):
        # the concrete device ("cuda:0" for "cuda"), as tensors report it
        dev = self.device = torch.empty(0, device=device).device
        pde = config["pde"]
        mms = pde.get("manufactured_solution", {})
        mms_u = mms.get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, list(mms_u))
            pde = config["pde"]
        self.config = config
        self.nu = nu = float(pde.get("pde_params", {}).get("nu", 1.0))
        ctx = self.ctx = mixed.setup_taylor_hood(config, dev)
        V, Q, cb = ctx.V, ctx.Q, ctx.cb
        dim = ctx.dim

        if mms_u is not None:
            src = stokes_source(mms_u, mms.get("p"), nu, dim)
        else:
            src = pde.get("source_term", [0.0] * dim)
            if not isinstance(src, (list, tuple)):
                src = [src] * dim
        f_fns = [symbolic.lambdify_numpy(s, dim) for s in src]
        opts = self.opts = base.solver_opts(config)
        use_direct = dispatch.direct_request(opts)
        self.rtol, self.atol = float(opts["rtol"]), float(opts["atol"])
        self.mask_np = mask_np = ctx.mask.cpu().numpy()
        self.A_loc = local_vector_laplacian(cb, nu)
        self.G_loc = local_divergence(cb, ctx.psi)

        def assemble():
            f_q = np.stack([f(ctx.qpts()) for f in f_fns], axis=-1)
            sum_u = GatherSum(V.dofmap, V.ndof, dev)
            b_u = sum_u(torch.as_tensor(local_vector_load(cb, f_q), device=dev))
            return sum_u, torch.cat([b_u, b_u.new_zeros(Q.ndof)])

        sum_u, self.b = base.charge_setup(ctx, assemble)

        # -- the route ------------------------------------------------------
        parts = self.parts = mixed.saddle_gmg_precond_parts(
            V, nu, cb, ctx.psi, Q.dofmap_scalar, Q.ndof, mask_np, dev
        )
        self.layout = self.sst = self.WA64 = self.amg_failed = None
        if parts is None and use_direct:
            self.route = ROUTE_HOST_LU
            return
        M = None
        if parts is None and ctx.N >= AMG_MIN_DOFS:
            M, self.amg_failed = mixed.saddle_amg_precond(
                self.A_loc, cb, ctx.psi, V.dofmap, Q.dofmap_scalar, V.ndof, Q.ndof, nu, mask_np, dev
            )
            self.route = ROUTE_AMG
        if parts is None and M is None:
            inv = torch.as_tensor(
                mixed.saddle_diag_precond(
                    self.A_loc, cb, ctx.psi, V.dofmap, Q.dofmap_scalar, V.ndof, Q.ndof, nu, mask_np
                ),
                device=dev,
            )
            self.route, M = ROUTE_DIAG, lambda r: inv * r
        elif parts is not None:
            self.route = f"minres+{parts.route}"

            def M(r):  # block-diagonal, SPD
                zu = parts.Mv(r[: V.ndof])
                out = torch.cat([zu, parts.inv_p.to(r.dtype) * r[V.ndof :]])
                return torch.where(parts.mask_full, r, out)

        sst = self.sst = build_saddle_stencil(V, Q, self.G_loc)
        if sst is not None:
            WA64 = self.WA64 = torch.as_tensor(sst.wmapA.weights_np(self.A_loc), device=dev)
            WA32 = WA64.to(torch.float32)
        if sst is not None and parts is not None:
            self.layout = "lattice"
            lsv = LatticeSaddleVectors(sst, mask_np, dev)
            M_lat = lsv.block_diag_M(parts.Mv_grid, lsv.embed_plane_p(parts.inv_p.cpu().numpy()))
            self.system = dict(
                apply64=lsv.apply_w(WA64), apply32=lsv.apply_w(WA32), mask=lsv.mask_lat,
                M=M_lat, embed=lsv.embed, extract=lsv.extract,
            )
            return
        self.layout = "flat"
        if sst is not None:
            apply64, apply32 = sst.saddle_apply_w(WA64), sst.saddle_apply_w(WA32)
        else:
            t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
            dm_u = torch.as_tensor(V.dofmap, dtype=torch.int64, device=dev)
            dm_p = torch.as_tensor(Q.dofmap_scalar, dtype=torch.int64, device=dev)
            sum_p = GatherSum(Q.dofmap_scalar, Q.ndof, dev)
            apply64, apply32 = (
                mixed.saddle_apply(t(self.A_loc, dt), t(self.G_loc, dt), dm_u, dm_p, sum_u, sum_p)
                for dt in (torch.float64, torch.float32)
            )
        same = lambda v: v
        self.system = dict(
            apply64=apply64, apply32=apply32, mask=ctx.mask, M=M, embed=same, extract=same,
        )

    def minres_solve(self):
        """The constrained saddle solve by MINRES-IR on the route's layout:
        (x as a flat dof vector, KrylovInfo)."""
        s = self.system
        mask, g = s["mask"], s["embed"](self.ctx.g)
        A = constrained_operator(s["apply64"], mask)
        A32 = constrained_operator(s["apply32"], mask)
        rhs = constrained_rhs(s["apply64"], s["embed"](self.b), mask, g)
        x0 = torch.where(mask, g, 0.0)
        x, kinfo = minres(
            A, rhs, x0=x0, M=s["M"], rtol=self.rtol, atol=self.atol, maxiter=MAXITER, A32=A32,
        )
        return s["extract"](x), kinfo

    def run(self):
        """One whole solve: (velocity-magnitude grid, info)."""
        ctx, opts = self.ctx, self.opts
        info: Dict[str, Any] = {
            "ksp_type": str(opts["ksp_type"]).lower(), "pc_type": str(opts["pc_type"]).lower(),
            "rtol": self.rtol,
        }
        if self.amg_failed:
            info["amg_failed"] = self.amg_failed
        if self.route != ROUTE_HOST_LU:
            x, kinfo = self.minres_solve()
            if kinfo.converged:
                info.update(
                    method="minres", inner=self.route, iterations=int(kinfo.iterations),
                    restarts=int(kinfo.restarts), residual=float(kinfo.residual),
                    saddle_layout=self.layout,
                )
                return ctx.sample_velocity_magnitude(x.cpu().numpy()), info
            failed = {
                "inner": self.route, "iterations": int(kinfo.iterations),
                "restarts": int(kinfo.restarts), "residual": float(kinfo.residual),
            }
            if self.device.type != "cpu":
                raise RuntimeError(
                    f"stokes MINRES did not converge on {self.device}: {failed} "
                    f"(rtol {self.rtol}, atol {self.atol})"
                )
            info["iterative_failed"] = failed
        V, Q = ctx.V, ctx.Q
        K = mixed.saddle_to_scipy(self.A_loc, self.G_loc, V.dofmap, Q.dofmap_scalar, V.ndof, Q.ndof)
        x = directmod.solve_direct_constrained(
            K, self.b.cpu().numpy(), self.mask_np, ctx.g.cpu().numpy()
        )
        info.update(method="lu", inner=ROUTE_HOST_LU, iterations=1)
        return ctx.sample_velocity_magnitude(x), info


class StokesSolver:
    """The route follows from the mesh and the request (module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def solve(self, config: Dict[str, Any], _compute_baseline: bool = True) -> OracleResult:
        prob = StokesProblem(config, self.device)
        config, ctx = prob.config, prob.ctx
        ref_prob = None
        if (
            _compute_baseline
            and config["pde"].get("manufactured_solution", {}).get("u") is None
            and "reference_config" in config
        ):
            # the re-solve's route, and its preconditioner, before any solve
            ref_prob = StokesProblem(reference_config(config), self.device)
        (fem_grid, info), t_warm, t_cold = base.timed_run(prob.run, prob.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid)
            if err is None and ref_prob is not None:
                ref_grid, _ = ref_prob.run()
                err = compute_rel_L2_grid(fem_grid, ref_grid)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(prob.device),
            "pde": "stokes",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": ctx.V.degree,
            "degree_p": ctx.Q.degree,
            "viscosity": prob.nu,
            "pressure_fixing": "point",
            "t_setup": ctx.t_setup,
            "t_warm": t_warm,
            "t_cold": t_cold,
            **info,
        }
        return OracleResult(
            baseline_error=float(baseline_error),
            baseline_time=float(baseline_time),
            reference=fem_grid,
            solver_info=solver_info,
            num_dofs=ctx.N,
        )
