"""Hyperelasticity oracle: compressible neo-Hookean finite strain.

The total energy

    Pi(u) = sum_q w |J| psi(F(q)) - int f . u
    psi   = mu/2 (tr(F^T F) - d) - mu ln(det F) + lam/2 ln(det F)^2

is written once as a function of the cell-local displacements ue (c, nl,
d); its gradient is torch.func.grad of it, cell-local, and the
fixed-order `GatherSum` assembles it into the blocked dofs. The
Hessian-vector products are matrix-free too: once a Newton step the
quadrature-point tangent w d2psi/dF2 (c, q, d, d, d, d) is taken by
torch.func.jvp of the weighted stress w dpsi/dF (torch.func.grad of the
energy in F, which is separable by quadrature point) along the d^2 unit
directions; a CG step then applies it with three einsums and the same
GatherSum (a jvp of the whole gradient every CG step, or a trace of it
every Newton step, costs several times the host time). No advanced-index
scatter is differentiated: on CUDA its backward is an atomic index_add_,
whose sum order changes from run to run, and the Newton and CG steps with
it. Everything runs in float64 on the solve's device.

Newton-CG, as the reference runs it: the residual is the free rows of
the energy gradient; every Newton step runs exactly 200 CG steps on the
Hessian-vector product (no early exit), then a backtracking line search
of 25 halvings at most on the energy (the first trial step below the
current energy is taken), det F clamped at 1e-8 for the trials; the loop
stops at ||r|| <= max(rtol ||r_0||, atol) or after max_it steps.

Config schema:
  pde: {type: "hyperelasticity", pde_params: {E, nu} | {lambda, mu},
        body_force: [fx, fy(, fz)]}
  bc.dirichlet: displacement segments
  output.field: displacement magnitude

Port of pdebench_tpu/oracle/hyperelasticity.py.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.func import grad, jvp

from ..fem import symbolic
from . import base, scalar
from .linear_elasticity import lame_from_params
from .types import OracleResult, compute_rel_L2_grid

# CG steps a Newton step (the reference's fori_loop), line-search halvings,
# the det F clamp
CG_STEPS = 200
LINE_SEARCH_STEPS = 25
DET_MIN = 1e-8


def _det(F: torch.Tensor) -> torch.Tensor:
    """det of (..., d, d), d = 2 or 3, by cofactors."""
    if F.shape[-1] == 2:
        return F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    return (
        F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1])
        - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 0])
        + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0])
    )


class HyperelasticitySolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        lam, mu = lame_from_params(pde.get("pde_params", {}))
        ctx = scalar.setup_scalar(config, self.device, ncomp=-1)
        dim, dev = ctx.dim, self.device
        space, cb = ctx.space, ctx.cb

        body = pde.get("body_force", pde.get("source_term", [0.0] * dim))
        if not isinstance(body, (list, tuple)):
            body = [body] * dim
        f_fns = [symbolic.lambdify_spatial(b, dim, dev) for b in body]

        opts = base.solver_opts(config)
        newton_rtol = float(opts.get("rtol", 1e-10))
        newton_atol = float(opts.get("atol", 1e-12))
        max_newton = int(opts.get("max_it", 50))

        dofmap = torch.as_tensor(space.dofmap_scalar, dtype=torch.int64, device=dev)
        gphys = cb.on("grad_phys", dev)  # (c, q, i, d)
        wdetJ = cb.on("wdetJ", dev)
        phi = cb.on("phi", dev)
        f_q = torch.stack([f(ctx.qpts()) for f in f_fns], dim=-1)  # (c, q, d)
        mask, g = ctx.mask, ctx.g
        gather = ctx.gather_sum()
        eye = torch.eye(dim, dtype=torch.float64, device=dev)

        def deformation(ue):
            return eye + torch.einsum("cqid,cia->cqad", gphys, ue)  # F (c, q, d, d)

        def psi(F):
            C_tr = torch.einsum("cqad,cqad->cq", F, F)
            lnJ = torch.log(torch.clamp(_det(F), min=DET_MIN))
            return 0.5 * mu * (C_tr - dim) - mu * lnJ + 0.5 * lam * lnJ * lnJ

        def energy_local(ue):
            u_q = torch.einsum("qi,cia->cqa", phi, ue)
            work = torch.einsum("cqa,cqa->cq", f_q, u_q)
            return torch.sum(wdetJ * (psi(deformation(ue)) - work))

        grad_local = grad(energy_local)
        # w dpsi/dF at every quadrature point
        stress = grad(lambda F: torch.sum(wdetJ * psi(F)))
        units = torch.eye(dim * dim, dtype=torch.float64, device=dev).reshape(-1, dim, dim)

        def tangent(u):
            """w d2psi/dF2 at u's quadrature points, (c, q, d, d, d, d):
            [..., a, b, k, l] = d(w dpsi/dF_ab) / dF_kl."""
            F = deformation(cells(u))
            cols = [jvp(stress, (F,), (e.expand_as(F),))[1] for e in units]
            return torch.stack(cols, dim=-1).reshape(F.shape + (dim, dim))

        def cells(v):
            return v.reshape(-1, dim)[dofmap]  # (c, nl, d): a gather

        def assemble(ge):
            return gather(ge.reshape(ge.shape[0], -1))

        def energy(u):
            return energy_local(cells(u))

        def residual(u):
            return torch.where(mask, 0.0, assemble(grad_local(cells(u))))

        def cg_direction(u, r):
            # matrix-free CG on the HVP, CG_STEPS steps whatever the residual
            A = tangent(u)

            def hvp(v):
                dF = torch.einsum("cqid,cia->cqad", gphys, cells(torch.where(mask, 0.0, v)))
                dP = torch.einsum("cqabkl,cqkl->cqab", A, dF)
                return torch.where(mask, v, assemble(torch.einsum("cqib,cqab->cia", gphys, dP)))

            x = torch.zeros_like(r)
            p = res = r
            rz = torch.dot(res, res)
            for _ in range(CG_STEPS):
                Ap = hvp(p)
                denom = torch.dot(p, Ap)
                alpha = rz / torch.where(torch.abs(denom) > 0, denom, 1.0)
                x = x + alpha * p
                res = res - alpha * Ap
                rz_new = torch.dot(res, res)
                beta = rz_new / torch.where(rz > 0, rz, 1.0)
                p = p * beta + res
                rz = rz_new
            return x

        def newton(u):
            rn0 = rn = float(torch.linalg.norm(residual(u)))
            k = 0
            while k < max_newton and rn > max(newton_rtol * rn0, newton_atol):
                d = cg_direction(u, -residual(u))
                # backtracking line search on the energy
                e0 = energy(u)
                t = 1.0
                for _ in range(LINE_SEARCH_STEPS):
                    if bool(energy(u + t * d) < e0):
                        break
                    t *= 0.5
                u = u + t * d
                rn = float(torch.linalg.norm(residual(u)))
                k += 1
            return u, k, rn

        def run():
            u, iters, rn = newton(torch.where(mask, g, 0.0))
            grid = ctx.sample(u.cpu().numpy())
            return grid, {
                "method": "newton-cg(autodiff)",
                "inner": "newton-cg(autodiff)",
                "iterations": int(iters),
                "residual": rn,
            }

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, dev)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 0.0
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid)
            if err is None and "reference_config" in config:
                ref = self.solve(scalar.merge_reference_config(config), _compute_baseline=False)
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(dev),
            "pde": "hyperelasticity",
            "model": "neo_hookean_compressible",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "lame_lambda": lam,
            "lame_mu": mu,
            "ksp_type": "cg",
            "pc_type": "none",
            "rtol": newton_rtol,
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
            num_dofs=space.ndof,
        )
