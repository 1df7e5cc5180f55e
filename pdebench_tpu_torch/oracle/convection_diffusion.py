"""Convection-diffusion oracle: -eps Lap(u) + beta.grad(u) = f, with
optional residual-based SUPG stabilization; steady and backward-Euler
transient variants.

Steady: A = eps K + the advection form (+ SUPG) on a lattice, solved by
`solve_linear(symmetric=False)`: mixed-precision refinement with one
GMRES(30) cycle a round, preconditioned by the PyTorch V-cycle of a GMG
hierarchy coarsened from A itself ("gmres+vcycle"; GMRES(60) with Jacobi
below the hierarchy's size gate). No fused kernel by default: on the TPU
the fused Arnoldi cycle and the Richardson chain both lost to the plain
V-cycle on these own-operator hierarchies (the reference's
dispatch.py:275-360); PDEBENCH_TPU_FUSED=arnoldi runs the whole cycle as
kernel #6 ("fused-gmres-*"), whose 2-V-cycle preconditioner stalls on
SUPG and P2 operators (the solve then falls through to the route off the
lattice, `iterative_failed` recording the stall).
Transient: heat's step loop on M + dt A, inner GMRES(20) with a hierarchy
(GMRES(60) without), and dt (tau (beta.grad v), f) in the load. A step
that does not converge raises on a CUDA device; on the CPU the loop keeps
its iterate and records `iterative_failed`, as the reference's scan, which
does not look at convergence, keeps it (no host solve, unlike heat).

Scheme (reference: pdebench/oracle/convection_diffusion.py):
  steady:  a = eps grad u . grad v + (beta . grad u) v
  SUPG:    + tau (beta . grad v)(beta . grad u - eps Lap u),
           tau = alpha * h_cell / (2 |beta| + 1e-12), h = cell diameter;
           rhs gains tau (beta . grad v) f
  transient (backward Euler): a = u v + dt * (steady + SUPG);
           L = (u_prev + dt f(t_{n+1})) v + dt tau (beta.grad v) f
           num_steps = ceil((t_end - t0)/dt)
  MMS: f = [u_t] - eps Lap(u_exact) + beta . grad(u_exact); BC = u_exact.

The Laplacian in the SUPG term uses exact physical basis Laplacians
(affine cells), nonzero only from degree 2 on.

Off the lattice a steady solve takes dispatch's route off the lattice
(host LU for the direct requests and, on CPU tensors, for systems of at
most dispatch.HOST_LU_MAX_DOFS dofs; Jacobi GMRES below
NONSYM_AMG_MIN_DOFS; FGMRES-IR above). From dispatch.AMG_MIN_DOFS dofs on
the oracle hands the AMG the SPD surrogate eps K + SUPG(eps = 0), the
symmetric streamline diffusion (`_amg_matrix`, charged to setup): SA-AMG
on the nonsymmetric operator itself can give a divergent V-cycle (the
reference's convection_diffusion.py:128-153); between the two gates the
refinement takes Jacobi ("jacobi-gmres-ir"), as the reference's does. A
transient solve off the lattice runs heat's loop on the cell-local
operators, GMRES(60) with Jacobi.

Port of pdebench_tpu/oracle/convection_diffusion.py.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import (
    LocalOperator,
    local_advection,
    local_load,
    local_mass,
    local_stiffness,
    local_supg,
    local_supg_load,
)
from ..solvers import dispatch
from . import base, heat, scalar
from .types import OracleResult, compute_rel_L2_grid

# inner steps of one refinement round of a transient step: with a GMG
# hierarchy, without
INNER_ITERS = (20, 60)


def transient_time(time_cfg: Dict[str, Any]):
    """(t0, t_end, dt, num_steps) of a transient case: num_steps is the
    ceiling of (t_end - t0) / dt (the reference's `+ 0.999999`), not
    base.time_params' rounding."""
    t0 = float(time_cfg.get("t0", 0.0))
    t_end = float(time_cfg["t_end"])
    dt = float(time_cfg.get("dt", 0.01))
    return t0, t_end, dt, max(int((t_end - t0) / dt + 0.999999), 1)


class ConvectionDiffusionSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, mms_u)
            pde = config["pde"]
        transient = bool(pde.get("time"))

        ctx = scalar.setup_scalar(
            config, self.device,
            t0=float(pde.get("time", {}).get("t0", 0.0)) if transient else None,
        )
        dim = ctx.dim
        params = pde.get("pde_params", {})
        epsilon = float(params.get("epsilon", 1.0))
        beta_exprs = params.get("beta", [0.0] * dim)
        opts = base.solver_opts(config)
        stab = opts.get("stabilization", params.get("stabilization"))
        alpha = float(opts.get("upwind_parameter", 1.0))

        if mms_u is not None:
            u_sym = symbolic.parse(mms_u)
            conv = sum(
                symbolic.parse(b) * sp.diff(u_sym, v)
                for b, v in zip(beta_exprs, [symbolic.X, symbolic.Y, symbolic.Z])
            )
            src = -epsilon * symbolic.laplacian(u_sym, dim) + conv
            if transient:
                src = sp.diff(u_sym, symbolic.T) + src
        else:
            src = pde.get("source_term", 0.0)

        cb, space = ctx.cb, ctx.space
        qpts = ctx.qpts()
        # host operands: the weak forms run on the host (fem.assemble)
        beta_q = np.stack(
            [symbolic.lambdify_numpy(b, dim)(qpts) for b in beta_exprs], axis=-1
        )  # (c, nq, d)
        if stab == "supg":
            h_c = ctx.mesh.cell_diameters()
            bnorm = np.linalg.norm(beta_q, axis=-1).mean(axis=1)  # (c,)
            tau_c = alpha * h_c / (2.0 * bnorm + 1e-12)
        else:
            tau_c = None

        def assemble_A():
            A = epsilon * local_stiffness(cb) + local_advection(cb, beta_q)
            if tau_c is not None:
                A = A + local_supg(cb, beta_q, tau_c, epsilon)
            return A

        def cell_load(f_q):
            b = local_load(cb, f_q)
            if tau_c is not None:
                b = b + local_supg_load(cb, beta_q, tau_c, f_q)
            return b

        if not transient:
            f_np = symbolic.lambdify_numpy(src, dim)
            opts["_lattice32"] = scalar.maybe_lattice32(ctx, assemble_A())
            if opts["_lattice32"] is None and space.ndof >= dispatch.AMG_MIN_DOFS:

                def spd_surrogate():
                    A_spd = epsilon * local_stiffness(cb)
                    if tau_c is not None:
                        A_spd = A_spd + local_supg(cb, beta_q, tau_c, 0.0)
                    return LocalOperator(torch.as_tensor(A_spd), space.dofmap_scalar, space.ndof).to_scipy()

                opts["_amg_matrix"] = base.charge_setup(ctx, spd_surrogate)

            def build():
                op = LocalOperator(
                    torch.as_tensor(assemble_A(), device=self.device),
                    space.dofmap_scalar, space.ndof,
                )
                b = ctx.gather_sum()(torch.as_tensor(cell_load(f_np(qpts)), device=self.device))
                return op, b

            op, b = base.charge_setup(ctx, build)

            def run():
                x, info = dispatch.solve_linear(op, b, ctx.mask, ctx.g, opts, symmetric=False)
                return ctx.sample(x), info

            t_final, dt = None, None
        else:
            t0, t_end, dt, num_steps = transient_time(pde["time"])
            t_final = t0 + num_steps * dt
            f_steps = symbolic.lambdify_numpy_steps(src, dim)
            ic = mms_u if mms_u is not None else pde.get("initial_condition", 0.0)
            u0 = base.interpolate_nodal(space, ic, t=t0)
            _, g_fn = base.dirichlet_traceable(space, config.get("bc", {}), self.device)
            rtol, atol = float(opts["rtol"]), float(opts.get("atol", 1e-12))
            ts = t0 + dt * np.arange(1, num_steps + 1)
            M = local_mass(cb)
            A_sys = M + dt * assemble_A()

            def build():
                return heat.step_operators(ctx, A_sys, (M,), "gmres", INNER_ITERS) + (
                    torch.as_tensor(u0, device=self.device),
                )

            lat32, gmg_failed, (mass_apply,), op, n_inner, u0_dev = base.charge_setup(ctx, build)

            def run():
                loads = heat.step_loads(ctx, [cell_load(f_q) for f_q in f_steps(qpts, ts)])
                u, info = heat.step_loop(
                    op, lat32, heat.mass_rhs(mass_apply, dt * loads), u0_dev, g_fn, ts,
                    ctx.mask, rtol, atol, inner="gmres", inner_iters=n_inner,
                )
                # an unconverged step raises on a CUDA device; on the CPU
                # the loop keeps its iterate, as the reference does
                u = u.cpu().numpy()
                info["num_steps"] = num_steps
                if gmg_failed:
                    info["gmg_failed"] = gmg_failed
                return ctx.sample(u), info

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid, t_end=t_final)
            if err is None and "reference_config" in config:
                ref = self.solve(
                    scalar.merge_reference_config(
                        config, refine_dt=dt * 0.5 if transient else None
                    ),
                    _compute_baseline=False,
                )
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(self.device),
            "pde": "convection_diffusion",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "epsilon": epsilon,
            "stabilization": stab or "none",
            "upwind_parameter": alpha,
            "ksp_type": opts["ksp_type"],
            "pc_type": opts["pc_type"],
            "rtol": float(opts["rtol"]),
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
