"""Cahn-Hilliard oracle: 4th-order phase field, mixed (c, mu) P1-P1.

Split form with the double well f(c) = well c^2 (1 - c)^2:

    dc/dt = div(M grad(mu))
    mu    = f'(c) - lambda Lap(c)

Backward Euler in time, Newton on the stacked unknown (c, mu) every step,
natural (zero-flux) boundary conditions: the discretization conserves
the mass int(c). Each Newton step assembles the Jacobian's cell-local
blocks

    [[M / dt, mob K], [-(M_f'' + lambda K), M]]   (c, 2 nl, 2 nl)

on the stacked dofmap (c dofs, then mu dofs at + ndof) and solves it with
`dispatch.solve_constrained(..., "gmres", 1e-6, atol, 4000)`, no
constraint: float64 GMRES(60) with Jacobi. Every apply and load sums in a
fixed order (`LocalOperator`, `GatherSum`) on the solve's device.

The "random" initial condition, 0.63 + 0.02 (U(0, 1) - 1/2) per node,
comes from numpy's default_rng(pde.seed) on the host, as in the
reference, so both packages start from the same state.

Config schema:
  pde: {type: "cahn_hilliard", pde_params: {lambda, M, well_scale},
        time: {t0, t_end, dt}, initial_condition: expr | "random", seed}
  output.field: the concentration c on the grid

Port of pdebench_tpu/oracle/cahn_hilliard.py.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..fem.assemble import LocalOperator, local_mass, local_stiffness
from ..solvers.dispatch import solve_constrained
from . import base, scalar
from .types import OracleResult, compute_rel_L2_grid

# each Newton step's linear solve (the reference's)
LINEAR_RTOL = 1e-6
LINEAR_MAXITER = 4000


class CahnHilliardSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        params = pde.get("pde_params", {})
        lam = float(params.get("lambda", 1e-2))
        mob = float(params.get("M", 1.0))
        well = float(params.get("well_scale", 100.0))
        t0, t_end, dt, num_steps = base.time_params(pde, default_t_end=5e-5, default_dt=5e-6)
        dev = self.device

        ctx = scalar.setup_scalar(config, dev)
        space, cb = ctx.space, ctx.cb
        ndof = space.ndof

        ic = pde.get("initial_condition", "random")
        if isinstance(ic, str) and ic.strip().lower() == "random":
            rng = np.random.default_rng(int(pde.get("seed", 0)))
            c0 = 0.63 + 0.02 * (rng.random(ndof) - 0.5)
        else:
            c0 = base.interpolate_nodal(space, ic)

        def fprime(c):
            return well * 2.0 * c * (1.0 - c) * (1.0 - 2.0 * c)

        def fsecond(c):
            return well * 2.0 * (1.0 - 6.0 * c + 6.0 * c * c)

        opts = base.solver_opts(config)
        rtol = float(opts.get("rtol", 1e-8))
        atol = float(opts.get("atol", 1e-10))
        max_newton = int(opts.get("max_it", 20))
        inv_dt = 1.0 / dt
        no_mask = torch.zeros(2 * ndof, dtype=torch.bool, device=dev)
        zero_g = torch.zeros(2 * ndof, dtype=torch.float64, device=dev)
        dm = space.dofmap_scalar.astype(np.int64)
        dofmap = torch.as_tensor(dm, device=dev)
        phi = cb.on("phi", dev)
        wphi = cb.on("wphi", dev)  # wdetJ[c, q] phi[q, i]
        gather = ctx.gather_sum()

        def build():
            M = torch.as_tensor(local_mass(cb), device=dev)
            K = torch.as_tensor(local_stiffness(cb), device=dev)
            op_M = LocalOperator(M, dm, ndof)
            # the Jacobian's blocks on the stacked dofmap; its
            # c-dependent block is filled in every Newton step
            top = torch.cat([inv_dt * M, mob * K], dim=2)
            J0 = LocalOperator(torch.cat([top, torch.cat([-lam * K, M], dim=2)], dim=1),
                               np.concatenate([dm, dm + ndof], axis=1), 2 * ndof)
            return op_M, op_M.with_local(K), top, J0, torch.as_tensor(c0, device=dev)

        op_M, op_K, top, J0, c0_dev = base.charge_setup(ctx, build)

        def c_at_q(c):
            return torch.einsum("qi,ci->cq", phi, c[dofmap])

        def residual(c, mu, c_n):
            r1 = inv_dt * op_M(c - c_n) + mob * op_K(mu)
            b_fp = gather(torch.einsum("cqi,cq->ci", wphi, fprime(c_at_q(c))))
            r2 = op_M(mu) - b_fp - lam * op_K(c)
            return torch.cat([r1, r2])

        def jacobian(c):
            Mw = local_mass(cb, fsecond(c_at_q(c)))
            bottom = torch.cat([-(Mw + lam * op_K.A), op_M.A], dim=2)
            return J0.with_local(torch.cat([top, bottom], dim=1))

        def step(c_n):
            c, mu = c_n, torch.zeros(ndof, dtype=torch.float64, device=dev)
            rn0 = rn = float(torch.linalg.norm(residual(c, mu, c_n)))
            k, linear = 0, 0
            while k < max_newton and rn > max(rtol * rn0, atol):
                r = residual(c, mu, c_n)
                d, its, _, _ = solve_constrained(
                    jacobian(c), -r, no_mask, zero_g, "gmres", LINEAR_RTOL, atol, LINEAR_MAXITER
                )
                c, mu = c + d[:ndof], mu + d[ndof:]
                rn = float(torch.linalg.norm(residual(c, mu, c_n)))
                k += 1
                linear += its
            return c, k, linear, rn

        def run():
            c, ks, linear, rn = c0_dev, [], [], None
            for _ in range(num_steps):
                c, k, its, rn = step(c)
                ks.append(k)
                linear.append(its)
            grid = ctx.sample(c.cpu().numpy())
            return grid, {
                "inner": "jacobi-gmres",
                "newton_iterations": int(sum(ks)),
                "newton_per_step": ks,
                "linear_iterations": linear,
                "residual": rn,
            }

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, dev)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 0.0
        if _compute_baseline:
            t_final = t0 + num_steps * dt
            err = scalar.mms_baseline_error(config, fem_grid, t_end=t_final)
            if err is None and "reference_config" in config:
                ref = self.solve(scalar.merge_reference_config(config), _compute_baseline=False)
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(dev),
            "pde": "cahn_hilliard",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "lambda": lam,
            "mobility": mob,
            "num_steps": num_steps,
            "dt": dt,
            "ksp_type": "gmres",
            "pc_type": "jacobi",
            "rtol": rtol,
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
            num_dofs=2 * ndof,
        )
