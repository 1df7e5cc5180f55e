"""Wave oracle: d2u/dt2 - c^2 Lap(u) = f, Newmark theta-scheme (theta = 1/4).

Pipeline: assemble M and K once on the host, form the constant step
matrix A = M / dt^2 + theta c^2 K, and build before the timed run
(charged to setup): A's f32 lattice operator, its stencil-GMG hierarchy,
the f64 M and K applies on the same lattice (kernel #1 through the weight
map's plan) and the inner solve's kernel object. The timed run sums every
step's load vector in one batched fixed-order pass, then runs heat's step
loop with the two-level right-hand side

  b_n = M (2 u^n - u^{n-1}) / dt^2 - (1 - 2 theta) c^2 K u^n
        - theta c^2 K u^{n-1} + (f(t_n), v)

(three kernel #1 launches a step) and one mixed-precision refinement a
step (12 GMG-PCG steps a round with a hierarchy, kernel #2 on an unpadded
one; 30 Jacobi-PCG steps without) with the Dirichlet values g(t_n + dt).

Meshes whose dofs form no lattice (the signed-distance domains,
periodic_square, the thin t_junction) take, as the reference does:
  - on CUDA tensors, the same loop on the cell-local operators (the M and
    K applies and the refinement's operators cell-based, every sum in a
    fixed order): from dispatch.AMG_MIN_DOFS dofs on the inner is 12 CG
    steps a round preconditioned by a float32 SA-AMG V-cycle of A, built
    once per case and charged to setup ("amg-cg-ir"; the reference's CPU
    branch, :128-152), below that 30 Jacobi-CG steps ("jacobi-cg-ir");
  - on CPU tensors of at most dispatch.HOST_LU_MAX_DOFS dofs, the host
    SuperLU (A factored once, a back-substitution a step: the
    reference's CPU branch, :113-126), above that the loop of the card;
  - for the untimed re-solve of a no-exact case (reference_config at
    dt / 2) on a mesh whose dof coordinates form no lattice, the host
    SuperLU on every device (the reference's route on every platform,
    :90-100); the main solve's solver_info names the re-solve's route.
solver_info["host_lu"] says why a solve took the host LU.

A step that does not converge raises on a CUDA device; on the CPU the
whole loop is solved again with the host SuperLU, as the reference does.

Scheme (reference: pdebench/oracle/wave.py:34-127):
  u^0    = u_exact(t0) (MMS) or initial_condition
  u^{-1} = u^0 - dt v0,  v0 = d/dt u_exact(t0) (MMS) or initial_velocity
  BCs    = u_exact(t_{n+1}) on all boundary facets (MMS) or the case's bc
  f      = u_tt - c^2 Lap(u_exact) derived symbolically (MMS)

Port of pdebench_tpu/oracle/wave.py (the reference's non-IR
solve_constrained, taken by non-CG ksp types, is not ported).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import local_load, local_mass, local_stiffness
from ..solvers import dispatch
from ..solvers.stencil import detect_lattice
from . import base, heat, scalar
from .types import OracleResult, compute_rel_L2_grid

THETA = 0.25


def amg_step_preconditioner(op, mask: torch.Tensor):
    """The float32 SA-AMG V-cycle of the constrained step matrix `op` (a
    LocalOperator), its levels on mask's device, or (None, why) where the
    coarsest level cannot be inverted: the loop then takes Jacobi, as the
    reference does."""
    from ..solvers.amg import setup_amg_masked_pair

    try:
        _, M32, _ = setup_amg_masked_pair(op.to_scipy(), mask.cpu().numpy(), device=mask.device)
    except np.linalg.LinAlgError as e:
        return None, f"{e}"
    return M32, None


class WaveSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, mms_u)
        c = float(pde.get("pde_params", {}).get("c", 1.0))
        c2 = c * c
        t0, _, dt, num_steps = base.time_params(pde)
        t_final = t0 + num_steps * dt
        opts = base.solver_opts(config)
        if str(opts.get("ksp_type", "cg")).lower() not in ("cg", "minres"):
            raise NotImplementedError(
                f"wave with ksp_type {opts['ksp_type']!r} takes the reference's "
                "solve_constrained, which is not ported"
            )
        ctx = scalar.setup_scalar(config, self.device, t0=t0)
        dim = ctx.dim

        if mms_u is not None:
            src = symbolic.wave_source(mms_u, c2, dim)
            ic = mms_u
            v0_expr = sp.diff(symbolic.parse(mms_u), symbolic.T)
        else:
            src = pde.get("source_term", 0.0)
            ic = pde.get("initial_condition", 0.0)
            v0_expr = pde.get("initial_velocity", 0.0)
        f_steps = symbolic.lambdify_numpy_steps(src, dim)
        u0 = base.interpolate_nodal(ctx.space, ic, t=t0)
        um1 = u0 - dt * base.interpolate_nodal(ctx.space, v0_expr, t=t0)
        _, g_fn = base.dirichlet_traceable(ctx.space, config.get("bc", {}), self.device)

        rtol, atol = float(opts["rtol"]), float(opts.get("atol", 1e-14))
        cb, qpts = ctx.cb, ctx.qpts()
        inv_dt2 = 1.0 / (dt * dt)
        t_ns = t0 + dt * np.arange(num_steps)  # source times t_n
        M, K = local_mass(cb), local_stiffness(cb)
        A = inv_dt2 * M + THETA * c2 * K

        def build():
            return heat.step_operators(ctx, A, (M, K), "cg", heat.INNER_ITERS) + (
                torch.as_tensor(u0, device=self.device),
                torch.as_tensor(um1, device=self.device),
            )

        lat32, gmg_failed, (M_ap, K_ap), op, n_inner, u0_dev, um1_dev = base.charge_setup(
            ctx, build
        )

        # the route off the lattice (module docstring)
        host_lu, M32, amg_failed = None, None, None
        if lat32 is None:
            if not _compute_baseline and detect_lattice(ctx.space.dof_coords) is None:
                host_lu = "no-exact re-solve"
            elif self.device.type == "cpu" and op.ndof <= dispatch.HOST_LU_MAX_DOFS:
                host_lu = "cpu"
            elif op.ndof >= dispatch.AMG_MIN_DOFS:
                # built once, charged to setup; CG-IR takes a multigrid
                # preconditioner's inner count
                t_amg = time.perf_counter()
                M32, amg_failed = amg_step_preconditioner(op, ctx.mask)
                base.synchronize(self.device)
                ctx.t_setup += time.perf_counter() - t_amg
                if M32 is not None:
                    n_inner = heat.INNER_ITERS[0]

        def newmark_rhs(M_ap, K_ap, loads):
            def rhs(n, u, u_prev):
                return (
                    inv_dt2 * M_ap(2.0 * u - u_prev)
                    - (1.0 - 2.0 * THETA) * c2 * K_ap(u)
                    - THETA * c2 * K_ap(u_prev)
                    + loads[n]
                )

            return rhs

        def host_steps(loads):
            rhs = newmark_rhs(heat.host_apply(op, M), heat.host_apply(op, K), loads.cpu().numpy())
            return heat.host_lu_steps(op, rhs, u0, g_fn, t_ns + dt, ctx.mask, u_prev=um1)

        def run():
            loads = heat.step_loads(ctx, [local_load(cb, f_q) for f_q in f_steps(qpts, t_ns)])
            if host_lu is not None:
                return ctx.sample(host_steps(loads)), dict(inner="host-lu", host_lu=host_lu, iterations=1)
            u, info = heat.step_loop(
                op, lat32, newmark_rhs(M_ap, K_ap, loads), u0_dev, g_fn, t_ns + dt, ctx.mask,
                rtol, atol, inner="cg", inner_iters=n_inner, u_prev=um1_dev, M32=M32,
            )
            if "iterative_failed" in info:
                # CPU only: step_loop raises on a CUDA device
                u = host_steps(loads)
                info.update(inner="host-lu", fallback="direct")
            else:
                u = u.cpu().numpy()
            return ctx.sample(u), info

        if _compute_baseline:
            (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        else:
            # the reference re-solve is untimed: one pass
            t_start = time.perf_counter()
            fem_grid, info = run()
            base.synchronize(self.device)
            t_warm = t_cold = time.perf_counter() - t_start
        baseline_time = ctx.t_setup + t_warm
        if gmg_failed:
            info["gmg_failed"] = gmg_failed
        if amg_failed:
            info["amg_failed"] = amg_failed

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid, t_end=t_final)
            if err is None and "reference_config" in config:
                ref = self.solve(
                    scalar.merge_reference_config(config, refine_dt=dt * 0.5),
                    _compute_baseline=False,
                )
                err = compute_rel_L2_grid(fem_grid, ref.reference)
                info["reference_solve"] = {
                    k: ref.solver_info[k] for k in ("inner", "host_lu") if k in ref.solver_info
                }
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(self.device),
            "pde": "wave",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": ctx.space.degree,
            "num_steps": num_steps,
            "dt": dt,
            "theta": THETA,
            "ksp_type": opts["ksp_type"],
            "pc_type": opts["pc_type"],
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
            num_dofs=ctx.space.ndof,
        )
