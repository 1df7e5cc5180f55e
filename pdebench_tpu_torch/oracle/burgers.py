"""Burgers oracle: du/dt + u (u_x + u_y) - nu Lap(u) = f, semi-implicit.

Scheme (reference: pdebench/oracle/burger.py:28-181):
  convection lagged: a = (u / dt) v + u_n (u_x + u_y) v + nu grad u . grad v
  L = (u_n / dt) v + f(t_{n+1}) v
  MMS: f = u_t + u (u_x + u_y) - nu Lap(u); u0 = u_exact(t0)
  t_final = pde.t_final or 0.1, dt = pde.dt or 0.01
  the linear solve of a step at rtol 1e-8, atol 1e-10 whatever the case
  asks (the reference's :123-127)

On a lattice with a hierarchy the step matrix changes every step, but it
is linear in u_n: its stencil weights are W_const + W(u_n), W the bilinear
map of the advection tensor T_adv (`stencil.BilinearLatticeWeightMap`),
built on the host once. So every step runs on the device without a
scatter: heat's step loop (`heat.step_loop`, b = M u_n / dt + b_f, the
mass apply by kernel #1) with the step's weights, solved by
`dispatch.solve_constrained_ir(step_weights=...)`: GMRES(20) in f32
preconditioned by the PyTorch V-cycle of the constant part's hierarchy
(M / dt + nu K), the f64 outer on the float32 weights cast to f64, every
apply one stencil kernel launch. Above the bilinear map's size gate each
step's cell batch (below) is summed into the weights instead, as the
reference does. The reference's switches reach this loop through dispatch:
PDEBENCH_TPU_FUSED=arnoldi runs each round's whole Arnoldi cycle as one
kernel launch ("fused-gmres-step-*"), PDEBENCH_TPU_STEP_RICH=1 makes
kernel #3 the preconditioner ("gmres+fused-richardson-step-*"), and
PDEBENCH_TPU_STEP_OUTER=cell makes each step's exact float64 cell batch
(below, built on the device) the outer's operator, the inner unchanged
(the route the case records were written on; `solver_info["step_outer"]`).

Elsewhere (no lattice: the signed-distance domains, periodic_square, the
thin t_junction; or a lattice without a hierarchy) each step builds the
cell-local A = M / dt + advection(beta = u_n (1, 1) at the quadrature
points) + nu K on the device (`local_advection` on a device beta) and
solves it by the cell-local refinement: the exact float64 cell apply as
the outer, GMRES(60) in f32 with Jacobi on the float32 batch's diagonal
("jacobi-gmres-ir", the reference's :216-224). Periodic cases identify
opposite sides in the function space and carry no Dirichlet rows.

A step that does not converge raises on a CUDA device; on the CPU the
loop goes on and records `iterative_failed`.

Port of pdebench_tpu/oracle/burgers.py.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import LocalOperator, local_advection, local_load, local_mass, local_stiffness
from ..solvers import dispatch
from . import base, heat, scalar
from .types import OracleResult, compute_rel_L2_grid

# the reference's hard-coded linear tolerances of a step
RTOL, ATOL = 1e-8, 1e-10
# GMRES(m) a refinement round of a step: with the constant part's
# hierarchy, with Jacobi (the cell-local route)
INNER_ITERS = 20
CELL_INNER_ITERS = 60


def step_matrices(cb, dt: float, nu: float):
    """(A_const, M) host cell-local batches: every step's constant part
    M / dt + nu K (its lattice and hierarchy) and the mass."""
    M = local_mass(cb)
    return (1.0 / dt) * M + nu * local_stiffness(cb), M


def advection_tensor(cb) -> np.ndarray:
    """T_adv (c, nl, nl, nl): the lagged convection u_n (1, ..., 1) .
    grad u, sum_k T[c, i, j, k] u_n[k], every direction's basis gradient
    summed."""
    g_sum = cb.grad_phys().sum(-1)  # (c, nq, nl)
    return np.einsum("cq,qi,qk,cqj->cijk", cb.wdetJ, cb.phi, cb.phi, g_sum, optimize=True)


class BurgersSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        periodic = "periodic" in config.get("bc", {})
        if mms_u is not None and not periodic:
            config = scalar.override_bc_with_mms(config, mms_u)
            pde = config["pde"]
        nu = float(pde.get("pde_params", {}).get("nu", 0.01))
        t0, t_end, dt, num_steps = base.time_params(pde, default_t_end=0.1, default_dt=0.01)
        t_final = t0 + num_steps * dt

        ctx = scalar.setup_scalar(config, self.device, t0=t0)
        dim = ctx.dim
        if mms_u is not None:
            u_sym = symbolic.parse(mms_u)
            sv = [symbolic.X, symbolic.Y, symbolic.Z][:dim]
            conv = u_sym * sum(sp.diff(u_sym, v) for v in sv)
            src = sp.diff(u_sym, symbolic.T) + conv - nu * symbolic.laplacian(u_sym, dim)
            ic = mms_u
        else:
            src = pde.get("source_term", 0.0)
            ic = pde.get("initial_condition", 0.0)
        f_steps = symbolic.lambdify_numpy_steps(src, dim)
        u0 = base.interpolate_nodal(ctx.space, ic, t=t0)
        _, g_fn = base.dirichlet_traceable(ctx.space, config.get("bc", {}), self.device)

        space, cb, qpts = ctx.space, ctx.cb, ctx.qpts()
        ts = t0 + dt * np.arange(1, num_steps + 1)
        A_const, M = step_matrices(cb, dt, nu)

        dev = self.device
        # PDEBENCH_TPU_STEP_OUTER=cell: each step's exact float64 cell
        # batch is the outer's operator on a lattice too (the reference's
        # _need_A)
        cell_outer = dispatch.step_outer() == "cell"

        def cells(ops, u_n):
            """The step's cell batch A = M / dt + advection(u_n) + nu K on
            the device, the convection coefficient u_n (1, ..., 1) at the
            quadrature points."""
            M_loc, K_loc, phi, dofmap = ops
            un_q = torch.einsum("qi,ci->cq", phi, u_n[dofmap])
            beta_q = un_q[..., None].expand(-1, -1, dim)
            return (1.0 / dt) * M_loc + local_advection(cb, beta_q) + nu * K_loc

        def build():
            u0_dev = torch.as_tensor(u0, device=dev)
            step = scalar.bilinear_step_lattice(ctx, A_const, lambda: advection_tensor(cb))
            ops = None
            if step is None or step[2] is None or cell_outer:
                # the device pieces of the per-step cell batch
                ops = (torch.as_tensor(M, device=dev), torch.as_tensor(local_stiffness(cb), device=dev),
                       cb.on("phi", dev), torch.as_tensor(space.dofmap_scalar, device=dev))
            if step is None:
                # the cell-local route: one operator's dofs and sum plan,
                # a fresh cell batch every step
                mass_op = LocalOperator(ops[0], space.dofmap_scalar, space.ndof)
                return None, mass_op, None, None, ops, u0_dev
            lat32, wmap, bwm = step
            (mass_apply,) = scalar.stencil_appliers64(lat32, space.dofmap_scalar, M)
            W_c32 = torch.as_tensor(wmap.weights_np(A_const), device=dev).to(torch.float32)
            P = None if bwm is None else bwm.device_stack(dev)
            cell_op = None
            if cell_outer:
                # the step batches' dofs and fixed-order sum plan, built once
                cell_op = LocalOperator(ops[0], space.dofmap_scalar, space.ndof)
                cell_op.gather_sum()
            return lat32, mass_apply, (wmap, bwm, W_c32, cell_op), P, ops, u0_dev

        lat32, mass_apply, wparts, P, ops, u0_dev = base.charge_setup(ctx, build)

        if lat32 is None:
            step_kw = dict(step_op=lambda u_n: mass_apply.with_local(cells(ops, u_n)))
            n_inner = CELL_INNER_ITERS
        else:
            wmap, bwm, W_c32, cell_op = wparts

            def step_weights(u_n):
                if bwm is None:
                    # above the bilinear map's gate: the cell batch summed
                    # into the weights in a fixed order
                    return wmap, wmap.weights(cells(ops, u_n).to(torch.float32))
                u_lat = lat32.lattice.embed(u_n.to(torch.float32), 0.0).reshape(wmap.shape)
                return wmap, W_c32 + bwm.weights_w(P, u_lat)

            step_kw = dict(step_weights=step_weights)
            if cell_op is not None:
                step_kw["step_op"] = lambda u_n: cell_op.with_local(cells(ops, u_n))
            n_inner = INNER_ITERS

        def run():
            loads = heat.step_loads(ctx, [local_load(cb, f_q) for f_q in f_steps(qpts, ts)])
            u, info = heat.step_loop(
                None, lat32, heat.mass_rhs(mass_apply, loads, 1.0 / dt), u0_dev, g_fn, ts,
                ctx.mask, RTOL, ATOL, inner="gmres", inner_iters=n_inner, **step_kw,
            )
            return ctx.sample(u.cpu().numpy()), info

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid, t_end=t_final)
            if err is None and "reference_config" in config:
                ref = self.solve(scalar.merge_reference_config(config), _compute_baseline=False)
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(self.device),
            "pde": "burgers",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "nu": nu,
            "num_steps": num_steps,
            "dt": dt,
            "ksp_type": "gmres",
            "pc_type": "jacobi",
            "rtol": RTOL,
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
