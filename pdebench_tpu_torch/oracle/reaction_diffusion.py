r"""Reaction-diffusion oracle: du/dt - eps Lap(u) + R(u) = f, backward
Euler, a Newton solve per step for the nonlinear reactions.

Reactions (reference: pdebench/oracle/reaction_diffusion.py:44-90):
linear alpha u; cubic alpha u + beta u^3; allen_cahn lambda (u^3 - u);
logistic rho u (1 - u).

Scheme (reference :344-405):
  F(u) = M (u - u_n) / dt + eps K u + \int R(u) v - \int f(t_{n+1}) v
  Newton: J = M / dt + eps K + \int R'(u) phi_i phi_j, warm-started from
  the previous step; tolerances snes_rtol / atol, max_it.
  MMS: f = u_t - eps Lap(u_exact) + R(u_exact); BCs and IC from u_exact.
  num_steps = ceil((t_end - t0) / dt).

Linear reactions: the step matrix A = M / dt + eps K + alpha M is
constant, so heat's step loop solves it (`heat.step_loop`, the
reference's scaling: b = M u_n / dt + b_f): on a lattice kernel #2 at 12
PCG steps a round on an unpadded hierarchy and kernel #1 for the f64 mass
apply; off the lattice the cell-local refinement, 30 Jacobi-CG steps a
round ("jacobi-cg-ir").

Nonlinear reactions (`newton_steps`): the Newton residual on the device,
its mass and stiffness applies in f64 (kernel #1 on a lattice, cell-based
off it), R(u) at the quadrature points summed into dofs in a fixed order
(GatherSum). On a lattice with a hierarchy the Jacobian is per-step
stencil weights W_const + W(R'(u)), R' interpolated at the nodes so that
the mass-weighted term is a bilinear map of a nodal field
(`stencil.BilinearLatticeWeightMap` on T_mass; above its size gate, the
reference's cell Jacobian with R' at the quadrature points, summed into
weights in a fixed order: `solver_info["jacobian_weights"]`), solved by
`dispatch.solve_constrained_ir(step_weights=...)`: GMRES(15) in f32
preconditioned by the PyTorch V-cycle of the constant part's hierarchy,
the f64 outer on the float32 weights cast to f64 (the reference's
switches reach it through dispatch: PDEBENCH_TPU_FUSED=arnoldi,
PDEBENCH_TPU_STEP_RICH=1, and PDEBENCH_TPU_STEP_OUTER=cell, which makes
the cell Jacobian, R' at the quadrature points, the outer's operator;
`solver_info["step_outer"]`). Elsewhere (no lattice,
or a lattice without a hierarchy) the Jacobian is the cell batch J = M /
dt + eps K + local_mass(R'(u) at the quadrature points), built on the
device each Newton iteration, solved by the cell-local refinement:
GMRES(60) in f32 with Jacobi, at most NEWTON_MAX_OUTER rounds
("jacobi-gmres-ir", the reference's :283-330). One host read of the
residual norm a Newton iteration. A step whose Newton (or linear IR)
stops above its tolerance raises on a CUDA device; on the CPU the loop
goes on and records `iterative_failed`, as the reference's scan does.

Port of pdebench_tpu/oracle/reaction_diffusion.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import CellBatch, GatherSum, LocalOperator, local_load, local_mass, local_stiffness
from ..solvers import dispatch
from . import base, heat, scalar
from .convection_diffusion import transient_time
from .types import OracleResult, compute_rel_L2_grid

_U = sp.Symbol("u", real=True)
# the Newton direction: GMRES(m) a round (with the constant part's
# hierarchy, with Jacobi on the cell-local Jacobian), rounds, and its
# relative tolerance's floor (inexact Newton: the outer loop enforces the
# nonlinear tolerance)
NEWTON_GMRES = 15
NEWTON_GMRES_CELL = 60
NEWTON_MAX_OUTER = 10
NEWTON_LIN_RTOL = 1e-6


def reaction_expr(reaction: Dict[str, Any]) -> Tuple[sp.Expr, bool]:
    """R(u) as sympy in `u`, and whether it is nonlinear."""
    rtype = str(reaction.get("type", "linear")).lower()
    if rtype == "linear":
        return sp.sympify(reaction.get("alpha", 0.0)) * _U, False
    if rtype in ("cubic", "poly3"):
        a = sp.sympify(reaction.get("alpha", 0.0))
        b = sp.sympify(reaction.get("beta", 1.0))
        return a * _U + b * _U**3, True
    if rtype in ("allen_cahn", "allen-cahn"):
        lam = sp.sympify(reaction.get("lambda", reaction.get("lam", 1.0)))
        return lam * (_U**3 - _U), True
    if rtype in ("logistic", "fisher_kpp", "fisher-kpp"):
        rho = sp.sympify(reaction.get("rho", 1.0))
        return rho * _U * (1 - _U), True
    raise ValueError(f"unsupported reaction type: {rtype}")


def reaction_fns(R_sym: sp.Expr) -> Tuple[Callable, Callable]:
    """(R, R') on tensors of field values."""
    return symbolic.lambdify_field(R_sym, _U), symbolic.lambdify_field(sp.diff(R_sym, _U), _U)


def step_matrices(cb, dt: float, epsilon: float, R_sym: sp.Expr):
    """(A_pre, A_c, M, K) host cell-local batches: every step's constant
    part A_pre = M / dt + eps K + R'(0) M (its lattice and hierarchy), the
    Jacobian's constant weights' A_c = M / dt + eps K, the mass and the
    stiffness."""
    M, K = local_mass(cb), local_stiffness(cb)
    rp0 = float(sp.diff(R_sym, _U).subs(_U, 0))
    A_c = (1.0 / dt) * M + epsilon * K
    return A_c + rp0 * M, A_c, M, K


def mass_tensor(cb) -> np.ndarray:
    """T_mass (c, nl, nl, nl): the mass weighted by a nodal field v,
    sum_k T[c, i, j, k] v_k, the Jacobian's R'(u) term."""
    phi = cb.phi
    return np.einsum("cq,qi,qj,qk->cijk", cb.wdetJ, phi, phi, phi, optimize=True)


@dataclass
class NewtonSteps:
    """The constant pieces of the nonlinear step loop, built once (setup):
    on a lattice with a hierarchy, the lattice, the step weights' map, the
    bilinear map with its P on the device and the constant part's float32
    weights W_c32 = (M / dt + eps K) on the map's offsets (above the
    bilinear map's size gate, no bilinear map); elsewhere no lattice. The
    cell batches M and K on the device where a Jacobian is a cell batch
    (`cells` sums them with the R'(u) mass through its fixed-order plan),
    the f64 mass and stiffness applies, and the quadrature data of the
    reaction load and the Jacobian."""

    lat32: Any
    wmap: Any
    bwm: Any
    P: Any
    W_c32: Optional[torch.Tensor]
    M_loc: Optional[torch.Tensor]
    K_loc: Optional[torch.Tensor]
    cells: Optional[LocalOperator]
    mass_apply: Callable
    stiff_apply: Callable
    gather: GatherSum
    cb: CellBatch
    phi: torch.Tensor  # (nq, nl)
    wdetJ: torch.Tensor  # (c, nq)
    dofmap: torch.Tensor  # (c, nl)
    R: Callable
    Rp: Callable
    epsilon: float
    dt: float

    def at_q(self, u):
        """u at the quadrature points (c, nq)."""
        return torch.einsum("qi,ci->cq", self.phi, u[self.dofmap])

    def residual(self, u, u_n, b_f, mask):
        """F(u) with zero rows at the Dirichlet dofs: the reference's,
        R(u) at the quadrature points."""
        u_q = self.at_q(u)
        load = self.gather(torch.einsum("qi,cq->ci", self.phi, self.wdetJ * self.R(u_q)))
        G = (
            (1.0 / self.dt) * self.mass_apply(u - u_n)
            + self.epsilon * self.stiff_apply(u)
            + load
            - b_f
        )
        return torch.where(mask, 0.0, G)

    def jacobian_cells(self, u):
        """The reference's cell Jacobian M / dt + eps K + the mass weighted
        by R'(u) at the quadrature points, (c, nl, nl) float64 on the
        device."""
        rp_mass = local_mass(self.cb, self.Rp(self.at_q(u)))
        return (1.0 / self.dt) * self.M_loc + self.epsilon * self.K_loc + rp_mass

    def jacobian_weights(self, u):
        """(wmap, float32 weights) of J(u) on the lattice: R' interpolated
        at the nodes through the bilinear map or, above its size gate, the
        cell Jacobian cast to float32 and summed into weights in a fixed
        order (the reference scatter-adds that batch there). Either
        Jacobian only steers Newton: the residual decides its stop."""
        if self.bwm is not None:
            lat = self.lat32.lattice
            v_lat = lat.embed(self.Rp(u).to(torch.float32), 0.0).reshape(self.wmap.shape)
            return self.wmap, self.W_c32 + self.bwm.weights_w(self.P, v_lat)
        return self.wmap, self.wmap.weights(self.jacobian_cells(u).to(torch.float32))

    def direction(self, u, G, mask, zeros, lin_rtol, atol):
        """The Newton direction J(u) d = -G: the step weights' solve on a
        lattice (its outer the cell Jacobian where `cells` is set on a
        lattice), the cell-local one elsewhere. Returns solve_constrained_ir's
        (d, iterations, residual, converged, inner name)."""
        if self.lat32 is None:
            op, sw, n_inner = self.cells.with_local(self.jacobian_cells(u)), None, NEWTON_GMRES_CELL
        else:
            # the cell batch on a lattice: the exact outer of
            # PDEBENCH_TPU_STEP_OUTER=cell
            op = None if self.cells is None else self.cells.with_local(self.jacobian_cells(u))
            sw, n_inner = self.jacobian_weights(u), NEWTON_GMRES
        return dispatch.solve_constrained_ir(
            op, -G, mask, zeros, self.lat32, lin_rtol, atol,
            inner="gmres", inner_iters=n_inner, max_outer=NEWTON_MAX_OUTER, step_weights=sw,
            cell_outer=op is not None,
        )


def newton_steps(
    ns: NewtonSteps,
    u0: torch.Tensor,
    loads: torch.Tensor,
    g_fn: Callable,
    ts: np.ndarray,
    mask: torch.Tensor,
    rtol: float,
    atol: float,
    max_it: int,
    lin_rtol: float,
):
    """Backward-Euler steps with a Newton solve each, warm-started from
    the previous step with the step's Dirichlet values: stop when the
    residual norm is at most max(rtol |F(u_init)|, atol) or after max_it
    iterations; each direction solves J d = -F to lin_rtol. Returns (u,
    info): the inner's name, the Newton iterations and the linear
    iterations of every step, their total, the last residual norm."""
    u = u0
    zeros = torch.zeros_like(u0)
    newton, linear, names, failed = [], [], set(), None
    rn = None
    for n, t in enumerate(ts):
        u_n = u
        u = torch.where(mask, g_fn(t), u_n)
        k, lin_it = 0, 0
        while True:
            G = ns.residual(u, u_n, loads[n], mask)
            rn = float(torch.linalg.norm(G))
            if k == 0:
                tol = max(rtol * rn, atol)
            if k >= max_it or rn <= tol:
                break
            # the reference does not look at the direction's convergence
            d, its, _, _, name = ns.direction(u, G, mask, zeros, lin_rtol, atol)
            names.add(name)
            u = u + d
            k += 1
            lin_it += its
        newton.append(k)
        linear.append(lin_it)
        if rn > tol and failed is None:
            failed = dict(step=n + 1, t=float(t), newton_iterations=k, residual=rn, tol=tol)
            if u.device.type != "cpu":
                raise RuntimeError(
                    f"Newton step {n + 1} of {len(ts)} did not converge on {u.device}: {failed}"
                )
    if len(names) > 1:
        raise RuntimeError(f"the Newton directions took different inner solves: {sorted(names)}")
    info = dict(
        inner=names.pop() if names else ("jacobi-gmres-ir" if ns.lat32 is None else "gmres+vcycle"),
        newton_iterations=newton, linear_iterations=linear,
        iterations=sum(linear), residual=rn,
    )
    if ns.lat32 is not None:
        info["step_outer"] = "stencil" if ns.cells is None else "cell"
    if failed is not None:
        info["iterative_failed"] = failed
    return u, info


class ReactionDiffusionSolver:
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
        params = pde.get("pde_params", {})
        epsilon = float(params.get("epsilon", 1.0))
        R_sym, nonlinear = reaction_expr(params.get("reaction", {}))
        R_fn, Rp_fn = reaction_fns(R_sym)
        # num_steps is the ceiling of (t_end - t0) / dt, t_end 1.0 unless given
        t0, t_end, dt, num_steps = transient_time({"t_end": 1.0, **pde.get("time", {})})
        t_final = t0 + num_steps * dt

        ctx = scalar.setup_scalar(config, self.device, t0=t0)
        dim = ctx.dim
        if mms_u is not None:
            u_sym = symbolic.parse(mms_u)
            src = (
                sp.diff(u_sym, symbolic.T)
                - epsilon * symbolic.laplacian(u_sym, dim)
                + R_sym.subs(_U, u_sym)
            )
            ic = mms_u
        else:
            src = pde.get("source_term", 0.0)
            ic = pde.get("initial_condition", 0.0)
        f_steps = symbolic.lambdify_numpy_steps(src, dim)
        u0 = base.interpolate_nodal(ctx.space, ic, t=t0)
        _, g_fn = base.dirichlet_traceable(ctx.space, config.get("bc", {}), self.device)

        opts = base.solver_opts(config)
        method = dispatch.krylov_method(opts)
        ksp_rtol = float(opts.get("ksp_rtol", opts.get("rtol", 1e-10)))
        newton_rtol = float(opts.get("rtol", 1e-10))
        atol = float(opts.get("atol", 1e-12))
        newton_maxit = int(opts.get("max_it", 30))

        space, cb, qpts = ctx.space, ctx.cb, ctx.qpts()
        ts = t0 + dt * np.arange(1, num_steps + 1)
        A_pre, A_c, M, K = step_matrices(cb, dt, epsilon, R_sym)

        def step_loads():
            return heat.step_loads(ctx, [local_load(cb, f_q) for f_q in f_steps(qpts, ts)])

        if not nonlinear:

            def build():
                return heat.step_operators(ctx, A_pre, (M,), "cg", heat.INNER_ITERS) + (
                    torch.as_tensor(u0, device=self.device),
                )

            lat32, gmg_failed, (mass_apply,), op, n_inner, u0_dev = base.charge_setup(ctx, build)

            def run():
                u, info = heat.step_loop(
                    op, lat32, heat.mass_rhs(mass_apply, step_loads(), 1.0 / dt), u0_dev, g_fn,
                    ts, ctx.mask, ksp_rtol, atol, inner="cg", inner_iters=n_inner,
                )
                if gmg_failed:
                    info["gmg_failed"] = gmg_failed
                return ctx.sample(u.cpu().numpy()), info

        else:

            def build():
                dev = self.device
                step = scalar.bilinear_step_lattice(ctx, A_pre, lambda: mass_tensor(cb))
                lat32, wmap, bwm = step if step is not None else (None, None, None)
                bilinear = bwm is not None
                # PDEBENCH_TPU_STEP_OUTER=cell: the cell Jacobian is the
                # outer's operator on a lattice too
                cell_outer = lat32 is not None and dispatch.step_outer() == "cell"
                batches = not bilinear or cell_outer
                M_loc = torch.as_tensor(M, device=dev) if batches else None
                K_loc = torch.as_tensor(K, device=dev) if batches else None
                cells = None
                if lat32 is None or cell_outer:
                    cells = LocalOperator(M_loc, space.dofmap_scalar, space.ndof)
                    cells.gather_sum()
                if lat32 is None:
                    mass_apply, stiff_apply = cells, cells.with_local(K_loc)
                else:
                    mass_apply, stiff_apply = scalar.stencil_appliers64(
                        lat32, space.dofmap_scalar, M, K
                    )
                ns = NewtonSteps(
                    lat32=lat32, wmap=wmap, bwm=bwm, P=bwm.device_stack(dev) if bilinear else None,
                    W_c32=(torch.as_tensor(wmap.weights_np(A_c), device=dev).to(torch.float32)
                           if bilinear else None),
                    M_loc=M_loc, K_loc=K_loc, cells=cells,
                    mass_apply=mass_apply, stiff_apply=stiff_apply, gather=ctx.gather_sum(),
                    cb=cb, phi=cb.on("phi", dev), wdetJ=cb.on("wdetJ", dev),
                    dofmap=torch.as_tensor(space.dofmap_scalar, device=dev),
                    R=R_fn, Rp=Rp_fn,
                    epsilon=epsilon, dt=dt,
                )
                return ns, torch.as_tensor(u0, device=dev)

            ns, u0_dev = base.charge_setup(ctx, build)

            def run():
                u, info = newton_steps(
                    ns, u0_dev, step_loads(), g_fn, ts, ctx.mask, newton_rtol, atol,
                    newton_maxit, max(NEWTON_LIN_RTOL, ksp_rtol),
                )
                info["jacobian_weights"] = (
                    "bilinear" if ns.bwm is not None else "cell-batch" if ns.lat32 is not None else "cell-local"
                )
                return ctx.sample(u.cpu().numpy()), info

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid, t_end=t_final)
            if err is None and "reference_config" in config:
                ref = self.solve(
                    scalar.merge_reference_config(config, refine_dt=dt * 0.5),
                    _compute_baseline=False,
                )
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(self.device),
            "pde": "reaction_diffusion",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "reaction": params.get("reaction", {}).get("type", "linear"),
            "nonlinear": nonlinear,
            "method": "newton" if nonlinear else method,
            "num_steps": num_steps,
            "dt": dt,
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
