"""Heat oracle: du/dt - div(kappa grad u) = f, backward Euler.

Pipeline: assemble M and K once on the host, form A = M + dt K, and build
before the timed run (charged to setup): A's f32 lattice operator, its
stencil-GMG hierarchy, the f64 mass weights on the same lattice and the
inner solve's kernel object. The timed run sums every step's load vector
in one batched fixed-order pass (`GatherSum.many`), then runs the step
loop on the device: b = M u_n + dt f(t_{n+1}) through the stencil kernel,
and one mixed-precision refinement per step (f64 outer stencil residual,
f32 inner: 12 GMG-PCG steps a round with a hierarchy, in one fused kernel
launch on an unpadded one; 30 Jacobi-PCG steps without) with the
Dirichlet values g(t_{n+1}).

A step that does not converge raises on a CUDA device; on the CPU the
whole loop is solved again with the host SuperLU (one factorization, a
back-substitution a step), as the reference does.

Scheme (reference: pdebench/oracle/heat.py):
  a = (u v + dt kappa grad u . grad v) dx
  L = (u_prev + dt f(t_{n+1})) v dx
  u0   = u_exact(t0) (MMS) or initial_condition
  BCs  = u_exact(t_{n+1}) on all boundary facets (MMS) or the case's bc
  f    = u_t - div(kappa grad u_exact) derived symbolically (MMS)
  num_steps = int((t_end - t0)/dt + 0.5)

Where the dofs form no lattice the same loop runs on the cell-local
operators (`step_operators`' cell-local pieces, the refinement's inner
Jacobi-preconditioned, 30 CG steps a round).

A case whose ksp_type is not CG (gmres, bicgstab, preonly, ...) solves
every step with `dispatch.solve_constrained` on the cell-local
operators, as the reference does (its heat.py:128-133): float64 Krylov
with Jacobi on the constrained diagonal, the mass apply cell-based.

Port of pdebench_tpu/oracle/heat.py.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem import symbolic
from ..fem.assemble import LocalOperator, local_load, local_mass, local_stiffness
from ..solvers import dispatch
from ..solvers.direct import ConstrainedLU
from . import base, scalar
from .types import OracleResult, compute_rel_L2_grid

# inner steps of one refinement round: with a GMG hierarchy, without
INNER_ITERS = (12, 30)


def step_matrices(ctx, pde: Dict[str, Any], dt: float) -> Tuple[np.ndarray, np.ndarray]:
    """(A = M + dt K, M): a heat case's step matrix and mass matrix as
    host cell-local batches (kappa evaluated on the host)."""
    kspec = pde.get("coefficients", {}).get("kappa") or None
    kappa_q = base.coefficient_fn(kspec, ctx.dim, "cpu")(ctx.qpts()).numpy()
    M = local_mass(ctx.cb)
    return M + dt * local_stiffness(ctx.cb, kappa_q), M


def step_operators(
    ctx, A: np.ndarray, applied: Sequence[np.ndarray], inner: str, inner_iters: Tuple[int, int],
    lattice: bool = True,
):
    """The constant pieces of a step loop on its step matrix A (heat's M +
    dt L; host cell-local batches): (lattice operator with its hierarchy,
    the hierarchy's failure or None, the f64 applies of the `applied`
    cell-local matrices (the mass matrix; wave's stiffness too), A as a
    LocalOperator, the inner steps a round). Builds the inner's kernel
    object too. The applies are stencil kernel launches on the lattice,
    and cell-based applies on the device where the applied node pairs
    reach further than the weight map takes (the reference's
    `_apply_local` there). Where the dofs form no lattice, the cell-local
    pieces: no lattice operator, the applies cell-based, inner_iters[1]
    steps a round (Jacobi; a caller with an AMG V-cycle passes its own
    count to step_loop). lattice=False gives the cell-local pieces on
    every mesh (the steps of a non-CG ksp: `solve_constrained`)."""
    space, device = ctx.space, ctx.device
    op = LocalOperator(torch.as_tensor(A, device=device), space.dofmap_scalar, space.ndof)

    def cell_applies():
        return [op.with_local(torch.as_tensor(a, device=device)) for a in applied]

    lat32 = scalar.maybe_lattice32(ctx, A) if lattice else None
    if lat32 is None:
        return None, None, cell_applies(), op, inner_iters[1]
    gmg_failed = scalar.attach_gmg(lat32, space.ndof, ctx.mask.cpu().numpy())
    appliers = scalar.stencil_appliers64(lat32, space.dofmap_scalar, *applied) or cell_applies()
    n_inner = inner_iters[0] if lat32.gmg is not None else inner_iters[1]
    dispatch.prepare_inner(op, ctx.mask, lat32, inner, n_inner)
    return lat32, gmg_failed, appliers, op, n_inner


def step_loads(ctx, cell_loads: Sequence[np.ndarray]) -> torch.Tensor:
    """(S, ndof) load vectors of S steps from their host cell
    contributions, summed in one batched fixed-order pass on the device."""
    vals = torch.as_tensor(np.stack(cell_loads), device=ctx.device)
    return ctx.gather_sum().many(vals)


def mass_rhs(mass_apply: Callable, loads: torch.Tensor, mass_scale: float = 1.0) -> Callable:
    """A backward-Euler step's right-hand side for step_loop: b_n =
    mass_scale M u_n + loads[n]. Heat's A = M + dt K takes loads dt f
    (mass_scale 1); reaction-diffusion's and Burgers' A = M / dt + ...
    take the loads as they are and mass_scale 1 / dt, the reference's
    scaling (the absolute atol decides when rounds stop)."""

    def rhs(n: int, u: torch.Tensor, _u_prev) -> torch.Tensor:
        b = mass_apply(u)
        if mass_scale != 1.0:
            b = mass_scale * b
        return b + loads[n]

    return rhs


def step_loop(
    op: Optional[LocalOperator],
    lat32,
    rhs: Callable,
    u0: torch.Tensor,
    g_fn: Callable,
    ts: np.ndarray,
    mask: torch.Tensor,
    rtol: float,
    atol: float,
    *,
    inner: str,
    inner_iters: int,
    u_prev: Optional[torch.Tensor] = None,
    step_weights: Optional[Callable] = None,
    step_op: Optional[Callable] = None,
    M32: Optional[Callable] = None,
    method: Optional[str] = None,
    maxiter: int = 25000,
) -> Tuple[Optional[torch.Tensor], Dict[str, Any]]:
    """Steps u_{n+1} = A^{-1} rhs(n, u_n, u_{n-1}) with u_{n+1} =
    g_fn(ts[n]) on the Dirichlet dofs, one refinement per step, from u0
    (and u_prev, the iterate before it, for a two-level recurrence such as
    wave's Newmark scheme; backward Euler reads only u_n: `mass_rhs`).
    `step_weights(u_n)` gives a per-step operator's (weight map, float32
    weights) on lat32's lattice for solve_constrained_ir (Burgers); without
    it every step solves lat32's operator. Without a lattice (lat32 None)
    every step solves the cell-local `op`, or `step_op(u_n)`, a fresh cell
    batch on op's dofs (Burgers' lagged convection), preconditioned by
    M32 (a float32 AMG V-cycle built once) or Jacobi. With `method` (a
    non-CG ksp: "gmres" or "bicgstab") every step solves the cell-local
    `op` with `dispatch.solve_constrained` instead, at most `maxiter`
    iterations ("jacobi-<method>"; lat32 must be None).

    Returns (u, info): info has the inner's name, the iterations and the
    per-step outer rounds (with `method`, the per-step Krylov iterations
    under "step_iterations"). A step that does not converge raises on a CUDA
    device; on the CPU the loop goes on from its iterate, as the
    reference's scan does, and info["iterative_failed"] names the first
    such step."""
    u = u0
    names, rounds, iterations, residual, failed = [], [], 0, None, None
    if method is not None and lat32 is not None:
        raise ValueError("a step loop with a non-CG method takes the cell-local operator")
    for n, t in enumerate(ts):
        b = rhs(n, u, u_prev)
        if method is not None:
            x, its, residual, conv = dispatch.solve_constrained(
                op, b, mask, g_fn(t), method, rtol, atol, maxiter
            )
            name = f"jacobi-{method}"
        else:
            x, its, residual, conv, name = dispatch.solve_constrained_ir(
                op if step_op is None else step_op(u), b, mask, g_fn(t), lat32, rtol, atol,
                inner=inner, inner_iters=inner_iters, max_outer=dispatch.STEP_MAX_OUTER,
                step_weights=None if step_weights is None else step_weights(u),
                M32_custom=M32,
            )
        names.append(name)
        rounds.append(its if method is not None else its // inner_iters)
        iterations += its
        if not conv and failed is None:
            failed = dict(
                step=n + 1, t=float(t), inner=name, outer_rounds=rounds[-1], residual=residual,
            )
            if b.device.type != "cpu":
                raise RuntimeError(
                    f"step {n + 1} of {len(ts)} did not converge on {b.device}: {failed} "
                    f"(rtol {rtol}, atol {atol})"
                )
        u_prev, u = u, x
    if len(set(names)) != 1:
        raise RuntimeError(f"the steps took different inner solves: {sorted(set(names))}")
    info = dict(inner=names[0], iterations=iterations, residual=residual)
    info["step_iterations" if method is not None else "outer_rounds"] = rounds
    if failed is not None:
        info["iterative_failed"] = failed
    return u, info


def host_apply(op: LocalOperator, A_local: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    """The cell-based apply of a cell-local matrix on op's dofs, numpy in
    and out (host_lu_steps' right-hand sides)."""
    A_op = LocalOperator(torch.as_tensor(A_local), op.dofmap.cpu().numpy(), op.ndof)
    return lambda v: A_op(torch.as_tensor(v)).numpy()


def host_lu_steps(
    op: LocalOperator, rhs: Callable, u0: np.ndarray, g_fn: Callable, ts: np.ndarray,
    mask: torch.Tensor, u_prev: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The steps of step_loop with the host SuperLU: A factored once, one
    back-substitution a step (CPU tensors only); rhs(n, u_n, u_{n-1})
    takes and gives numpy vectors (the cell-based applies of
    `host_apply`)."""
    flu = ConstrainedLU(op.to_scipy(), mask.cpu().numpy())
    uh = np.asarray(u0, dtype=np.float64)
    for n, t in enumerate(ts):
        x = flu.solve(rhs(n, uh, u_prev), g_fn(t).cpu().numpy())
        u_prev, uh = uh, x
    return uh


class HeatSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, mms_u)
        t0, t_end, dt, num_steps = base.time_params(pde)
        t_final = t0 + num_steps * dt
        ctx = scalar.setup_scalar(config, self.device, t0=t0)
        dim = ctx.dim

        kspec = pde.get("coefficients", {}).get("kappa") or {}
        if mms_u is not None:
            kexpr = kspec.get("expr", kspec.get("value", 1.0)) if kspec else 1.0
            src = symbolic.heat_source(mms_u, kexpr, dim)
            ic = mms_u
        else:
            src = pde.get("source_term", 0.0)
            ic = pde.get("initial_condition", 0.0)
        f_steps = symbolic.lambdify_numpy_steps(src, dim)
        u0 = base.interpolate_nodal(ctx.space, ic, t=t0)
        _, g_fn = base.dirichlet_traceable(ctx.space, config.get("bc", {}), self.device)

        opts = base.solver_opts(config)
        # a non-CG ksp: solve_constrained every step, on the cell-local
        # operators (the reference's route on every platform)
        method = dispatch.krylov_method(opts, symmetric=True)
        krylov = None if method == "cg" else method
        maxiter = int(opts.get("max_it", 25000))
        rtol, atol = float(opts["rtol"]), float(opts.get("atol", 1e-14))
        cb, qpts = ctx.cb, ctx.qpts()
        ts = t0 + dt * np.arange(1, num_steps + 1)
        A, M = step_matrices(ctx, pde, dt)

        def build():
            return step_operators(ctx, A, (M,), "cg", INNER_ITERS, lattice=krylov is None) + (
                torch.as_tensor(u0, device=self.device),
            )

        lat32, gmg_failed, (mass_apply,), op, n_inner, u0_dev = base.charge_setup(ctx, build)

        def run():
            loads = step_loads(ctx, [local_load(cb, f_q) for f_q in f_steps(qpts, ts)])
            u, info = step_loop(
                op, lat32, mass_rhs(mass_apply, dt * loads), u0_dev, g_fn, ts, ctx.mask,
                rtol, atol, inner="cg", inner_iters=n_inner, method=krylov, maxiter=maxiter,
            )
            if "iterative_failed" in info:
                # CPU only: step_loop raises on a CUDA device
                M_h, loads_h = host_apply(op, M), loads.cpu().numpy()
                u = host_lu_steps(
                    op, lambda n, uh, _: M_h(uh) + dt * loads_h[n], u0, g_fn, ts, ctx.mask
                )
                info.update(inner="host-lu", fallback="direct")
            else:
                u = u.cpu().numpy()
            return ctx.sample(u), info

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_time = ctx.t_setup + t_warm
        if gmg_failed:
            info["gmg_failed"] = gmg_failed

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
            "pde": "heat",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": ctx.space.degree,
            "num_steps": num_steps,
            "dt": dt,
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
