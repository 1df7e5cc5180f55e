"""Biharmonic oracle: Lap^2 u = f via the split mixed formulation
  -Lap w = f   with w = -Lap(u_exact) on the boundary
  -Lap u = w_h with u = u_exact      on the boundary

Two SPD solves of the same Laplacian through `solve_linear`, sharing one
lattice operator (opts["_lattice32"]): its GMG hierarchy and the fused
inner kernel object are built once, at the first solve of the cold run.
MMS derives w = -Lap(u_exact) and f = -Lap(w) = Lap^2(u_exact); non-MMS
cases read f from source_term with w = 0 on the boundary. The second
solve's source is the first solve's FEM function at the quadrature points
(an einsum on the device), not re-interpolated.

Port of pdebench_tpu/oracle/biharmonic.py.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import LocalOperator, bc_mask_values, local_stiffness
from ..solvers.dispatch import solve_linear
from . import base, scalar
from .types import OracleResult, compute_rel_L2_grid


class BiharmonicSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, mms_u)
        ctx = scalar.setup_scalar(config, self.device)
        dim = ctx.dim
        space, cb = ctx.space, ctx.cb

        if mms_u is not None:
            u_sym = symbolic.parse(mms_u)
            w_sym = -symbolic.laplacian(u_sym, dim)
            f_sym = sp.simplify(-symbolic.laplacian(w_sym, dim))
            w_bc = base.interpolate_nodal(space, w_sym)
        else:
            f_sym = pde.get("source_term", 0.0)
            w_bc = np.zeros(space.ndof)
        f_fn = symbolic.lambdify_spatial(f_sym, dim, self.device)
        opts = base.solver_opts(config)
        # both split solves share the Laplacian's lattice operator
        opts["_lattice32"] = scalar.maybe_lattice32(ctx, local_stiffness(cb))

        # Dirichlet masks: the same dofs, different values (w, then u)
        bc_dofs = space.boundary_scalar_dofs
        mask_w, g_w = bc_mask_values(space.ndof, bc_dofs, w_bc[bc_dofs], self.device)
        phi = torch.as_tensor(cb.phi, device=self.device)
        dofmap = torch.as_tensor(space.dofmap_scalar, device=self.device)

        def build():
            op = LocalOperator(
                torch.as_tensor(local_stiffness(cb), device=self.device),
                space.dofmap_scalar, space.ndof,
            )
            # first Poisson rhs: -Lap w = f
            return op, ctx.load_vector(f_fn(ctx.qpts()))

        op, b_w = base.charge_setup(ctx, build)

        def run():
            w, info_w = solve_linear(op, b_w, mask_w, g_w, opts, symmetric=True)
            # second Poisson: -Lap u = w_h
            w_q = torch.einsum("qi,ci->cq", phi, torch.as_tensor(w, device=self.device)[dofmap])
            b_u = ctx.load_vector(w_q)
            u, info_u = solve_linear(op, b_u, ctx.mask, ctx.g, opts, symmetric=True)
            info = dict(info_u)
            info["iterations"] = int(info_w.get("iterations", 0)) + int(
                info_u.get("iterations", 0)
            )
            return ctx.sample(u), info

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid)
            if err is None and "reference_config" in config:
                ref = self.solve(
                    scalar.merge_reference_config(config),
                    _compute_baseline=False,
                )
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(self.device),
            "pde": "biharmonic",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "formulation": "split_mixed",
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
