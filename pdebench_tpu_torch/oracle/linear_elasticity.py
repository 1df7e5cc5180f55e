"""Linear elasticity oracle: -div(sigma(u)) = f, sigma = 2 mu eps(u)
+ lam tr(eps) I, vector Lagrange elements.

Pipeline: mesh -> blocked cell-local stiffness (affine GEMM path) ->
on structured meshes a block lattice stencil operator (a 2 x 2 block of
weight planes per offset) + block stencil GMG -> mixed-precision
refinement (f32 fused block GMG-PCG inner, f64 outer block stencil
residual); off the lattice SA-AMG on the rigid-body near-nullspace with
node-block aggregation (solvers/amg.py) preconditioning CG-IR -> grid
sampling of the displacement magnitude.

  - Lame from (lambda, mu) directly or plane-strain (E, nu):
    mu = E/(2(1+nu)), lam = E nu/((1+nu)(1-2 nu))
  - MMS: f_a = -sum_b d sigma_ab / dx_b of the manufactured displacement,
    derived symbolically; BCs interpolate u_exact on all boundary facets
  - non-MMS cases: baseline_error against a finer reference_config
    re-solve

Port of pdebench_tpu/oracle/linear_elasticity.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import LocalOperator, local_elasticity
from ..solvers.amg import rigid_body_modes
from ..solvers.dispatch import solve_linear
from . import base, scalar
from .types import OracleResult, compute_rel_L2_grid


def lame_from_params(params: Dict[str, Any]) -> Tuple[float, float]:
    if "lambda" in params and "mu" in params:
        return float(params["lambda"]), float(params["mu"])
    E = float(params.get("E", 1.0))
    nu = float(params.get("nu", 0.3))
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu


def elasticity_source(
    u_exprs: List, lam: float, mu: float, dim: int
) -> List[sp.Expr]:
    """f = -div(sigma(u_exact)), componentwise sympy."""
    sv = [symbolic.X, symbolic.Y, symbolic.Z][:dim]
    u = [symbolic.parse(e) for e in u_exprs]
    divu = sum(sp.diff(u[a], sv[a]) for a in range(dim))
    f = []
    for a in range(dim):
        expr = 0
        for b in range(dim):
            sig_ab = mu * (sp.diff(u[a], sv[b]) + sp.diff(u[b], sv[a]))
            if a == b:
                sig_ab = sig_ab + lam * divu
            expr = expr + sp.diff(sig_ab, sv[b])
        f.append(sp.simplify(-expr))
    return f


class LinearElasticitySolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, list(mms_u))
            pde = config["pde"]
        lam, mu = lame_from_params(pde.get("pde_params", {}))

        ctx = scalar.setup_scalar(config, self.device, ncomp=-1)
        dim = ctx.dim

        if mms_u is not None:
            src = elasticity_source(mms_u, lam, mu, dim)
        else:
            src = pde.get("source_term", [0.0] * dim)
            if not isinstance(src, (list, tuple)):
                src = [src] * dim
        f_fns = [symbolic.lambdify_numpy(s, dim) for s in src]
        opts = base.solver_opts(config)
        space, cb = ctx.space, ctx.cb

        # one-time solver options, shared by the cold and warm runs (the
        # lattice carries the hierarchy and the fused kernel built for it):
        # structured meshes take the block stencil + block GMG
        run_opts = dict(opts)
        run_opts["_lattice32"] = scalar.maybe_block_lattice32(
            ctx, local_elasticity(cb, mu, lam)
        )
        # the AMG of the route off the lattice (and of a lattice IR that
        # did not converge) needs the rigid-body near-nullspace and
        # node-block aggregation to handle nu -> 1/2; set at every size, so
        # that no elasticity solve takes the Jacobi branch
        run_opts["_amg_B"] = rigid_body_modes(space.dof_coords, space.ncomp)
        run_opts["_amg_block"] = space.ncomp

        def build():
            K = local_elasticity(cb, mu, lam)
            op = LocalOperator(
                torch.as_tensor(K, device=self.device), space.dofmap, space.ndof
            )
            # host f_q keeps local_vector_load a numpy einsum
            f_q = np.stack([f(ctx.qpts()) for f in f_fns], axis=-1)
            return op, ctx.load_vector(f_q)

        op, b = base.charge_setup(ctx, build)

        def run():
            x, info = solve_linear(op, b, ctx.mask, ctx.g, run_opts, symmetric=True)
            grid = ctx.sample(x)
            return grid, info

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
            "pde": "linear_elasticity",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": space.degree,
            "lame_lambda": lam,
            "lame_mu": mu,
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
