"""Helmholtz oracle: -Lap(u) - k^2 u = f (indefinite), Dirichlet BCs.

Pipeline: structured mesh -> A = K - k^2 M as cell-local batches ->
lattice stencil operator -> mixed-precision refinement with a GMRES(30)
inner (f64 outer stencil residual), preconditioned by a stencil GMG built
on the SHIFTED Laplacian K + k^2 M (multigrid on the indefinite operator
itself diverges) -> grid sampling. MMS derives f = -Lap(u_exact) -
k^2 u_exact.

At k >= 16 on 2-D meshes the oracle takes the host LU from the start
(`high_k_direct`): the shifted-Laplacian preconditioner's iteration
counts grow with k, and the reference measured the direct solve faster
there. A 2-D solve whose own request is a direct one (preonly, or an LU
pc: the reference re-solves of the no-exact cases) takes it from k = 15
on: there the lattice IR stalls (helmholtz_no_exact_gaussian_source_k15),
and the reference answers the same request with its host LU. Both are
route choices made before any lattice or kernel is built
(`host_lu_route`), and `solver_info["inner"]` records them as
"host-lu".

Port of pdebench_tpu/oracle/helmholtz.py.
"""

from __future__ import annotations

from typing import Any, Dict

import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import LocalOperator, local_mass, local_stiffness
from ..solvers.dispatch import direct_request, solve_linear
from . import base, scalar
from .types import OracleResult, compute_rel_L2_grid

# 2-D cases from this wavenumber on solve with the host LU
HIGH_K_DIRECT = 16.0
# ... and 2-D cases whose own request is direct from this one on: the
# lattice IR converges on such requests at k = 8 and 12 (the re-solves of
# helmholtz_no_exact_sign_changing_rhs_k8 and _nonzero_bc_k12) and stalls
# at k = 15 (_gaussian_source_k15)
DIRECT_REQUEST_MIN_K = 15.0
# the shifted-Laplacian hierarchy is built from this many dofs on
SHIFTED_GMG_MIN_DOFS = 8000


def shifted_laplacian(ctx, k2: float):
    """The shifted Laplacian K + k^2 M of the case as a host CSR matrix:
    the surrogate that the multigrid hierarchy is coarsened from."""
    A = local_stiffness(ctx.cb) + k2 * local_mass(ctx.cb)
    return LocalOperator(torch.as_tensor(A), ctx.space.dofmap_scalar, ctx.space.ndof).to_scipy()


def host_lu_route(dim: int, k: float, opts: Dict[str, Any]) -> bool:
    """Whether a solve takes the host LU before any lattice is built: on
    2-D meshes at k >= HIGH_K_DIRECT, or at k >= DIRECT_REQUEST_MIN_K
    when the case's own solver options ask for a direct solve."""
    if dim != 2:
        return False
    return k >= HIGH_K_DIRECT or (k >= DIRECT_REQUEST_MIN_K and direct_request(opts))


class HelmholtzSolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        mms_u = pde.get("manufactured_solution", {}).get("u")
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, mms_u)
        k = float(pde.get("pde_params", {}).get("k", 1.0))
        k2 = k * k
        ctx = scalar.setup_scalar(config, self.device)
        dim = ctx.dim

        if mms_u is not None:
            u_sym = symbolic.parse(mms_u)
            src = sp.simplify(-symbolic.laplacian(u_sym, dim) - k2 * u_sym)
        else:
            src = pde.get("source_term", 0.0)
        f_fn = symbolic.lambdify_spatial(src, dim, self.device)
        opts = base.solver_opts(config)

        high_k_direct = host_lu_route(dim, k, opts)
        if high_k_direct:
            opts = dict(opts, ksp_type="preonly", pc_type="lu")

        # one-time solver options, shared by the cold and warm runs (the
        # lattice carries the hierarchy and the fused kernels built for it)
        run_opts = dict(opts)
        if not high_k_direct:
            run_opts["_lattice32"] = scalar.maybe_lattice32(
                ctx, local_stiffness(ctx.cb) - k2 * local_mass(ctx.cb)
            )
        if not high_k_direct and ctx.space.ndof >= SHIFTED_GMG_MIN_DOFS:
            # precondition the indefinite operator with multigrid built on
            # the SHIFTED Laplacian K + k^2 M
            run_opts["_amg_matrix"] = shifted_laplacian(ctx, k2)

        def build():
            A = local_stiffness(ctx.cb) - k2 * local_mass(ctx.cb)
            op = LocalOperator(
                torch.as_tensor(A, device=self.device),
                ctx.space.dofmap_scalar,
                ctx.space.ndof,
            )
            b = ctx.load_vector(f_fn(ctx.qpts()))
            return op, b

        op, b = base.charge_setup(ctx, build)

        def run():
            x, info = solve_linear(op, b, ctx.mask, ctx.g, run_opts, symmetric=False)
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
            "pde": "helmholtz",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": ctx.space.degree,
            "wavenumber": k,
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
