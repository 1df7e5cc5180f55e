"""Darcy oracle: -div(kappa grad p) = f, elliptic or mixed.

Formulations (pde.formulation):

  - "elliptic" / "pressure" (the default): Poisson's pipeline on the
    pressure, with the positive-permeability check. The manufactured
    solution is read from `p` (or `u`); on a lattice `solve_linear`
    takes the mixed-precision refinement with the fused GMG-PCG inner
    (kernel #2 on CUDA tensors from dispatch.GMG_MIN_DOFS dofs on).
  - "mixed" / "rt" / "hdiv": kappa^-1 u + grad p = 0, div u = f on
    RT_k x DG_k (fem.degree_u = k + 1; k = 0 is RT0 x DG0), flux BCs from
    the manufactured velocity u = -kappa grad p on the boundary edges, the
    pressure fixed in cell 0, solved by the host sparse LU (the
    reference's preonly / lu route on every platform). An explicit
    fem.degree_p other than degree_u - 1 raises NotImplementedError.

solver_info["formulation"] is "elliptic", "mixed_rt0_dg0" or
"mixed_rt<k>_dg<k>".

Port of pdebench_tpu/oracle/darcy.py.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import scipy.sparse as sps
import sympy as sp
import torch

from ..fem import sampling, symbolic
from ..fem.assemble import LocalOperator, local_stiffness
from ..fem.hdiv import rt0_local_matrices, rt0_space, rtk_assemble, rtk_boundary_flux
from ..solvers import direct as directmod
from ..solvers.dispatch import solve_linear
from . import base, scalar
from .types import OracleResult, compute_rel_L2_grid


def _mms_flux(pde: Dict[str, Any]):
    """(p expression or None, kappa spec, source expression, the exact
    velocity's component functions or None) of a mixed case."""
    mms = pde.get("manufactured_solution", {})
    p_expr = mms.get("p", mms.get("u"))
    kspec = pde.get("coefficients", {}).get("kappa") or {}
    if p_expr is None:
        return None, kspec, pde.get("source_term", 0.0), None
    kexpr = kspec.get("expr", kspec.get("value", 1.0)) if kspec else 1.0
    p_sym, k_sym = symbolic.parse(p_expr), symbolic.parse(kexpr)
    u_sym = [-k_sym * sp.diff(p_sym, v) for v in (symbolic.X, symbolic.Y)]
    return (
        p_expr, kspec, symbolic.poisson_source(p_expr, kexpr, 2),
        [symbolic.lambdify_numpy(e, 2) for e in u_sym],
    )


def _coo(rows, cols, vals, n: int) -> sps.csr_matrix:
    return sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    ).tocsr()


class DarcySolver:
    def __init__(self, device):
        self.device = torch.device(device)

    def solve(
        self, config: Dict[str, Any], _compute_baseline: bool = True
    ) -> OracleResult:
        pde = config["pde"]
        formulation = str(pde.get("formulation", "elliptic")).lower()
        if formulation in ("mixed", "rt", "hdiv"):
            return self._solve_mixed(config, _compute_baseline)
        if formulation not in ("elliptic", "pressure"):
            raise NotImplementedError(f"unknown darcy formulation '{formulation}'")
        mms_u = pde.get("manufactured_solution", {}).get(
            "p", pde.get("manufactured_solution", {}).get("u")
        )
        if mms_u is not None:
            config = scalar.override_bc_with_mms(config, mms_u)
            pde = config["pde"]
            # the baseline error reads manufactured_solution.u
            pde.setdefault("manufactured_solution", {})["u"] = mms_u
        ctx = scalar.setup_scalar(config, self.device)
        dim = ctx.dim
        kspec = pde.get("coefficients", {}).get("kappa") or {}
        kappa = base.coefficient_fn(kspec or None, dim, self.device)

        # positive-permeability check (the reference's darcy.py:63-70)
        if not bool((kappa(ctx.qpts()) > 0).all()):
            raise ValueError("darcy permeability must be strictly positive")

        if mms_u is not None:
            kexpr = kspec.get("expr", kspec.get("value", 1.0)) if kspec else 1.0
            src = symbolic.poisson_source(mms_u, kexpr, dim)
        else:
            src = pde.get("source_term", 0.0)
        f_fn = symbolic.lambdify_spatial(src, dim, self.device)
        opts = base.solver_opts(config)
        opts["_lattice32"] = scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb, kappa(ctx.qpts())))

        def build():
            K = local_stiffness(ctx.cb, kappa(ctx.qpts()))
            op = LocalOperator(K, ctx.space.dofmap_scalar, ctx.space.ndof)
            return op, ctx.load_vector(f_fn(ctx.qpts()))

        op, b = base.charge_setup(ctx, build)

        def run():
            x, info = solve_linear(op, b, ctx.mask, ctx.g, opts)
            return ctx.sample(x), info

        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid)
            if err is None and "reference_config" in config:
                ref = self.solve(scalar.merge_reference_config(config), _compute_baseline=False)
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(self.device),
            "pde": "darcy",
            "formulation": "elliptic",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": ctx.space.degree,
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

    def _solve_mixed(self, config: Dict[str, Any], _compute_baseline: bool) -> OracleResult:
        """The mixed forms: RT0 x DG0 here (closed-form edge basis),
        RT_k x DG_k for degree_u = k + 1 >= 2 in _solve_mixed_rtk."""
        fem_cfg = config.get("fem", {})
        degree_u = int(fem_cfg.get("degree_u", 1))
        degree_p = fem_cfg.get("degree_p")
        if degree_p is not None and int(degree_p) != degree_u - 1:
            raise NotImplementedError(
                f"mixed darcy supports the stable RT_k x DG_(k-1) pairings only; "
                f"got degree_u={degree_u}, degree_p={degree_p}"
            )
        if degree_u >= 2:
            return self._solve_mixed_rtk(config, degree_u - 1, _compute_baseline)
        if degree_u != 1:
            raise NotImplementedError(f"mixed darcy needs degree_u >= 1; got {degree_u}")

        t_start = time.perf_counter()
        p_expr, kspec, f_sym, u_fns = _mms_flux(config["pde"])
        kappa = base.coefficient_fn(kspec or None, 2, "cpu")
        mesh = base.build_mesh(config["domain"], config.get("mesh", {}))
        space = rt0_space(mesh)
        centroids = mesh.coords[mesh.cells.astype(np.int64)].mean(axis=1)
        kap_c = kappa(centroids).numpy()
        if not np.all(kap_c > 0):
            raise ValueError("darcy permeability must be strictly positive")

        Mloc, Bloc, area = rt0_local_matrices(space, 1.0 / kap_c)
        ne, nc = space.n_edges, mesh.n_cells
        N = ne + nc
        ce = space.cell_edges
        pcell = ne + np.repeat(np.arange(nc), 3)
        # the flux mass block, -B^T p (flux rows) and B u (pressure rows)
        A = _coo(
            [np.repeat(ce, 3, axis=1).reshape(-1), ce.reshape(-1), pcell],
            [np.tile(ce, (1, 3)).reshape(-1), pcell, ce.reshape(-1)],
            [Mloc.reshape(-1), -Bloc.reshape(-1), Bloc.reshape(-1)],
            N,
        )
        rhs = np.zeros(N)
        rhs[ne:] = symbolic.lambdify_numpy(f_sym, 2)(centroids) * area  # int_T f

        # essential flux BCs: the RT0 coefficient is u . n at the edge
        mask = np.zeros(N, dtype=bool)
        g = np.zeros(N)
        if u_fns is not None:
            be = space.boundary_edges
            mask[be] = True
            un = np.stack([f(space.edge_midpoints[be]) for f in u_fns], 1)
            g[be] = (un * space.edge_normals[be]).sum(1)
        # the pressure fixed in cell 0
        mask[ne] = True
        if p_expr is not None:
            g[ne] = float(symbolic.lambdify_numpy(p_expr, 2)(centroids[:1])[0])
        t_setup = time.perf_counter() - t_start

        def run():
            x = directmod.solve_direct_constrained(A, rhs, mask, g)
            resid = np.linalg.norm((A @ x - rhs)[~mask])
            pts, shape = sampling.grid_points(config["output"]["grid"])
            loc = sampling.locate_points(mesh, pts)
            vals = np.where(loc.found, x[ne:][np.maximum(loc.cells, 0)], np.nan)
            return vals.reshape(shape), {"residual": float(resid)}

        return self._mixed_result(config, run, p_expr, t_setup, "mixed_rt0_dg0", N,
                                  _compute_baseline)

    def _solve_mixed_rtk(self, config: Dict[str, Any], k: int, _compute_baseline: bool) -> OracleResult:
        """RT_k x DG_k (k >= 1): per-cell bases tabulated from the dof
        functionals (fem.hdiv.rtk_assemble), the same weak form, flux BCs
        (k + 1 edge moments) and pressure fixing as RT0; the pressure
        sampled from its DG_k monomials."""
        t_start = time.perf_counter()
        p_expr, kspec, f_sym, u_fns = _mms_flux(config["pde"])
        kappa = base.coefficient_fn(kspec or None, 2, "cpu")
        mesh = base.build_mesh(config["domain"], config.get("mesh", {}))
        space = rt0_space(mesh)

        def kinv(pts):
            kq = kappa(pts).numpy()
            if not np.all(kq > 0):
                raise ValueError("darcy permeability must be strictly positive")
            return 1.0 / kq

        M_loc, B_loc, fdofs, aux = rtk_assemble(space, kinv, k=k)
        ne, nc = space.n_edges, mesh.n_cells
        nd, npl = aux["nd"], aux["psi_dim"]
        nf = aux["nem"] * ne + aux["nint"] * nc  # flux dofs
        N = nf + npl * nc
        pdofs = nf + npl * np.arange(nc)[:, None] + np.arange(npl)[None, :]
        rows_b = np.repeat(pdofs, nd, axis=1).reshape(-1)
        cols_b = np.tile(fdofs, (1, npl)).reshape(-1)
        A = _coo(
            [np.repeat(fdofs, nd, axis=1).reshape(-1), cols_b, rows_b],
            [np.tile(fdofs, (1, nd)).reshape(-1), rows_b, cols_b],
            [M_loc.reshape(-1), -B_loc.reshape(-1), B_loc.reshape(-1)],
            N,
        )

        # rhs: (f, psi) over the DG_k test functions
        xq, wq, xc, h = aux["xq"], aux["wq"], aux["xc"], aux["h"]
        psi_exp = aux["psi_exp"]
        Xl_q = (xq - xc[:, None, :]) / h[:, None, None]
        psi = np.stack([Xl_q[..., 0] ** a * Xl_q[..., 1] ** b for (a, b) in psi_exp], axis=-1)
        fq = symbolic.lambdify_numpy(f_sym, 2)(xq.reshape(-1, 2)).reshape(xq.shape[:2])
        rhs = np.zeros(N)
        rhs[nf:] = np.einsum("cq,cql->cl", fq * wq, psi).reshape(-1)

        mask = np.zeros(N, dtype=bool)
        g = np.zeros(N)
        if u_fns is not None:
            bd, bv = rtk_boundary_flux(space, u_fns, k=k)
            mask[bd] = True
            g[bd] = bv
        # the constant DG_k coefficient of cell 0 is p_h at its centroid
        # (every other local monomial vanishes at Xl = 0)
        mask[nf] = True
        if p_expr is not None:
            g[nf] = float(symbolic.lambdify_numpy(p_expr, 2)(xc[:1])[0])
        t_setup = time.perf_counter() - t_start

        def run():
            x = directmod.solve_direct_constrained(A, rhs, mask, g)
            resid = np.linalg.norm((A @ x - rhs)[~mask])
            pc = x[nf:].reshape(nc, npl)
            pts, shape = sampling.grid_points(config["output"]["grid"])
            loc = sampling.locate_points(mesh, pts)
            cells_s = np.maximum(loc.cells, 0)
            Xl = (pts - xc[cells_s]) / h[cells_s][:, None]
            basis = np.stack([Xl[:, 0] ** a * Xl[:, 1] ** b for (a, b) in psi_exp], axis=-1)
            vals = np.where(loc.found, (pc[cells_s] * basis).sum(axis=-1), np.nan)
            return vals.reshape(shape), {"residual": float(resid)}

        return self._mixed_result(config, run, p_expr, t_setup, f"mixed_rt{k}_dg{k}", N,
                                  _compute_baseline)

    def _mixed_result(self, config, run, p_expr, t_setup, formulation, N, _compute_baseline):
        """Time a mixed form's host solve (cold, then warm) and report it."""
        (fem_grid, info), t_warm, t_cold = base.timed_run(run, self.device)
        baseline_error = 0.0
        if _compute_baseline and p_expr is not None:
            exact = base.exact_grid_scalar(p_expr, config["output"]["grid"], mask_from=fem_grid)
            baseline_error = compute_rel_L2_grid(fem_grid, exact)
        return OracleResult(
            baseline_error=float(baseline_error),
            baseline_time=float(t_setup + t_warm),
            reference=fem_grid,
            solver_info={
                "library": "pdebench_tpu_torch",
                "device": str(self.device),
                "pde": "darcy",
                "formulation": formulation,
                "ksp_type": "preonly",
                "pc_type": "lu",
                "rtol": 1e-10,
                "iterations": 1,
                "inner": "host-lu",
                "t_setup": t_setup,
                "t_warm": t_warm,
                "t_cold": t_cold,
                **info,
            },
            num_dofs=N,
        )
