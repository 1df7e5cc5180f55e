"""Navier-Stokes oracle: steady incompressible NS, Taylor-Hood, Newton
with backtracking line search and nu-continuation.

  F((u,p);(v,q)) = ((grad u) u, v) + nu (grad u, grad v) - (p, div v)
                   - (q, div u) - (f, v)

  - init modes: 'stokes' (Stokes warm start), 'zero', 'exact'
    (interpolate u_exact), 'continuation' (full-strength Newton first;
    then a geometric nu ladder nu_start * (nu/nu_start)^(k/n), k = 1..n,
    Stokes init at nu_start, Newton at each rung to rtol 1e-3)
  - final Newton at the case's rtol / atol / max_it with 'bt' line search
  - MMS: f = (grad u)u - nu Lap(u) + grad(p) derived symbolically; the
    manufactured velocity must be divergence-free

Routes, chosen from the mesh and the hierarchy spec before any kernel
runs, and recorded in solver_info["inner"]:

  newton-fgmres+fused-dyn-vcycle-cuda / -torch
      2-D Taylor-Hood lattices whose convected-Jacobian hierarchy halves
      at every level: the whole Newton loop on the device. Each step maps
      the Jacobian to block stencil weights, rebuilds the block GMG
      hierarchy from them (gmg_dyn) and solves the saddle system by
      FGMRES-IR (f32 GMRES(40) inner, f64 outer) preconditioned by a
      block lower-triangular M: the velocity solve is kernel #5
      (gmg_fused.build_fused_dyn_block_vcycle; its plain version on CPU
      tensors), then the Schur update zp = -inv_p (r_p - G^T zu) with the
      lumped pressure-mass diagonal. Eisenstat-Walker forcing clipped to
      [1e-4, 0.1]; from a zero start the tolerance is re-anchored after
      the first step (the reference's Stokes-init SNES semantics).
  newton-fgmres+dyn-vcycle
      the same on hierarchies with an identity-padded level, the V-cycle
      in PyTorch ops (no kernel takes a padded level)
  newton-host-lu
      no saddle stencil (3-D or unstructured meshes, P3-P2 and P4-P3
      lattices), or velocity lattices of HOST_LU_MIN_SIDE nodes a side and
      more at nu below HOST_LU_MAX_NU (host_lu_route, decided before any
      lattice is built): residual and Jacobian on the device, each
      Newton step one host SuperLU factorisation, then frozen-Jacobian
      steps while they cut the residual by 25%

The port takes the device Newton on every device, the CPU included,
where the reference's default is the host LU (its device Newton is
opt-in: PDEBENCH_TPU_NS_DEVICE_NEWTON=1 with PDEBENCH_TPU_NS_CONV_M=hier,
which the CPU parity tests set). A device linear solve that does not
converge raises on CUDA tensors (with the Newton step and residual); on
CPU tensors the solve falls through to the host-LU Newton from the same
start, as the reference does: each of its steps first retries the linear
solve on the device at rtol RETRY_ETA = 1e-8 and factors on the host only
where that does not converge (`solver_info["device_retries"]` counts the
retries that converged).

Not ported (opt-in switches of the reference): the MINRES Stokes init
(PDEBENCH_TPU_NS_DEVICE_INIT), the host-first-step mode
(PDEBENCH_TPU_NS_DEVICE_STEP2), the Stokes-hierarchy M modes
(PDEBENCH_TPU_NS_CONV_M=0/1), the block-diagonal M
(PDEBENCH_TPU_NS_TRI_M=0), the pressure-mass Schur
(PDEBENCH_TPU_NS_SCHUR=mass) and the lattice-layout Krylov vectors
(PDEBENCH_TPU_SADDLE_LAT). Their tuning variables are the module
constants below, at the reference's defaults.

Port of pdebench_tpu/oracle/navier_stokes.py.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import sympy as sp
import torch

from ..fem import symbolic
from ..fem.assemble import (
    GatherSum,
    constrained_operator,
    constrained_rhs,
    local_divergence,
    local_vector_laplacian,
    local_vector_load,
)
from ..solvers import direct as directmod
from ..solvers import gmg_fused
from ..solvers.gmg_dyn import build_dyn_block_spec, constrain_block_weights_traced
from ..solvers.krylov import refined_solve
from ..solvers.saddle_stencil import build_saddle_stencil
from ..solvers.stencil import constrain_stencil_weights
from . import base, mixed, scalar
from .types import OracleResult, compute_rel_L2_grid

# restart length of the saddle FGMRES inner (PDEBENCH_TPU_NS_INNER_ITERS)
NS_INNER_ITERS = 40
# refinement rounds per Newton linear solve
NS_MAX_OUTER = 20
# V-cycles per velocity solve of the preconditioner
# (PDEBENCH_TPU_NS_HIER_VCYCLES)
NS_HIER_VCYCLES = 1
# tolerance of the device Stokes init (warm-start accuracy only: the
# Stokes / NS model gap is far above it)
NS_INIT_RTOL = 1e-3
# Eisenstat-Walker forcing bounds
ETA_MIN, ETA_MAX = 1e-4, 0.1
# the host-LU Newton after a device Newton's linear failure first retries
# each step's linear solve on the device to this relative tolerance (the
# reference's fallback loop)
RETRY_ETA = 1e-8

ROUTE_HOST_LU = "newton-host-lu"
ROUTE_DYN_VCYCLE = "newton-fgmres+dyn-vcycle"
ROUTE_FUSED = "newton-fgmres+fused-dyn-vcycle"
# velocity lattices of HOST_LU_MIN_SIDE nodes a side and more (mesh
# resolution 72 and up at P2) at viscosities below HOST_LU_MAX_NU take the
# host-LU Newton. On the H100 the device FGMRES stalls or breaks down on
# 10 dataset cases, all of them there (nu 0.01-0.18), and converges on
# every other case and reference re-solve, among them those on such
# lattices at nu 0.2-0.3 (PERF.md §6, the dataset sweeps). Side 145 is the
# smallest that failed; no case lies between nu 0.18 and 0.22.
HOST_LU_MIN_SIDE = 145
HOST_LU_MAX_NU = 0.2


def host_lu_route(V, nu: float) -> bool:
    """Whether a solve takes the host-LU Newton, decided from the velocity
    space V and the viscosity before any lattice is built: V's nodes, as
    a square lattice, are HOST_LU_MIN_SIDE or more a side, and nu lies
    below HOST_LU_MAX_NU."""
    n_nodes, dim = V.dof_coords.shape
    return round(n_nodes ** (1 / dim)) >= HOST_LU_MIN_SIDE and nu < HOST_LU_MAX_NU


def ns_source(u_exprs: List, p_expr, nu: float, dim: int) -> List[sp.Expr]:
    """f = (grad u)u - nu Lap(u) + grad(p), componentwise sympy."""
    sv = [symbolic.X, symbolic.Y, symbolic.Z][:dim]
    u = [symbolic.parse(e) for e in u_exprs]
    p = symbolic.parse(p_expr if p_expr is not None else 0)
    out = []
    for a in range(dim):
        conv = sum(u[b] * sp.diff(u[a], sv[b]) for b in range(dim))
        out.append(sp.simplify(conv - nu * symbolic.laplacian(u[a], dim) + sp.diff(p, sv[a])))
    return out


class NavierStokesProblem:
    """One case's discrete problem on a device: the Taylor-Hood context,
    the forms (residual and Jacobian on the device, the cell batches on
    the host), and the route with its pieces (the saddle stencil, the
    hierarchy spec and the fused kernel), all decided here, before any
    kernel runs."""

    def __init__(self, config: Dict[str, Any], device):
        # the concrete device ("cuda:0" for "cuda"), as tensors report it
        dev = self.device = torch.empty(0, device=device).device
        pde = config["pde"]
        mms = pde.get("manufactured_solution", {})
        self.mms_u = mms.get("u")
        if self.mms_u is not None:
            config = scalar.override_bc_with_mms(config, list(self.mms_u))
            pde = config["pde"]
        self.config = config
        self.nu = nu = float(pde.get("pde_params", {}).get("nu", 1.0))

        ctx = self.ctx = mixed.setup_taylor_hood(config, dev)
        dim = self.dim = ctx.dim
        V, Q, cb = ctx.V, ctx.Q, ctx.cb
        self.nu_dofs, self.np_dofs = V.ndof, Q.ndof
        self.nlu_s = V.dofmap_scalar.shape[1]  # scalar nodes per cell

        if self.mms_u is not None:
            src = ns_source(self.mms_u, mms.get("p"), nu, dim)
            sv = [symbolic.X, symbolic.Y, symbolic.Z][:dim]
            div_u = sp.simplify(sum(sp.diff(symbolic.parse(e), v) for e, v in zip(self.mms_u, sv)))
            if div_u != 0:
                raise ValueError(f"manufactured velocity not divergence-free: {div_u}")
        else:
            src = pde.get("source_term", [0.0] * dim)
            if not isinstance(src, (list, tuple)):
                src = [src] * dim
        f_fns = [symbolic.lambdify_numpy(s, dim) for s in src]

        self.mask_np = ctx.mask.cpu().numpy()
        self.g_np = ctx.g.cpu().numpy()
        self.mask, self.g = ctx.mask, ctx.g

        self.A1_loc = local_vector_laplacian(cb, 1.0)  # scaled by nu per rung
        self.G_loc = local_divergence(cb, ctx.psi)
        t64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

        def assemble():
            f_q = np.stack([f(ctx.qpts()) for f in f_fns], axis=-1)
            sum_u = GatherSum(V.dofmap, self.nu_dofs, dev)
            sum_p = GatherSum(Q.dofmap_scalar, self.np_dofs, dev)
            b_u = sum_u(t64(local_vector_load(cb, f_q)))
            return sum_u, sum_p, torch.cat([b_u, b_u.new_zeros(self.np_dofs)])

        self.sum_u, self.sum_p, self.b = base.charge_setup(ctx, assemble)
        self.A1 = t64(self.A1_loc)
        self.G = t64(self.G_loc)
        self.dofmap_u = torch.as_tensor(V.dofmap, dtype=torch.int64, device=dev)
        self.dofmap_p = torch.as_tensor(Q.dofmap_scalar, dtype=torch.int64, device=dev)
        phi = self.phi = t64(cb.phi)
        self.gphys = t64(cb.grad_phys())  # (c, q, i, d)
        w_q = t64(cb.wdetJ)
        # phi_i phi_j w and phi_i w at each quadrature point
        self.pw = torch.einsum("qi,qj,cq->cqij", phi, phi, w_q)
        self.phw = torch.einsum("qi,cq->cqi", phi, w_q)
        self.eye_d = torch.eye(dim, dtype=torch.float64, device=dev)

        # -- the route ------------------------------------------------------
        self.sst = self.spec = self.fused = None
        if dim == 2 and not host_lu_route(V, nu):
            self.sst = build_saddle_stencil(V, Q, self.G_loc)
        sst = self.sst
        if sst is not None:
            # node mask on the velocity lattice; omegas probed on the
            # constrained STOKES block weights (same adjacency)
            node_mask = self.mask_np[: self.nu_dofs].reshape(-1, dim).any(axis=1)
            mask_lat = sst.lat_u.embed_np(node_mask, True).reshape(sst.fine)
            W_probe = constrain_stencil_weights(
                nu * sst.wmapA.weights_np(self.A1_loc), sst.wmapA.offsets, mask_lat, d=dim
            )
            self.spec = build_dyn_block_spec(sst.wmapA.offsets, sst.fine, dim, probe_W=W_probe)
        if self.spec is None:
            self.route = ROUTE_HOST_LU
        else:
            self.fused = gmg_fused.build_fused_dyn_block_vcycle(self.spec, NS_HIER_VCYCLES, dev)
            kind = "cuda" if dev.type == "cuda" else "torch"
            self.route = f"{ROUTE_FUSED}-{kind}" if self.fused is not None else ROUTE_DYN_VCYCLE
            self.keep_node32 = torch.as_tensor(1.0 - mask_lat.astype(np.float32), device=dev)
            self.inv_p32 = torch.as_tensor(
                mixed.schur_diag(cb, ctx.psi, Q.dofmap_scalar, self.np_dofs, nu, self.mask_np, self.nu_dofs),
                dtype=torch.float32, device=dev,
            )
        self.stats = {}

    # -- forms ------------------------------------------------------------

    def cell_saddle(self, x, A_loc):
        """[[A, G], [G^T, 0]] x from the cell batches, summed in a fixed
        order."""
        return mixed.saddle_apply(A_loc, self.G, self.dofmap_u, self.dofmap_p, self.sum_u, self.sum_p)(x)

    def velocity_fields(self, x):
        """(u_q, gradu_q) at quadrature points from the mixed vector."""
        ue = x[: self.nu_dofs][self.dofmap_u].reshape(-1, self.nlu_s, self.dim)  # (c, nl, a)
        u_qp = torch.einsum("qi,cia->cqa", self.phi, ue)
        gradu_qp = torch.einsum("cqid,cia->cqad", self.gphys, ue)
        return u_qp, gradu_qp

    def residual(self, x, nu_v):
        u_qp, gradu_qp = self.velocity_fields(x)
        conv_q = torch.einsum("cqab,cqb->cqa", gradu_qp, u_qp)
        r_conv = torch.einsum("cqi,cqa->cia", self.phw, conv_q).reshape(-1, self.nlu_s * self.dim)
        r = self.cell_saddle(x, nu_v * self.A1)
        n = self.nu_dofs
        r = torch.cat([r[:n] + self.sum_u(r_conv), r[n:]]) - self.b
        return torch.where(self.mask, 0.0, r)

    def jacobian(self, x, nu_v):
        """The velocity block of the Jacobian, (c, nl*d, nl*d) f64."""
        u_qp, gradu_qp = self.velocity_fields(x)
        # N1[(ia)(jb)] = int phi_i phi_j du_a/dx_b
        N1 = torch.einsum("cqij,cqab->ciajb", self.pw, gradu_qp)
        # N2[(ia)(jb)] = delta_ab int phi_i (u . grad phi_j)
        ug = torch.einsum("cqjd,cqd->cqj", self.gphys, u_qp)
        N2s = torch.einsum("cqi,cqj->cij", self.phw, ug)
        N = N1 + torch.einsum("cij,ab->ciajb", N2s, self.eye_d)
        c, m = N.shape[0], self.nlu_s * self.dim
        return nu_v * self.A1 + N.reshape(c, m, m)

    # -- device linear solves ---------------------------------------------

    def levels(self, WA32):
        """The step's hierarchy from the f32 block weights of its Jacobian:
        Dirichlet-constrained, then Galerkin-coarsened (gmg_dyn)."""
        eye32 = torch.eye(self.dim, dtype=torch.float32, device=WA32.device)
        WA32c = constrain_block_weights_traced(WA32, self.sst.wmapA.offsets, self.keep_node32, eye32)
        return self.spec.build_levels(WA32c)

    def make_M(self, WA32):
        """Block lower-triangular saddle M whose velocity solve is a V-cycle
        chain on the hierarchy of the step's convected Jacobian."""
        sst, n = self.sst, self.nu_dofs
        lv = self.levels(WA32)
        WGT32 = sst.on(WA32.device)["WGT32"]

        def M32(r32):
            ru, rp = r32[:n], r32[n:]
            r_lat = sst.embed_u(ru) * self.keep_node32[..., None]
            if self.fused is not None:
                x = self.fused(r_lat.reshape(-1), lv).reshape(r_lat.shape)
            else:
                x = self.spec.chain(lv, r_lat.permute(2, 0, 1), NS_HIER_VCYCLES).permute(1, 2, 0)
            zu = sst.extract_u(x)
            zp = -self.inv_p32 * (rp - sst.extract_p(sst.applyGT(WGT32, x)))
            return torch.where(self.mask, r32, torch.cat([zu, zp]))

        return M32

    def lin_solve(self, Ju, rhs, eta):
        """Saddle solve (FGMRES-IR, f32 inner) to relative tolerance eta:
        (x, KrylovInfo)."""
        sst = self.sst
        WA64 = sst.wmapA.weights(Ju)
        WA32 = WA64.to(torch.float32)
        A64 = constrained_operator(sst.saddle_apply_w(WA64), self.mask)
        A32 = constrained_operator(sst.saddle_apply_w(WA32), self.mask)
        x, info = refined_solve(
            A64, A32, rhs, M32=self.make_M(WA32), rtol=eta, atol=1e-12,
            inner_iters=NS_INNER_ITERS, max_outer=NS_MAX_OUTER, inner="gmres",
        )
        self.stats["kry_its"] += info.iterations
        self.stats["lin"] += 1
        return x, info

    def _lin_failed(self, where, rn, info) -> None:
        msg = (
            f"navier_stokes {self.route}: device linear solve did not converge "
            f"({where}, nonlinear residual {rn:.3e}; linear residual "
            f"{info.residual:.3e} after {info.iterations} Krylov iterations)"
        )
        if self.device.type != "cpu":
            raise RuntimeError(msg)
        self.stats["iterative_failed"] = msg

    # -- Newton -----------------------------------------------------------

    def newton_device(self, x0, nu_v, rtol, atol, max_it, update_tol):
        """The whole Newton loop on the device (one host sync per step).
        Returns (x, rn, steps, converged), or None when a linear solve
        failed on CPU tensors."""
        x = torch.where(self.mask, self.g, x0)
        r = self.residual(x, nu_v)
        rn0 = rn = rn_prev = float(torch.linalg.norm(r))
        eta_prev = ETA_MAX
        tol = max(rtol * rn0, atol)
        it = 0
        while it < max_it and tol < rn <= 1e4 * rn0 and np.isfinite(rn):
            # Eisenstat-Walker (choice 2) with the standard safeguard, never
            # deeper than the outer tolerance needs
            eta = 0.9 * (rn / rn_prev) ** 2
            eta_safe = 0.9 * eta_prev * eta_prev
            if eta_safe > 0.1:
                eta = max(eta, eta_safe)
            eta = min(max(eta, ETA_MIN), ETA_MAX)
            eta = max(eta, min(ETA_MAX, 0.5 * tol / rn))
            delta, info = self.lin_solve(self.jacobian(x, nu_v), -r, eta)
            if not info.converged:
                self._lin_failed(f"Newton step {it}", rn, info)
                return None
            # backtracking 'bt': t = 1, 1/2, ... 1/512, then one final
            # untested halving if all fail
            t = 1.0
            rnn = float(torch.linalg.norm(self.residual(x + t * delta, nu_v)))
            for _ in range(9):
                if rnn <= (1.0 - 1e-4 * t) * rn:
                    break
                t *= 0.5
                rnn = float(torch.linalg.norm(self.residual(x + t * delta, nu_v)))
            if rnn > (1.0 - 1e-4 * t) * rn:
                t *= 0.5
            x = x + t * delta
            r = self.residual(x, nu_v)
            rn_prev, eta_prev = rn, eta
            rn = float(torch.linalg.norm(r))
            if update_tol and it == 0:
                # from-zero start: re-anchor at ||F(x1)|| (x1 ~ the Stokes
                # solution), the reference's Stokes-init rtol semantics
                tol = min(tol, max(rtol * rn, atol))
            it += 1
        return x, rn, it, rn <= tol

    def newton_host(self, x0, nu_v, rtol, atol, max_it, retry_device=False):
        """Host-LU Newton with frozen-Jacobian steps; residual and Jacobian
        on the device. With `retry_device` (the fall-through after a device
        Newton's linear failure) each step first solves its linear system
        on the device at RETRY_ETA and factors on the host only where that
        does not converge, as the reference's fallback loop does; a retry
        that does not converge raises on CUDA tensors."""
        V, Q, dev = self.ctx.V, self.ctx.Q, self.device
        x = torch.where(self.mask, self.g, x0)
        r = self.residual(x, nu_v)
        rn0 = rn = float(torch.linalg.norm(r))
        tol = max(rtol * rn0, atol)
        steps = 0
        for _ in range(max_it):
            if rn <= tol or rn > 1e4 * rn0 or not np.isfinite(rn):
                break  # converged, or diverging
            J = self.jacobian(x, nu_v)
            delta, flu = None, None
            if retry_device:
                d, info = self.lin_solve(J, -r, RETRY_ETA)
                if info.converged:
                    delta = d
                    self.stats["device_retries"] = self.stats.get("device_retries", 0) + 1
                elif self.device.type != "cpu":
                    self._lin_failed(f"host-LU Newton step {steps}, device retry", rn, info)
            if delta is None:
                K = mixed.saddle_to_scipy(
                    J.cpu().numpy(), self.G_loc, V.dofmap,
                    Q.dofmap_scalar, self.nu_dofs, self.np_dofs,
                )
                flu = directmod.ConstrainedLU(K, self.mask_np)
                delta = torch.as_tensor(flu.solve(-r.cpu().numpy()), device=dev)
                self.stats["lin"] += 1
            steps += 1
            t = 1.0
            for _ in range(10):
                rn_new = float(torch.linalg.norm(self.residual(x + t * delta, nu_v)))
                if rn_new <= (1.0 - 1e-4 * t) * rn:
                    break
                t *= 0.5
            x = x + t * delta
            r = self.residual(x, nu_v)
            rn = float(torch.linalg.norm(r))
            # frozen-Jacobian steps while a back-substitution still buys a
            # 25% residual decrease
            while flu is not None and rn > tol and np.isfinite(rn):
                d2 = torch.as_tensor(flu.solve(-r.cpu().numpy()), device=dev)
                t2, accepted = 1.0, False
                for _ in range(6):
                    xn = x + t2 * d2
                    rv = self.residual(xn, nu_v)
                    rn_new = float(torch.linalg.norm(rv))
                    if rn_new <= 0.75 * rn:
                        x, r, rn = xn, rv, rn_new
                        accepted = True
                        break
                    t2 *= 0.5
                if not accepted:
                    break
        return x, rn, steps, rn <= tol

    def newton(self, x0, nu_v, rtol, atol, max_it, update_tol=False):
        if self.spec is not None:
            out = self.newton_device(x0, nu_v, rtol, atol, max_it, update_tol)
            if out is not None:
                return out
            return self.newton_host(x0, nu_v, rtol, atol, max_it, retry_device=True)
        return self.newton_host(x0, nu_v, rtol, atol, max_it)

    def stokes_direct(self, nu_init):
        """The constrained Stokes solution at viscosity nu_init by host
        SuperLU."""
        V, Q = self.ctx.V, self.ctx.Q
        K = mixed.saddle_to_scipy(
            nu_init * self.A1_loc, self.G_loc, V.dofmap, Q.dofmap_scalar,
            self.nu_dofs, self.np_dofs,
        )
        x = directmod.solve_direct_constrained(K, self.b.cpu().numpy(), self.mask_np, self.g_np)
        return torch.as_tensor(x, device=self.device)

    def stokes_init(self, nu_init):
        if self.spec is not None:
            # the constrained Stokes saddle solve on the device: the rhs
            # carries the BC lift, so the result is the solution
            Ju0 = nu_init * self.A1
            rhs = constrained_rhs(lambda v: self.cell_saddle(v, Ju0), self.b, self.mask, self.g)
            x, info = self.lin_solve(Ju0, rhs, NS_INIT_RTOL)
            if info.converged:
                return x
            self._lin_failed("Stokes init", float("nan"), info)
        self.stats["lin"] += 1
        return self.stokes_direct(nu_init)

    def run(self, opts):
        """One whole solve from the case's init: (grid, info)."""
        self.stats.clear()
        self.stats.update(kry_its=0, lin=0)
        init_mode = str(opts.get("init", "stokes")).lower()
        rtol = float(opts.get("rtol", 1e-10))
        atol = float(opts.get("atol", 1e-12))
        max_it = int(opts.get("max_it", 50))
        nu = self.nu
        device_newton = self.spec is not None
        from_zero = False
        zero = torch.where(self.mask, self.g, 0.0)
        if init_mode == "zero":
            x = zero
        elif init_mode == "exact":
            if self.mms_u is None:
                raise ValueError("init='exact' requires a manufactured solution")
            u_init = base.interpolate_nodal(self.ctx.V, list(self.mms_u))
            x = torch.as_tensor(np.concatenate([u_init, np.zeros(self.np_dofs)]), device=self.device)
        elif init_mode == "continuation":
            # full-strength Newton first: moderate-Re cases converge
            # directly; the divergence guard bounds a failed try. The
            # device Newton starts from the BC-lifted zero (its first step
            # IS the Stokes init), the host one from the Stokes solution.
            if device_newton:
                x0, max_try, from_zero = zero, min(9, max_it + 1), True
            else:
                x0, max_try = self.stokes_init(nu), min(8, max_it)
            x, rn, _, conv = self.newton(x0, nu, rtol, atol, max_try, from_zero)
            if conv:
                return self._finish(x, rn, init_mode, device_newton)
            # the geometric nu ladder; rungs need warm-start accuracy only,
            # the final Newton below reaches the case's rtol
            from_zero = False
            nu_start = float(opts.get("continuation_nu_start", 1.0))
            n_steps = int(opts.get("continuation_steps", 8))
            x = self.stokes_init(nu_start)
            for k in range(1, n_steps + 1):
                nu_k = nu_start * (nu / nu_start) ** (k / n_steps)
                x, _, _, _ = self.newton(x, nu_k, 1e-3, 1e-10, max_it)
        elif device_newton:  # 'stokes': the first device step is the init
            x, from_zero = zero, True
        else:
            x = self.stokes_init(nu)
        x, rn, _, _ = self.newton(
            x, nu, rtol, atol, max_it + (1 if from_zero else 0), update_tol=from_zero
        )
        return self._finish(x, rn, init_mode, device_newton)

    def _finish(self, x, rn, init_mode, device_newton):
        grid = self.ctx.sample_velocity_magnitude(x.cpu().numpy())
        failed = "iterative_failed" in self.stats
        info = {
            "method": "newton",
            "inner": ROUTE_HOST_LU if failed else self.route,
            "iterations": self.stats["lin"],
            "kry_its": self.stats["kry_its"],
            "residual": float(rn),
            "init_mode": init_mode,
            "device_newton": device_newton,
        }
        if failed:
            info["iterative_failed"] = self.stats["iterative_failed"]
            info["device_retries"] = self.stats.get("device_retries", 0)
        return grid, info


class NavierStokesSolver:
    """The route follows from the mesh (module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def solve(self, config: Dict[str, Any], _compute_baseline: bool = True) -> OracleResult:
        prob = NavierStokesProblem(config, self.device)
        config, ctx = prob.config, prob.ctx
        opts = base.solver_opts(config)
        (fem_grid, info), t_warm, t_cold = base.timed_run(lambda: prob.run(opts), prob.device)
        baseline_time = ctx.t_setup + t_warm

        baseline_error = 1e-2
        if _compute_baseline:
            err = scalar.mms_baseline_error(config, fem_grid)
            if err is None and "reference_config" in config:
                ref_cfg = scalar.merge_reference_config(config)
                # the reference's cap on its NS re-solve: resolution 96,
                # P2-P1 (higher-degree Taylor-Hood direct solves blow
                # memory and time without improving the comparison)
                mres = int(ref_cfg.get("mesh", {}).get("resolution", 96))
                ref_cfg.setdefault("mesh", {})["resolution"] = min(mres, 96)
                fem_cfg = ref_cfg.setdefault("fem", {})
                fem_cfg["degree_u"] = min(int(fem_cfg.get("degree_u", 2)), 2)
                fem_cfg["degree_p"] = min(int(fem_cfg.get("degree_p", 1)), 1)
                ref = NavierStokesSolver(self.device).solve(
                    ref_cfg, _compute_baseline=False
                )
                err = compute_rel_L2_grid(fem_grid, ref.reference)
            baseline_error = err if err is not None else 0.0

        solver_info = {
            "library": "pdebench_tpu_torch",
            "device": str(prob.device),
            "pde": "navier_stokes",
            "mesh_resolution": int(config.get("mesh", {}).get("resolution", 0)),
            "element_degree": ctx.V.degree,
            "degree_p": ctx.Q.degree,
            "viscosity": prob.nu,
            "snes_rtol": float(opts.get("rtol", 1e-10)),
            "snes_max_it": int(opts.get("max_it", 50)),
            "rtol": float(opts.get("rtol", 1e-10)),
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
            num_dofs=ctx.N,
        )
