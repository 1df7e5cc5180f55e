"""Linear-solve dispatch: per-case ksp/pc options -> lattice IR or host LU.

Maps the dataset's PETSc solver configs (oracle_solver.ksp_type / pc_type
/ rtol / atol per case) onto the port's stack:

  structured lattice, SPD  -> mixed-precision refinement (f64 outer
                              stencil residual, f32 inner): the fused
                              GMG-PCG inner, or a stencil PCG inner with
                              the GMG V-cycle or Jacobi preconditioner
  preonly / lu / cholesky  -> the same IR on lattices, host SuperLU
                              otherwise
  unconverged IR           -> host SuperLU on CPU tensors; on CUDA
                              tensors a RuntimeError (no solve moves to
                              the host behind a device request)

`solver_info["inner"]` records which inner solve ran: "fused-cg-cuda"
(the CUDA kernel), "fused-cg-torch" (its plain version, CPU tensors),
"stencil-cg", or "host-lu". Unstructured iterative routes (AMG, Jacobi
Krylov on cell operators) and nonsymmetric inners are not ported yet.

Port of the stencil-IR route of pdebench_tpu/solvers/dispatch.py.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..fem.assemble import LocalOperator, constrained_operator, constrained_rhs
from . import direct as directmod
from .gmg import LatticeGMG, attach_lattice_gmg
from .krylov import jacobi_preconditioner, refined_solve

_DIRECT_KSP = ("preonly",)
_DIRECT_PC = ("lu", "cholesky", "mumps")


def fused_gate(lattice32) -> bool:
    """The port's scope for the fused GMG-PCG inner: a scalar 2-D
    LatticeGMG whose hierarchy halves at every level. No memory budget:
    the hierarchy sits in L2 / device memory, not in on-chip scratch."""
    gmg = getattr(lattice32, "gmg", None)
    return (
        isinstance(gmg, LatticeGMG)
        and not gmg.padded
        and len(lattice32.shape) == 2
    )


def solve_constrained_ir(
    op: LocalOperator,
    b: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,
    lattice32,
    rtol: float,
    atol: float,
    *,
    inner_iters: int,
    max_outer: int,
):
    """Mixed-precision constrained solve of a constant lattice operator
    (SPD, CG inner): the f64 outer applies lattice32.W_f64 as a stencil,
    the f32 inner runs in lattice ordering (the dof <-> lattice
    permutation happens once per outer round only). `op` (the cell-local
    form of the same operator) feeds the Jacobi diagonal when the lattice
    has no GMG hierarchy.

    Returns (x, iterations, residual, converged, inner_name).
    """
    emb, inv = lattice32.embedding, lattice32.inv_j
    gshape = lattice32.grid_shape
    W64 = lattice32.W_f64

    def raw64(v):
        v_lat = emb.embed(v, 0.0).reshape(gshape)
        return lattice32.apply_grid_w(W64, v_lat).reshape(-1)[inv]

    A64 = constrained_operator(raw64, mask)
    rhs = constrained_rhs(raw64, b, mask, g)
    x0 = torch.where(mask, g, 0.0)

    # absent sites of masked lattices are treated as constrained
    mask_lat = emb.embed(mask, True)
    gmg = lattice32.gmg
    inner_custom = None
    if gmg is not None:
        if fused_gate(lattice32):
            inner_custom = gmg.fused.get(inner_iters)
            if inner_custom is None:
                from .gmg_fused import build_fused_inner_cg

                inner_custom = build_fused_inner_cg(
                    gmg, inner_iters, lattice32.device
                )
                gmg.fused[inner_iters] = inner_custom
        if inner_custom is not None:
            M32 = None
            inner_name = (
                "fused-cg-cuda" if b.device.type == "cuda" else "fused-cg-torch"
            )
        else:
            # padded hierarchies: the stencil PCG inner with the V-cycle
            vcyc = gmg.precond()
            M32 = lambda r_lat: vcyc(r_lat.reshape(gshape)).reshape(-1)
            inner_name = "stencil-cg"
    else:
        diag_lat = emb.embed(op.diagonal(), 1.0)
        M32 = jacobi_preconditioner(
            torch.where(mask_lat, 1.0, diag_lat).to(torch.float32)
        )
        inner_name = "stencil-cg"

    def A32(v_lat):
        vz = torch.where(mask_lat, 0.0, v_lat)
        y = lattice32.apply_grid(vz.reshape(gshape)).reshape(-1)
        return torch.where(mask_lat, v_lat, y)

    x, info = refined_solve(
        A64, A32, rhs, x0=x0, M32=M32, rtol=rtol, atol=atol,
        inner_iters=inner_iters, max_outer=max_outer,
        inner_fwd=lambda r: emb.embed(r, 0.0),
        inner_bwd=lambda z: z[inv],
        inner_custom=inner_custom,
    )
    return x, info.iterations, info.residual, info.converged, inner_name


def solve_linear(
    op: LocalOperator,
    b: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,
    opts: Dict[str, Any],
    symmetric: bool = True,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Solve (constrained) op x = b per case solver options; x on the host."""
    ksp = str(opts.get("ksp_type", "cg")).lower()
    pc = str(opts.get("pc_type", "jacobi")).lower()
    rtol = float(opts.get("rtol", 1e-10))
    atol = float(opts.get("atol", 1e-14))

    use_direct = ksp in _DIRECT_KSP or pc in _DIRECT_PC
    info: Dict[str, Any] = {"ksp_type": ksp, "pc_type": pc, "rtol": rtol}
    lat32 = opts.get("_lattice32")

    if lat32 is not None:
        if not symmetric:
            raise NotImplementedError("nonsymmetric lattice solves are not ported yet")
        if use_direct:
            # structured preonly/lu: the stencil-GMG IR reaches the same
            # rtol far faster than a host LU; on CPU tensors the LU stays
            # the fallback
            info["direct_rerouted"] = "stencil-ir"
        # attach the stencil-GMG V-cycle once per operator; below 5k dofs
        # its setup cost beats Jacobi only at size
        if (
            lat32.gmg is None
            and len(lat32.shape) in (2, 3)
            and op.ndof >= 5000
            and not opts.get("_gmg_failed")
        ):
            try:
                attach_lattice_gmg(lat32, mask.cpu().numpy())
            except ValueError as e:  # coarsest level too large to invert
                opts["_gmg_failed"] = f"{e}"
        has_gmg = lat32.gmg is not None
        x, iters, res, conv, inner_name = solve_constrained_ir(
            op, b, mask, g, lat32, rtol, atol,
            inner_iters=25 if has_gmg else 100,
            max_outer=40,
        )
        if conv:
            info.update(
                method="cg",
                pc_used="gmg+stencil-ir32" if has_gmg else "jacobi+stencil-ir32",
                inner=inner_name,
                iterations=int(iters),
                residual=float(res),
            )
            return x.cpu().numpy(), info
        info["iterative_failed"] = {
            "inner": inner_name,
            "iterations": int(iters),
            "residual": float(res),
        }
        if b.device.type != "cpu":
            raise RuntimeError(
                f"lattice IR did not converge on {b.device}: "
                f"{info['iterative_failed']} (rtol {rtol}, atol {atol})"
            )
    elif not use_direct:
        raise NotImplementedError(
            "iterative solves on unstructured meshes are not ported yet"
        )

    # host sparse-direct path (or the CPU fallback)
    x = directmod.solve_direct_constrained(
        op.to_scipy(), b.cpu().numpy(), mask.cpu().numpy(), g.cpu().numpy()
    )
    info.update(method="lu", inner="host-lu", iterations=1)
    return x, info
