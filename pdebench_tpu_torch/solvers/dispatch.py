"""Linear-solve dispatch: per-case ksp/pc options -> lattice IR or host LU.

Maps the dataset's PETSc solver configs (oracle_solver.ksp_type / pc_type
/ rtol / atol per case) onto the port's stack:

  structured lattice       -> mixed-precision refinement (f64 outer
                              stencil residual, f32 inner): a GMG-PCG
                              inner for SPD systems, one GMRES(m) cycle
                              per outer round for nonsymmetric or
                              indefinite ones (Helmholtz)
  preonly / lu / cholesky  -> the same IR on lattices, host SuperLU
                              otherwise
  unconverged IR           -> host SuperLU on CPU tensors; on CUDA
                              tensors a RuntimeError (no solve moves to
                              the host behind a device request)

`solver_info["inner"]` records which inner solve ran; "-cuda" names a
CUDA kernel, "-torch" its plain version (CPU tensors):

  SPD:          "fused-cg-cuda" / "fused-cg-torch" (scalar hierarchies),
                "fused-block-cg-cuda" / "fused-block-cg-torch" (d = 2 block
                hierarchies: elasticity), "stencil-cg" (padded
                hierarchies, or none)
  nonsymmetric: "fused-gmres-cuda" / "fused-gmres-torch" (the whole
                Arnoldi cycle, surrogate hierarchies of >= 20,000 dofs),
                "gmres+fused-richardson-cuda" / "-torch" (other surrogate
                hierarchies), "gmres+vcycle" (padded or own-operator
                hierarchies), "gmres+jacobi" (no hierarchy)
  per-step:     "gmres+vcycle" (`step_weights`: an operator that changes
                every step or Newton iteration, its float32 weights given,
                the constant part's hierarchy as preconditioner; Burgers,
                the reaction Jacobian)
  host:         "host-lu"

The routes and names are the same on 2-D and 3-D scalar lattices; block
lattices are 2-D only. Unstructured iterative routes (AMG, Jacobi Krylov
on cell operators) are not ported yet.

Port of the stencil-IR route of pdebench_tpu/solvers/dispatch.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..fem.assemble import LocalOperator, constrained_operator, constrained_rhs
from . import direct as directmod
from .gmg import BlockLatticeGMG, LatticeGMG, attach_lattice_gmg
from .krylov import jacobi_preconditioner, refined_solve
from .stencil import constrain_step_weights

_DIRECT_KSP = ("preonly",)
_DIRECT_PC = ("lu", "cholesky", "mumps")

# size gates of the reference, kept until a measurement moves them:
# a GMG hierarchy is attached from this many dofs on (below, its setup
# costs more than Jacobi's extra iterations) ...
GMG_MIN_DOFS = 5000
# ... and a surrogate hierarchy runs the whole fused Arnoldi cycle from
# this many on (below, the fused Richardson preconditioner)
FUSED_ARNOLDI_MIN_DOFS = 20000
# the nonsymmetric inner's Richardson preconditioner: chained V-cycles
RICHARDSON_CYCLES = 2
MAX_OUTER = 40
# outer rounds of one step of a time loop (the reference's per-step
# solve_constrained_ir default)
STEP_MAX_OUTER = 60


def direct_request(opts: Dict[str, Any]) -> bool:
    """Whether a case's solver options ask for a direct solve (preonly,
    or an LU-type pc)."""
    ksp = str(opts.get("ksp_type", "cg")).lower()
    pc = str(opts.get("pc_type", "jacobi")).lower()
    return ksp in _DIRECT_KSP or pc in _DIRECT_PC


def fused_gate(lattice32) -> bool:
    """The port's scope for the fused kernels: a scalar 2-D or 3-D
    LatticeGMG whose hierarchy halves at every level. No memory budget:
    the hierarchy sits in L2 / device memory, not in on-chip scratch (the
    reference's Pallas builders return None above their VMEM budgets,
    which every 3-D dataset hierarchy exceeds)."""
    gmg = getattr(lattice32, "gmg", None)
    return (
        isinstance(gmg, LatticeGMG)
        and not gmg.padded
        and len(lattice32.shape) in (2, 3)
    )


def fused_block_gate(lattice32) -> bool:
    """The block kernel's scope: a 2-D BlockLatticeGMG of two components
    whose hierarchy halves at every level."""
    gmg = getattr(lattice32, "gmg", None)
    return (
        isinstance(gmg, BlockLatticeGMG)
        and not gmg.padded
        and gmg.d == 2
        and len(lattice32.shape) == 2
    )


def _fused(gmg, key, build):
    """The fused kernel object `key` of this hierarchy, built once."""
    if key not in gmg.fused:
        gmg.fused[key] = build()
    return gmg.fused[key]


def solve_constrained_ir(
    op: Optional[LocalOperator],
    b: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,
    lattice32,
    rtol: float,
    atol: float,
    *,
    inner: str,
    inner_iters: int,
    max_outer: int,
    step_weights=None,
):
    """Mixed-precision constrained solve of a lattice operator: the f64
    outer applies lattice32.W_f64 as a stencil, the f32 inner ("cg" or
    "gmres") runs in lattice ordering (the dof <-> lattice permutation
    happens once per outer round only). `op` (the cell-local form of the
    same operator) feeds the Jacobi diagonal when the lattice has no GMG
    hierarchy.

    step_weights=(wmap, W32): a per-step operator on lattice32's lattice
    (Burgers' lagged convection, a Newton Jacobian), its float32 weights
    W32 on wmap's offsets. The f64 outer applies W32 CAST to f64 (the
    reference's stencil-cast outer: it converges to the operator of the
    float32 weights, not to the float64 assembly's), the f32 inner applies
    W32, and lattice32's hierarchy of the constant part preconditions a
    GMRES inner through the PyTorch V-cycle ("gmres+vcycle"); every apply
    is one stencil kernel launch on CUDA tensors. `op` is not used.

    Returns (x, iterations, residual, converged, inner_name).
    """
    emb, inv = lattice32.embedding, lattice32.inv_j
    gshape = lattice32.grid_shape
    if step_weights is None:
        apply_w, W32, W64 = lattice32.apply_grid_w, lattice32.W, lattice32.W_f64
    else:
        if inner != "gmres" or lattice32.gmg is None:
            raise ValueError("a per-step operator takes a GMRES inner on a lattice with a hierarchy")
        wmap, W32 = step_weights
        apply_w, W64 = wmap.apply_grid, W32.to(b.dtype)

    def raw64(v):
        v_lat = emb.embed(v, 0.0).reshape(gshape)
        return apply_w(W64, v_lat).reshape(-1)[inv]

    A64 = constrained_operator(raw64, mask)
    rhs = constrained_rhs(raw64, b, mask, g)
    x0 = torch.where(mask, g, 0.0)

    # absent sites of masked lattices are treated as constrained
    mask_lat = emb.embed(mask, True)
    if step_weights is None:
        inner_custom, M32, inner_name = _inner_route(op, lattice32, mask_lat, inner, inner_iters)
    else:
        inner_custom, M32, inner_name = None, _vcycle(lattice32), "gmres+vcycle"

    def A32(v_lat):
        vz = torch.where(mask_lat, 0.0, v_lat)
        y = apply_w(W32, vz.reshape(gshape)).reshape(-1)
        return torch.where(mask_lat, v_lat, y)

    x, info = refined_solve(
        A64, A32, rhs, x0=x0, M32=M32, rtol=rtol, atol=atol,
        inner_iters=inner_iters, max_outer=max_outer,
        inner_fwd=lambda r: emb.embed(r, 0.0),
        inner_bwd=lambda z: z[inv],
        inner=inner,
        inner_custom=inner_custom,
    )
    return x, info.iterations, info.residual, info.converged, inner_name


def prepare_inner(op: LocalOperator, mask: torch.Tensor, lattice32, inner: str, inner_iters: int) -> str:
    """Build now what solve_constrained_ir's inner takes on this operator
    (the fused kernel object, kept on the hierarchy), so that a step loop
    charges it to setup; returns the inner's name."""
    mask_lat = lattice32.embedding.embed(mask, True)
    return _inner_route(op, lattice32, mask_lat, inner, inner_iters)[2]


def _inner_route(op: LocalOperator, lattice32, mask_lat: torch.Tensor, inner: str, inner_iters: int):
    """(inner_custom, M32, inner name) of the IR's inner on this lattice
    operator: the route rule of the module docstring."""
    gshape = lattice32.grid_shape
    dev = lattice32.device
    emb = lattice32.embedding
    gmg = lattice32.gmg
    kind = "cuda" if dev.type == "cuda" else "torch"
    inner_custom, M32 = None, None
    if gmg is None:
        diag_lat = emb.embed(op.diagonal(), 1.0)
        M32 = jacobi_preconditioner(
            torch.where(mask_lat, 1.0, diag_lat).to(torch.float32)
        )
        inner_name = "stencil-cg" if inner == "cg" else "gmres+jacobi"
    elif inner == "cg" and fused_gate(lattice32):
        from .gmg_fused import build_fused_inner_cg

        inner_custom = _fused(
            gmg, ("cg", inner_iters),
            lambda: build_fused_inner_cg(gmg, inner_iters, dev),
        )
        inner_name = f"fused-cg-{kind}"
    elif inner == "cg" and fused_block_gate(lattice32):
        from .gmg_fused import build_fused_block_inner_cg

        inner_custom = _fused(
            gmg, ("block-cg", inner_iters),
            lambda: build_fused_block_inner_cg(gmg, inner_iters, dev),
        )
        inner_name = f"fused-block-cg-{kind}"
    elif (
        inner == "gmres"
        and gmg.surrogate
        and fused_gate(lattice32)
        and op.ndof >= FUSED_ARNOLDI_MIN_DOFS
    ):
        # the hierarchy preconditions a SURROGATE (Helmholtz's shifted
        # Laplacian): the Arnoldi operator is the TRUE constrained
        # system, its weights a kernel input, never hierarchy level 0
        from .gmg_fused import build_fused_inner_gmres

        def build():
            keep = (1.0 - mask_lat.to(torch.float32)).reshape(gshape)
            W32c = constrain_step_weights(lattice32.W, lattice32.offsets, keep)
            fg = build_fused_inner_gmres(gmg, inner_iters, dev, lattice32.offsets)
            return lambda r, _f=fg, _w=W32c: _f(r, _w)

        inner_custom = _fused(gmg, ("gmres", inner_iters), build)
        inner_name = f"fused-gmres-{kind}"
    elif inner == "gmres" and gmg.surrogate and fused_gate(lattice32):
        from .gmg_fused import build_fused_richardson

        M32 = _fused(
            gmg, ("richardson", RICHARDSON_CYCLES),
            lambda: build_fused_richardson(gmg, RICHARDSON_CYCLES, dev),
        )
        inner_name = f"gmres+fused-richardson-{kind}"
    else:
        # padded hierarchies, and own-operator hierarchies under gmres
        # (the undamped Richardson chain is not contractive on strongly
        # nonsymmetric operators): the V-cycle in PyTorch ops
        M32 = _vcycle(lattice32)
        inner_name = "stencil-cg" if inner == "cg" else "gmres+vcycle"
    return inner_custom, M32, inner_name


def _vcycle(lattice32):
    """The PyTorch V-cycle of lattice32's hierarchy on flat lattice
    vectors (its levels' applies are stencil kernel launches)."""
    gshape = lattice32.grid_shape
    vcyc = lattice32.gmg.precond()
    return lambda r_lat: vcyc(r_lat.reshape(gshape)).reshape(-1)


def krylov_method(opts: Dict[str, Any]) -> str:
    """A case's PETSc-style ksp_type as the Krylov method its solve
    reports: cg (cg or minres), bicgstab, or gmres."""
    ksp = str(opts.get("ksp_type", "cg")).lower()
    if ksp in ("cg", "minres"):
        return "cg"
    if ksp == "bicgstab":
        return "bicgstab"
    return "gmres"


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

    use_direct = direct_request(opts)
    info: Dict[str, Any] = {"ksp_type": ksp, "pc_type": pc, "rtol": rtol}
    lat32 = opts.get("_lattice32")

    if lat32 is not None:
        if use_direct:
            # structured preonly/lu: the stencil-GMG IR reaches the same
            # rtol far faster than a host LU; on CPU tensors the LU stays
            # the fallback
            info["direct_rerouted"] = "stencil-ir"
        # SPD systems run CG whatever the case's ksp asks (the dataset's
        # gmres+hypre elasticity configs are SPD)
        inner = "cg" if symmetric else "gmres"
        # attach the stencil-GMG V-cycle once per operator; indefinite
        # systems coarsen the surrogate in opts['_amg_matrix']
        # (Helmholtz's shifted Laplacian)
        if (
            lat32.gmg is None
            and len(lat32.shape) in (2, 3)
            and op.ndof >= GMG_MIN_DOFS
            and not opts.get("_gmg_failed")
        ):
            try:
                attach_lattice_gmg(
                    lat32, mask.cpu().numpy(), A_override=opts.get("_amg_matrix")
                )
            except ValueError as e:  # coarsest level too large to invert
                opts["_gmg_failed"] = f"{e}"
        has_gmg = lat32.gmg is not None
        if inner == "cg":
            n_inner = 25 if has_gmg else 100
        else:
            n_inner = 30 if has_gmg else 60
        x, iters, res, conv, inner_name = solve_constrained_ir(
            op, b, mask, g, lat32, rtol, atol,
            inner=inner, inner_iters=n_inner, max_outer=MAX_OUTER,
        )
        if conv:
            info.update(
                method=inner,
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
