"""Linear-solve dispatch: per-case ksp/pc options -> lattice IR, SA-AMG or
host LU.

Maps the dataset's PETSc solver configs (oracle_solver.ksp_type / pc_type
/ rtol / atol per case) onto the port's stack:

  structured lattice       -> mixed-precision refinement (f64 outer
                              stencil residual, f32 inner): a GMG-PCG
                              inner for SPD systems, one GMRES(m) cycle
                              per outer round for nonsymmetric or
                              indefinite ones (Helmholtz)
  no lattice, or a lattice -> the route off the lattice (the cell-local
  IR that did not converge    operator, every sum in a fixed order):
                              below AMG_MIN_DOFS (NONSYM_AMG_MIN_DOFS for
                              nonsymmetric systems) a float64 Jacobi
                              Krylov solve; above, SA-AMG (solvers/amg.py)
                              preconditioning a mixed-precision
                              refinement, CG-IR with 30 inner steps or
                              FGMRES-IR with 60, then a float64 retry of
                              at most F64_RETRY_MAXITER iterations where
                              the refinement made progress but stopped
                              short. On CPU tensors a nonsymmetric system
                              off the lattice of at most HOST_LU_MAX_DOFS
                              dofs takes the host LU (the reference's CPU
                              branch, kept so that parity tests compare
                              like with like)
  preonly / lu / cholesky  -> the lattice IR on lattices, host SuperLU
                              otherwise
  unconverged              -> host SuperLU on CPU tensors; on CUDA
                              tensors a RuntimeError (no solve moves to
                              the host behind a device request)

`solver_info["inner"]` records which inner solve answered; "-cuda" names
a CUDA kernel, "-torch" its plain version (CPU tensors):

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
  off lattice:  "amg-cg-ir", "amg-gmres-ir" (the refinement), "amg-cg",
                "amg-gmres", "amg-bicgstab" (float64 Krylov with the AMG
                V-cycle: the retry, or bicgstab), "jacobi-cg",
                "jacobi-gmres", "jacobi-bicgstab" (float64 Jacobi Krylov:
                `solve_constrained`, which heat's and wave's step loops
                with a non-CG ksp and Cahn-Hilliard's Newton steps call
                too),
                "jacobi-cg-ir", "jacobi-gmres-ir" (a pc that is not
                AMG-type above the gate)
  cell-local    "jacobi-cg-ir", "jacobi-gmres-ir", "amg-cg-ir" (one step
  steps:        of a step loop off the lattice, or of a per-step operator
                on a lattice without a hierarchy: `solve_constrained_ir`
                with lattice32=None, the same refinement as the route off
                the lattice; wave's AMG is built once per case)
  host:         "host-lu"

After a lattice IR that did not converge, `solver_info["iterative_failed"]`
keeps that attempt and `inner` names the route that answered. The routes
and names are the same on 2-D and 3-D scalar lattices. Block lattices
(elasticity) take "fused-block-cg-*" in 2-D (d = 2); 3-D ones (d = 3)
take "stencil-cg", CG preconditioned by the PyTorch block V-cycle, each
level's apply one stencil kernel launch (the reference's scope: its
fused block kernel is 2-D only).

Port of pdebench_tpu/solvers/dispatch.py. Not ported, by decision: the
reference's small-direct gate for its remote TPU (systems off the lattice
below 40,000 dofs sent to the host LU there).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..fem.assemble import LocalOperator, constrained_operator, constrained_rhs
from . import direct as directmod
from .gmg import BlockLatticeGMG, LatticeGMG, attach_lattice_gmg
from .krylov import bicgstab, cg, gmres, jacobi_preconditioner, refined_solve
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

# the route off the lattice, at the reference's CPU gates (its dispatch.py
# :444, :726): SA-AMG from this many dofs on for symmetric systems ...
AMG_MIN_DOFS = 20000
# ... and from this many for nonsymmetric ones; below, Jacobi Krylov
NONSYM_AMG_MIN_DOFS = 8000
# nonsymmetric systems off the lattice of at most this many dofs take the
# host LU on CPU tensors (the reference's CPU branch, :686-700)
HOST_LU_MAX_DOFS = 80000
# the refinement off the lattice: inner steps a round (CG, GMRES) and
# rounds (the reference's refined_solve defaults)
OFF_LATTICE_INNER_ITERS = {"cg": 30, "gmres": 60}
OFF_LATTICE_MAX_OUTER = 60
# the float64 retry after a refinement that stopped short
F64_RETRY_MAXITER = 3000
# a refinement that stopped above this share of ||b|| stagnated (a bad
# preconditioner): no retry
RETRY_MAX_RESIDUAL = 1e-3
# pc types that take SA-AMG (the hypre and ilu roles of the dataset)
AMG_PC = ("hypre", "boomeramg", "gamg", "amg", "ml", "ilu", "sor")


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
    M32_custom: Optional[Callable] = None,
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

    lattice32=None: the cell-local form (meshes whose dofs form no
    lattice, lattices without a hierarchy for a per-step operator). The
    f64 outer applies `op`, a float64 LocalOperator, the f32 inner its
    float32 cast, both summed in a fixed order; the inner is
    preconditioned by M32_custom (a float32 SA-AMG V-cycle built once,
    outside the step loop: "amg-<inner>-ir") or by Jacobi on the float32
    batch's constrained diagonal ("jacobi-<inner>-ir"). A step loop passes
    a fresh cell batch as `op.with_local(A)` each step.

    Returns (x, iterations, residual, converged, inner_name).
    """
    if lattice32 is None:
        A64, rhs, x0 = _constrained_system(op, b, mask, g)
        if M32_custom is None:
            M32 = jacobi_preconditioner(torch.where(mask, 1.0, op.astype(torch.float32).diagonal()))
        else:
            M32 = M32_custom
        x, info = _cell_refinement(op, A64, rhs, x0, mask, M32, rtol, atol, inner, inner_iters, max_outer)
        pc = "jacobi" if M32_custom is None else "amg"
        return x, info.iterations, info.residual, info.converged, f"{pc}-{inner}-ir"
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


def krylov_method(opts: Dict[str, Any], symmetric: bool = True) -> str:
    """A case's PETSc-style ksp_type as the Krylov method its solve
    reports: cg (cg or minres, on a symmetric system), bicgstab, or
    gmres."""
    ksp = str(opts.get("ksp_type", "cg")).lower()
    if ksp in ("cg", "minres") and symmetric:
        return "cg"
    if ksp == "bicgstab":
        return "bicgstab"
    return "gmres"


# the restart of the float64 GMRES (the reference's solve_constrained default)
GMRES_RESTART = 60


def _krylov(A, rhs, x0, M, method: str, rtol: float, atol: float, maxiter: int):
    """Float64 Krylov solve of the constrained system with preconditioner
    M: method "cg", "bicgstab" or "gmres" (GMRES(GMRES_RESTART)). Returns
    (x, info)."""
    if method == "gmres":
        return gmres(A, rhs, x0=x0, M=M, rtol=rtol, atol=atol, maxiter=maxiter, restart=GMRES_RESTART)
    kry = {"cg": cg, "bicgstab": bicgstab}[method]
    return kry(A, rhs, x0=x0, M=M, rtol=rtol, atol=atol, maxiter=maxiter)


def solve_constrained(
    A,
    b: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,
    method: str,
    rtol: float,
    atol: float,
    maxiter: int,
    restart: int = GMRES_RESTART,
    dofmap: Optional[np.ndarray] = None,
):
    """Float64 constrained Krylov solve on cell-local matrices: the
    reference's solve_constrained (pdebench_tpu/solvers/dispatch.py:42-90).

    A is a LocalOperator, or a (n_cells, nl, nl) batch of cell matrices
    with its `dofmap` (the system has b's length). Dirichlet dofs (mask)
    take g: the system is A with identity rows and columns there, the
    right-hand side b - A g on the free dofs, the start x0 = g on the
    constrained dofs and 0 elsewhere, the preconditioner Jacobi on the
    constrained diagonal; method "cg", "bicgstab" or "gmres" (GMRES(
    restart)). Every sum runs in a fixed order (LocalOperator's), so a
    solve repeats bit for bit on the card. Returns (x, iterations,
    residual, converged)."""
    op = A if isinstance(A, LocalOperator) else LocalOperator(A, dofmap, b.shape[0])
    Ac, rhs, x0 = _constrained_system(op, b, mask, g)
    M = jacobi_preconditioner(_jacobi_diagonal(op, mask))
    if method == "gmres" and restart != GMRES_RESTART:
        x, info = gmres(Ac, rhs, x0=x0, M=M, rtol=rtol, atol=atol, maxiter=maxiter, restart=restart)
    else:
        x, info = _krylov(Ac, rhs, x0, M, method, rtol, atol, maxiter)
    return x, int(info.iterations), float(info.residual), bool(info.converged)


def _constrained_system(op: LocalOperator, b, mask, g):
    """(A, rhs, x0) of the constrained float64 system on the cell-local
    operator."""
    A64 = op.astype(torch.float64)
    return constrained_operator(A64, mask), constrained_rhs(A64, b, mask, g), torch.where(mask, g, 0.0)


def _cell_refinement(op: LocalOperator, A64, rhs, x0, mask, M32, rtol, atol, inner, inner_iters, max_outer):
    """The mixed-precision refinement on the cell-local operator: the
    constrained float64 system (A64, rhs, x0) as the outer, op's float32
    cast as the inner's operator. The route off the lattice and the
    cell-local step solves share it. Returns (x, KrylovInfo)."""
    A32 = constrained_operator(op.astype(torch.float32), mask)
    return refined_solve(
        A64, A32, rhs, x0=x0, M32=M32, rtol=rtol, atol=atol,
        inner=inner, inner_iters=inner_iters, max_outer=max_outer,
    )


def _jacobi_diagonal(op: LocalOperator, mask):
    """The float64 diagonal of the constrained system (1 on constrained
    dofs)."""
    return torch.where(mask, 1.0, op.astype(torch.float64).diagonal())


def _build_preconditioner(op: LocalOperator, mask: torch.Tensor, pc: str, opts: Dict[str, Any]):
    """(M64, M32, name) of the route off the lattice:
    SA-AMG for an AMG-type pc from AMG_MIN_DOFS dofs on, or at any size
    when the oracle gives the AMG a matrix of its own (`_amg_matrix`:
    Helmholtz's shifted Laplacian) or a near-nullspace (`_amg_B`:
    elasticity's rigid-body modes, with `_amg_block` dofs a node); Jacobi
    otherwise, or where the coarsest level cannot be inverted (the reason
    kept under opts["_amg_failed"]). The f32 twin feeds the refinement."""
    from .amg import setup_amg_masked_pair

    if pc in AMG_PC and (
        op.ndof >= AMG_MIN_DOFS
        or opts.get("_amg_matrix") is not None
        or opts.get("_amg_B") is not None
    ):
        A_pc = opts.get("_amg_matrix")
        if A_pc is None:
            A_pc = op.to_scipy()
        try:
            M64, M32, _ = setup_amg_masked_pair(
                A_pc, mask.cpu().numpy(), B=opts.get("_amg_B"),
                block_size=int(opts.get("_amg_block", 1)), device=mask.device,
            )
            return M64, M32, "amg"
        except np.linalg.LinAlgError as e:  # the coarsest level's pinv
            opts["_amg_failed"] = f"{e}"
    diag = _jacobi_diagonal(op, mask)
    return jacobi_preconditioner(diag), jacobi_preconditioner(diag.to(torch.float32)), "jacobi"


def _off_lattice(op, b, mask, g, opts, symmetric, info, rtol, atol, maxiter):
    """The route off the lattice (module docstring): (the solution, None)
    with `info` filled in, or (None, what did not converge)."""
    method = krylov_method(opts, symmetric)
    if op.ndof < (AMG_MIN_DOFS if symmetric else NONSYM_AMG_MIN_DOFS) and opts.get("_amg_B") is None:
        # float64 Jacobi Krylov (solve_constrained, the reference's
        # non-refined solve); block systems with a near-nullspace
        # (elasticity) skip it at every size: near-incompressible
        # conditioning stalls it
        info["pc_used"], inner = "jacobi", f"jacobi-{method}"
        x, its, res, conv = solve_constrained(op, b, mask, g, method, rtol, atol, maxiter)
        if conv:
            info.update(method=method, inner=inner, iterations=its, residual=res)
            return x, None
        return None, {"inner": inner, "iterations": its, "residual": res}
    # the preconditioner per method, shape and constraint set, built once:
    # the warm run reuses the cold run's setup (biharmonic's two solves
    # share one)
    A, rhs, x0 = _constrained_system(op, b, mask, g)
    cache = opts.setdefault("_amg_cache", {})
    key = (method, op.ndof, int(mask.sum()), int(mask.to(torch.uint8).argmax()))
    if key not in cache:
        cache[key] = _build_preconditioner(op, mask, str(opts.get("pc_type", "jacobi")).lower(), opts)
    M64, M32, pc_used = cache[key]
    mixed = method in ("cg", "gmres")
    inner_kind = "cg" if (method == "cg" and symmetric) else "gmres"
    info["pc_used"] = pc_used + ("+ir32" if mixed else "")
    inner = f"{pc_used}-{inner_kind}-ir" if mixed else f"{pc_used}-{method}"
    if mixed:
        x, kinfo = _cell_refinement(
            op, A, rhs, x0, mask, M32, rtol, atol, inner_kind,
            OFF_LATTICE_INNER_ITERS[inner_kind], OFF_LATTICE_MAX_OUTER,
        )
    else:
        x, kinfo = _krylov(A, rhs, x0, M64, method, rtol, atol, maxiter)
    if mixed and not kinfo.converged:
        # the float32 floor or hard conditioning: a float64 retry, but only
        # where the refinement made progress; one stopped at O(||b||) means
        # a bad preconditioner, and the retry would grind its whole budget
        if kinfo.residual < RETRY_MAX_RESIDUAL * max(float(torch.linalg.norm(b)), 1e-300):
            info["ir_stopped"] = {"inner": inner, "iterations": int(kinfo.iterations),
                                  "residual": float(kinfo.residual)}
            x, kinfo = _krylov(A, rhs, x0, M64, method, rtol, atol, min(maxiter, F64_RETRY_MAXITER))
            info["pc_used"], inner = pc_used + "+f64retry", f"{pc_used}-{method}"
        else:
            info["pc_used"] = pc_used + "+stagnated"
    if kinfo.converged:
        info.update(method=method, inner=inner, iterations=int(kinfo.iterations),
                    residual=float(kinfo.residual))
        return x, None
    return None, {"inner": inner, "iterations": int(kinfo.iterations), "residual": float(kinfo.residual)}


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
    maxiter = int(opts.get("max_it", opts.get("maxiter", 25000)))

    use_direct = direct_request(opts)
    info: Dict[str, Any] = {"ksp_type": ksp, "pc_type": pc, "rtol": rtol}
    lat32 = opts.get("_lattice32")
    on_card = b.device.type != "cpu"

    if lat32 is not None:
        rerouted = use_direct
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
        if isinstance(lat32.gmg, BlockLatticeGMG):
            # each level's shape and taps (the stencil kernel takes at
            # most stencil_kernel.MAX_TAPS: a level beyond raises at its plan)
            info["gmg_levels"] = [list(lv.shape) + [len(lv.offsets)] for lv in lat32.gmg.levels]
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
        if rerouted and on_card:
            raise RuntimeError(
                f"lattice IR did not converge on {b.device}: "
                f"{info['iterative_failed']} (rtol {rtol}, atol {atol})"
            )
        # a direct request goes on to the host LU; any other falls through
        # to the route off the lattice (the reference's generic route)
    elif (
        not use_direct
        and not symmetric
        and op.ndof <= HOST_LU_MAX_DOFS
        and not on_card
    ):
        use_direct = True
        info["cpu_main_direct"] = True

    if not use_direct:
        x, failed = _off_lattice(op, b, mask, g, opts, symmetric, info, rtol, atol, maxiter)
        if x is not None:
            return x.cpu().numpy(), info
        # a lattice IR's failure stays the first record
        info["iterative_failed_off_lattice" if "iterative_failed" in info else "iterative_failed"] = failed
        if on_card:
            raise RuntimeError(
                f"the solve did not converge on {b.device}: {failed} (rtol {rtol}, atol {atol})"
                + (f"; the lattice IR before it: {info['iterative_failed']}" if lat32 is not None else "")
            )

    # host sparse-direct path (or the CPU fallback)
    x = directmod.solve_direct_constrained(
        op.to_scipy(), b.cpu().numpy(), mask.cpu().numpy(), g.cpu().numpy()
    )
    info.update(method="lu", inner="host-lu", iterations=1)
    return x, info
