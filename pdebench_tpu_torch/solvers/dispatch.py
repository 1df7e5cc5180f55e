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
                Arnoldi cycle, surrogate hierarchies of >= 20,000 dofs;
                under PDEBENCH_TPU_FUSED=arnoldi every unpadded scalar
                hierarchy, own-operator and surrogate, of any size),
                "gmres+fused-richardson-cuda" / "-torch" (other surrogate
                hierarchies), "gmres+vcycle" (padded or own-operator
                hierarchies), "gmres+jacobi" (no hierarchy)
  per-step:     "gmres+vcycle" (`step_weights`: an operator that changes
                every step or Newton iteration, its float32 weights given,
                the constant part's hierarchy as preconditioner; Burgers,
                the reaction Jacobian; padded hierarchies whatever the
                switches), "fused-gmres-step-cuda" / "-torch"
                (PDEBENCH_TPU_FUSED=arnoldi: the whole Arnoldi cycle, the
                step's constrained float32 weights a kernel input),
                "gmres+fused-richardson-step-cuda" / "-torch"
                (PDEBENCH_TPU_STEP_RICH=1: 2 V-cycles of the constant
                part's hierarchy in one launch precondition the GMRES)
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

With PDEBENCH_TPU_HALO=1 and a torch.distributed default process group
of more than one rank (parallel/group.py), a symmetric system on a
lattice takes the stripe-partitioned route first: Jacobi-PCG with a halo
exchange of boundary rows an apply (parallel/halo.py), pc_used
"jacobi+halo-sharded[n]", inner "halo-cg", every rank returning the same
solution. Where it fails or does not converge it raises on CUDA tensors;
on CPU tensors `solver_info["halo_failed"]` records why and the solve
goes on by the routes above, as in the reference.

The reference's route switches, read at call time under its names:

  PDEBENCH_TPU_FUSED       "1" (default), "all", "cg": the routes above;
                           "arnoldi": also kernel #6's whole Arnoldi cycle
                           on every scalar hierarchy in fused_gate, steady
                           and per-step ("0" / "none", the reference's
                           lattice routes without a fused kernel, are not
                           ported: every lattice solve of solve_linear and
                           solve_constrained_ir raises under them)
  PDEBENCH_TPU_STEP_RICH   "1": kernel #3 preconditions a per-step GMRES
                           that the fused cycle does not take
  PDEBENCH_TPU_STEP_OUTER  "stencil" (default): a per-step system's f64
                           outer applies its float32 weights cast to f64;
                           "cell": the step's exact float64 cell batch
                           through the cell-local apply (read by the
                           oracles, which pass the batch as `op` with
                           cell_outer=True)
  PDEBENCH_TPU_FORCE_DIRECT
                           "1": every solve_linear call takes the host LU
                           (the frozen CPU-proxy protocol),
                           solver_info["host_request"] names the switch
  PDEBENCH_TPU_STRUCTURED_LU
                           "ir" (default): a direct request on a lattice
                           takes the lattice IR ("direct_rerouted");
                           "direct": the literal host LU

Each switch is an explicit request: a kernel that fails to build or
launch raises, never giving way to a plain version. A switched route that
does not converge is handled as every lattice IR is: a steady iterative
request goes on to the route off the lattice (`iterative_failed` keeps
the stall), a step loop's step raises on CUDA tensors.

Port of pdebench_tpu/solvers/dispatch.py. Not ported, by decision: the
reference's small-direct gate for its remote TPU (systems off the lattice
below 40,000 dofs sent to the host LU there).
"""

from __future__ import annotations

import os
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


def fused_mode() -> str:
    """PDEBENCH_TPU_FUSED at call time: "arnoldi" (kernel #6 on every
    scalar hierarchy in fused_gate, steady and per-step) or "default" (the
    reference's "1", "all" and "cg"). "0" and "none", the reference's
    pure XLA path, have no counterpart in the port."""
    mode = os.environ.get("PDEBENCH_TPU_FUSED", "1").lower()
    if mode in ("0", "none"):
        raise NotImplementedError(f"PDEBENCH_TPU_FUSED={mode}: the port has no route without its kernels")
    return "arnoldi" if mode == "arnoldi" else "default"


def step_rich() -> bool:
    """PDEBENCH_TPU_STEP_RICH=1 at call time: kernel #3 (RICHARDSON_CYCLES
    V-cycles of the constant part's hierarchy) preconditions a per-step
    GMRES that the fused Arnoldi cycle does not take."""
    return os.environ.get("PDEBENCH_TPU_STEP_RICH", "0") == "1"


def step_outer() -> str:
    """PDEBENCH_TPU_STEP_OUTER at call time: the f64 outer of a per-step
    system, "stencil" (its float32 weights cast to f64) or "cell" (the
    step's exact float64 cell batch). The Burgers and reaction oracles read
    it once a solve and pass solve_constrained_ir `cell_outer`."""
    outer = os.environ.get("PDEBENCH_TPU_STEP_OUTER", "stencil")
    if outer not in ("stencil", "cell"):
        raise ValueError(f"PDEBENCH_TPU_STEP_OUTER={outer}: expected stencil or cell")
    return outer


def force_direct() -> bool:
    """PDEBENCH_TPU_FORCE_DIRECT=1 at call time: solve_linear takes the
    host LU for every case."""
    return os.environ.get("PDEBENCH_TPU_FORCE_DIRECT") == "1"


def structured_lu_direct() -> bool:
    """PDEBENCH_TPU_STRUCTURED_LU at call time: anything but "ir" (the
    default) keeps a direct request on a lattice on the host LU."""
    return os.environ.get("PDEBENCH_TPU_STRUCTURED_LU", "ir") != "ir"


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
    cell_outer: bool = False,
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
    float32 weights, not to the float64 assembly's) or, with `cell_outer`
    (PDEBENCH_TPU_STEP_OUTER=cell), `op`, the step's float64 cell batch
    through the cell-local apply (the exact operator). The f32 inner
    applies W32 in a GMRES, preconditioned by lattice32's hierarchy of the
    constant part: the PyTorch V-cycle ("gmres+vcycle"), kernel #3's chain
    under PDEBENCH_TPU_STEP_RICH=1, or the whole Arnoldi cycle as kernel
    #6 under PDEBENCH_TPU_FUSED=arnoldi (`_step_inner_route`); every
    stencil apply is one kernel launch on CUDA tensors. Without
    `cell_outer` `op` is not used.

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
    fused_mode()  # PDEBENCH_TPU_FUSED=0 / none raises on every lattice route
    emb, inv = lattice32.embedding, lattice32.inv_j
    gshape = lattice32.grid_shape
    if step_weights is None:
        apply_w, W32, W64 = lattice32.apply_grid_w, lattice32.W, lattice32.W_f64
    else:
        if inner != "gmres" or lattice32.gmg is None:
            raise ValueError("a per-step operator takes a GMRES inner on a lattice with a hierarchy")
        wmap, W32 = step_weights
        apply_w, W64 = wmap.apply_grid, W32.to(b.dtype)

    if step_weights is not None and cell_outer:
        if op is None:
            raise ValueError("the cell outer takes the step's float64 cell batch as op")
        A64, rhs, x0 = _constrained_system(op, b, mask, g)
    else:

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
        inner_custom, M32, inner_name = _step_inner_route(lattice32, mask_lat, wmap, W32, inner_iters)

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
        and fused_gate(lattice32)
        and (fused_mode() == "arnoldi" or (gmg.surrogate and op.ndof >= FUSED_ARNOLDI_MIN_DOFS))
    ):
        # the Arnoldi operator is the constrained system's own float32
        # weights, a kernel input: for a SURROGATE hierarchy (Helmholtz's
        # shifted Laplacian) never level 0; for an own-operator one
        # (PDEBENCH_TPU_FUSED=arnoldi) the weights of level 0, the
        # operator the reference's baked kernel applies
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


def _step_inner_route(lattice32, mask_lat: torch.Tensor, wmap, W32: torch.Tensor, inner_iters: int):
    """(inner_custom, M32, inner name) of a per-step operator's GMRES
    inner (the module docstring's per-step routes). The fused cycle is
    built once per hierarchy, offsets and m; the step's weights are
    constrained on their device at every call."""
    gmg = lattice32.gmg
    dev = lattice32.device
    kind = "cuda" if dev.type == "cuda" else "torch"
    if fused_mode() == "arnoldi" and fused_gate(lattice32):
        from .gmg_fused import build_fused_inner_gmres

        fg = _fused(
            gmg, ("gmres-step", inner_iters, tuple(wmap.offsets)),
            lambda: build_fused_inner_gmres(gmg, inner_iters, dev, wmap.offsets),
        )
        keep = (1.0 - mask_lat.to(torch.float32)).reshape(lattice32.grid_shape)
        W32c = constrain_step_weights(W32, wmap.offsets, keep)
        return (lambda r: fg(r, W32c)), None, f"fused-gmres-step-{kind}"
    if step_rich() and fused_gate(lattice32):
        from .gmg_fused import build_fused_richardson

        M32 = _fused(
            gmg, ("richardson", RICHARDSON_CYCLES),
            lambda: build_fused_richardson(gmg, RICHARDSON_CYCLES, dev),
        )
        return None, M32, f"gmres+fused-richardson-step-{kind}"
    # padded hierarchies whatever the switches (no kernel takes them)
    return None, _vcycle(lattice32), "gmres+vcycle"


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


def halo_requested() -> bool:
    """The stripe-partitioned route's gate: PDEBENCH_TPU_HALO=1 (the
    reference's switch) and a default process group of more than one rank
    (the analog of the reference's len(jax.devices()) > 1)."""
    import torch.distributed as dist

    return (
        os.environ.get("PDEBENCH_TPU_HALO", "0") == "1"
        and dist.is_available()
        and dist.is_initialized()
        and dist.get_world_size() > 1
    )


def _solve_halo_sharded(lat32, b, mask, g, rtol: float, atol: float, maxiter: int):
    """Stripe-partitioned constrained CG on the case's lattice operator.

    Splits the lattice's leading axis over the ranks of the default
    process group and runs Jacobi-PCG with a halo exchange an apply
    (parallel/halo.py) on the float64 weights W_f64 that the single-device
    refinement outer applies: each stripe apply is one launch of the
    stencil kernel on CUDA tensors, and the apply equals the whole-lattice
    one bit for bit; the dot products sum over ranks in another order.
    Returns (x on the host, info with "converged")."""
    from ..parallel.group import Group
    from ..parallel.halo import HaloStencilOperator, halo_pcg

    group = Group.from_default(b.device)
    hop = HaloStencilOperator.from_lattice_operator(lat32, group)
    emb = lat32.embedding
    gs = lat32.grid_shape
    b_g = emb.embed(b, 0.0).reshape(gs)
    g_g = emb.embed(g, 0.0).reshape(gs)
    mask_g = emb.embed(mask, True).reshape(gs)
    x_g, kinfo = halo_pcg(hop, b_g, mask_g, g_g, rtol=rtol, atol=atol, maxiter=maxiter)
    x = x_g.reshape(-1)[lat32.inv_j]
    return x.cpu().numpy(), {
        "converged": bool(kinfo.converged),
        "method": "cg",
        "pc_used": f"jacobi+halo-sharded[{group.size}]",
        "inner": "halo-cg",
        "iterations": int(kinfo.iterations),
        "residual": float(kinfo.residual),
        "halo_backend": group.describe(),
        "halo_exchange_s": group.exchange_s,
        "halo_reduce_s": group.reduce_s,
    }


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

    # explicit requests for the host LU, on every device: not fallbacks
    if force_direct():
        info["host_request"] = "PDEBENCH_TPU_FORCE_DIRECT=1"
        return _host_lu(op, b, mask, g, info)
    if use_direct and lat32 is not None and structured_lu_direct():
        info["host_request"] = "PDEBENCH_TPU_STRUCTURED_LU=direct"
        return _host_lu(op, b, mask, g, info)
    if lat32 is not None:
        fused_mode()  # PDEBENCH_TPU_FUSED=0 / none raises on every lattice route

    if lat32 is not None:
        rerouted = use_direct
        if use_direct:
            # structured preonly/lu: the stencil-GMG IR reaches the same
            # rtol far faster than a host LU; on CPU tensors the LU stays
            # the fallback
            info["direct_rerouted"] = "stencil-ir"
        if symmetric and halo_requested():
            try:
                x, hinfo = _solve_halo_sharded(lat32, b, mask, g, rtol, atol, maxiter)
            except Exception as e:  # the lattice too small for the ranks, etc.
                if on_card:
                    raise
                info["halo_failed"] = f"{type(e).__name__}: {e}"
            else:
                if hinfo.pop("converged"):
                    info.update(hinfo)
                    return x, info
                if on_card:
                    raise RuntimeError(
                        f"the stripe-partitioned CG did not converge on {b.device}: {hinfo} "
                        f"(rtol {rtol}, atol {atol})"
                    )
                info["halo_failed"] = hinfo
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
    return _host_lu(op, b, mask, g, info)


def _host_lu(op: LocalOperator, b, mask, g, info: Dict[str, Any]):
    """The host SuperLU solve of the constrained system; x on the host."""
    x = directmod.solve_direct_constrained(
        op.to_scipy(), b.cpu().numpy(), mask.cpu().numpy(), g.cpu().numpy()
    )
    info.update(method="lu", inner="host-lu", iterations=1)
    return x, info
