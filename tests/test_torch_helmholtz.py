"""The Helmholtz slice end to end on the CPU: OracleSolver of the port against
the JAX reference on dataset cases, and each route of the nonsymmetric
lattice dispatch on a small case.

The port's CPU route runs the plain versions of the fused Richardson
preconditioner or the fused Arnoldi cycle (an extra probed coarse level
with Jacobi sweeps); the reference's CPU route runs the XLA GMRES inner
with the dense-inverse V-cycle. Both refine to rtol 1e-10 on the
indefinite K - k^2 M, which amplifies the residual gap into the solution
more than Poisson's SPD operator does: the grids are held to 1e-7
relative (the gaps measured on the CPU on the three full-size cases:
1.4e-14 to 6.7e-13)."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-7  # relative L2 between the two packages' grids
ERR_TOL = 1e-6  # relative difference of baseline_error

# case -> (recorded baseline_error, results/oracle_sweep_progress.jsonl;
# the port's CPU inner)
FULL_SIZE = {
    "helmholtz_basic_k5": (6.517975839100497e-4, "gmres+fused-richardson-torch"),
    "helmholtz_k12_exponential_mode": (3.1268822007046e-4, "fused-gmres-torch"),
    "helmholtz_low_k2_polynomial": (3.6927099264136363e-4, "gmres+fused-richardson-torch"),
}


def _case(case_id):
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] == case_id:
                return c["oracle_config"]
    raise KeyError(case_id)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _compare(config):
    ref = RefOracle().solve(copy.deepcopy(config))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert res.reference.shape == ref.reference.shape
    assert np.isfinite(res.reference).all()
    assert _rel_l2(res.reference, ref.reference) < GRID_TOL
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.num_dofs == ref.num_dofs
    assert res.solver_info["pde"] == "helmholtz"
    return res, ref


@pytest.mark.parametrize("case_id", sorted(FULL_SIZE))
def test_full_size_case_matches_reference(case_id):
    recorded, inner = FULL_SIZE[case_id]
    before = (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES_RICHARDSON, gmg_fused.LAUNCHES_GMRES)
    res, ref = _compare(_case(case_id))
    info = res.solver_info
    assert info["inner"] == inner
    assert info["method"] == ref.solver_info["method"] == "gmres"
    assert info["pc_used"] == ref.solver_info["pc_used"] == "gmg+stencil-ir32"
    assert "iterative_failed" not in info
    assert abs(res.baseline_error - recorded) <= ERR_TOL * recorded
    # CPU tensors never launch a kernel
    assert (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES_RICHARDSON, gmg_fused.LAUNCHES_GMRES) == before


def _small(res_, k=5.0, degree=1, base="helmholtz_basic_k5"):
    cfg = copy.deepcopy(_case(base))
    cfg["mesh"]["resolution"] = res_
    cfg["fem"]["degree"] = degree
    cfg["pde"]["pde_params"]["k"] = k
    return cfg


@pytest.mark.parametrize(
    "res_,k,inner,pc",
    [
        # below 5,000 dofs: no hierarchy, Jacobi-preconditioned GMRES(60)
        (40, 5.0, "gmres+jacobi", "jacobi+stencil-ir32"),
        # 5,000 to 8,000 dofs: a hierarchy from the operator itself (no
        # surrogate) keeps the V-cycle in PyTorch ops
        (80, 5.0, "gmres+vcycle", "gmg+stencil-ir32"),
        # 91 x 91 lattice: halving lands on an even axis (46), the
        # surrogate hierarchy is identity-padded, out of the kernels' scope
        (90, 5.0, "gmres+vcycle", "gmg+stencil-ir32"),
        # k >= 16: the oracle takes the host LU before any solve
        (40, 16.0, "host-lu", None),
    ],
)
def test_small_case_routes_match_reference(res_, k, inner, pc):
    res, ref = _compare(_small(res_, k))
    assert res.solver_info["inner"] == inner
    if pc is None:
        assert res.solver_info["method"] == ref.solver_info["method"] == "lu"
        assert res.solver_info["ksp_type"] == "preonly"
    else:
        assert res.solver_info["pc_used"] == ref.solver_info["pc_used"] == pc


@pytest.mark.parametrize(
    "case_id,resolve,want",
    [
        # the case's own request (gmres/ilu) at k = 15 stays on the lattice
        ("helmholtz_no_exact_gaussian_source_k15", False, False),
        ("helmholtz_k15_two_mode_superposition", False, False),
        # preonly/lu re-solves the lattice IR answers stay there ...
        ("helmholtz_no_exact_sign_changing_rhs_k8", True, False),
        ("helmholtz_no_exact_nonzero_bc_k12", True, False),
        # ... from k = 15 on they take the host LU (the IR stalls at 15)
        ("helmholtz_no_exact_gaussian_source_k15", True, True),
        ("helmholtz_no_exact_two_gaussians_k18", True, True),
        # k >= 16 takes it whatever it asks; 3-D never
        ("helmholtz_direct_lu_k24_high_freq", False, True),
        ("helmholtz_3d_k6_high", False, False),
    ],
)
def test_host_lu_route_decision(case_id, resolve, want):
    """The route decision alone, on a dataset case's config or its
    reference re-solve's: no mesh, lattice or solve."""
    from pdebench_tpu_torch.oracle import base, helmholtz, scalar

    cfg = _case(case_id)
    if resolve:
        cfg = scalar.merge_reference_config(cfg)
    dim = 3 if cfg["domain"]["type"] == "unit_cube" else 2
    k = float(cfg["pde"]["pde_params"]["k"])
    assert helmholtz.host_lu_route(dim, k, base.solver_opts(cfg)) is want


def test_reference_config_resolve_matches_reference():
    """A case without a manufactured solution: baseline_error against a
    finer re-solve (here cut to res 24 P1 against res 32 P2)."""
    cfg = copy.deepcopy(_case("helmholtz_no_exact_sign_changing_rhs_k8"))
    assert "manufactured_solution" not in cfg["pde"]
    cfg["mesh"]["resolution"] = 24
    cfg["reference_config"]["mesh"]["resolution"] = 32
    res, ref = _compare(cfg)
    assert res.solver_info["inner"] == "gmres+jacobi"
    assert 0.0 < res.baseline_error < 1.0


def test_quadrilateral_case_matches_reference():
    """Q1 cells: 9-tap stencils; the surrogate hierarchy halves 101 -> 51
    -> 26: padded, so the PyTorch V-cycle."""
    cfg = _small(100, k=10.0, base="helmholtz_quadrilateral_k10_trig")
    res, _ = _compare(cfg)
    assert res.solver_info["inner"] == "gmres+vcycle"


def test_unconverged_ir_falls_through_to_host_lu_on_cpu(monkeypatch):
    """On CPU tensors an unconverged nonsymmetric lattice solve falls
    through to the route off the lattice (here, below 8,000 dofs, float64
    Jacobi GMRES); where that does not converge either, it ends in the host
    LU, recording both failures; the answer is the LU's."""
    from pdebench_tpu_torch.solvers import dispatch
    from pdebench_tpu_torch.solvers.krylov import KrylovInfo

    cfg = _small(40)
    want = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 40 * 60, 1.0, False, "gmres+jacobi"

    def stalled_off(A, rhs, x0, M, method, rtol, atol, maxiter):
        return torch.zeros_like(rhs), KrylovInfo(maxiter, 1.0, False)

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    monkeypatch.setattr(dispatch, "_krylov", stalled_off)
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    assert res.solver_info["inner"] == "host-lu"
    assert res.solver_info["iterative_failed"]["inner"] == "gmres+jacobi"
    assert res.solver_info["iterative_failed_off_lattice"]["inner"] == "jacobi-gmres"
    assert _rel_l2(res.reference, want.reference) < GRID_TOL
