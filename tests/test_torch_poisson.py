"""The Poisson slice end to end on the CPU: OracleSolver of the port against
the JAX reference on dataset cases, and the dispatch routes around it.

The port's CPU route runs the fused inner solve's plain version (an extra
probed level with Jacobi sweeps), the reference's CPU route the stencil
PCG with a dense-inverse coarse solve: iteration counts may differ, the
converged grids may not (rtol 1e-10 in both)."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.fem import assemble
from pdebench_tpu_torch.fem.mesh import unit_square_mesh
from pdebench_tpu_torch.fem.spaces import FunctionSpace
from pdebench_tpu_torch.oracle import OracleSolver, base
from pdebench_tpu_torch.solvers import dispatch, gmg_fused, krylov, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-8  # relative L2 between the two packages' grids
ERR_TOL = 1e-6  # relative difference of baseline_error


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
    return res, ref


def test_poisson_basic_matches_reference():
    before = (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES)
    res, ref = _compare(_case("poisson_basic"))
    info = res.solver_info
    assert info["inner"] == "fused-cg-torch"
    assert info["pc_used"] == ref.solver_info["pc_used"] == "gmg+stencil-ir32"
    assert "iterative_failed" not in info
    assert abs(res.baseline_error - 1.924806820736457e-4) <= ERR_TOL * 1.924806820736457e-4
    # CPU tensors never launch a kernel
    assert (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES) == before


@pytest.mark.parametrize(
    "res_,degree,kappa",
    [
        (24, 2, {"type": "constant", "value": 2.0}),
        (10, 3, {"type": "expr", "expr": "1 + 0.3*sin(2*pi*x)*cos(2*pi*y)"}),
    ],
)
def test_small_lattice_jacobi_route_matches_reference(res_, degree, kappa):
    """Below 5,000 dofs no GMG is attached: Jacobi-preconditioned
    stencil PCG inner in both packages."""
    cfg = copy.deepcopy(_case("poisson_basic"))
    cfg["mesh"]["resolution"] = res_
    cfg["fem"]["degree"] = degree
    cfg["pde"]["coefficients"]["kappa"] = kappa
    res, ref = _compare(cfg)
    assert res.num_dofs < 5000
    assert res.solver_info["inner"] == "stencil-cg"
    assert res.solver_info["pc_used"] == "jacobi+stencil-ir32"


def test_padded_hierarchy_takes_stencil_cg():
    """res 75 P1: the GMG halving chain hits an even axis, the hierarchy
    is padded, the fused gate says no, the V-cycle preconditions a
    stencil PCG inner."""
    cfg = copy.deepcopy(_case("poisson_basic"))
    cfg["mesh"]["resolution"] = 75
    res, _ = _compare(cfg)
    assert res.solver_info["inner"] == "stencil-cg"
    assert res.solver_info["pc_used"] == "gmg+stencil-ir32"


def _small_system(n=12):
    mesh = unit_square_mesh(n)
    V = FunctionSpace(mesh, 1)
    cb = assemble.cell_batch(mesh, 1)
    K = torch.as_tensor(assemble.local_stiffness(cb))
    op = assemble.LocalOperator(K, V.dofmap_scalar, V.ndof)
    b = torch.ones(V.ndof, dtype=torch.float64) / V.ndof
    mask, g = assemble.bc_mask_values(
        V.ndof, V.boundary_scalar_dofs, np.zeros(len(V.boundary_scalar_dofs)), "cpu"
    )
    return V, cb, op, b, mask, g


def test_unconverged_ir_falls_through_to_host_lu(monkeypatch):
    from pdebench_tpu_torch.solvers.stencil import lattice_operator_from_local

    V, cb, op, b, mask, g = _small_system()
    lat = lattice_operator_from_local(
        op.A.numpy(), V.dofmap_scalar, V.ndof, V.dof_coords, "cpu", dtype=torch.float32
    )
    opts = base.solver_opts({"oracle_solver": {"ksp_type": "cg", "pc_type": "hypre"}})
    opts["_lattice32"] = lat
    x_ir, info_ir = dispatch.solve_linear(op, b, mask, g, dict(opts))
    assert info_ir["inner"] == "stencil-cg"

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 40, 1.0, False, "stencil-cg"

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    # first to the route off the lattice (below the AMG gate: Jacobi CG),
    # the lattice attempt kept in the record
    x, info = dispatch.solve_linear(op, b, mask, g, dict(opts))
    assert info["inner"] == "jacobi-cg" and info["method"] == "cg"
    assert info["iterative_failed"]["inner"] == "stencil-cg"
    np.testing.assert_allclose(x, x_ir, rtol=1e-8, atol=1e-12)

    # then, when that does not converge either, to the host LU
    def stalled_off(A, rhs, x0, M, method, rtol, atol, maxiter):
        return torch.zeros_like(rhs), krylov.KrylovInfo(maxiter, 1.0, False)

    monkeypatch.setattr(dispatch, "_krylov", stalled_off)
    x, info = dispatch.solve_linear(op, b, mask, g, dict(opts))
    assert info["inner"] == "host-lu" and info["method"] == "lu"
    assert info["iterative_failed"]["inner"] == "stencil-cg"
    assert info["iterative_failed_off_lattice"]["inner"] == "jacobi-cg"
    np.testing.assert_allclose(x, x_ir, rtol=1e-8, atol=1e-12)


def test_direct_and_unported_routes():
    V, cb, op, b, mask, g = _small_system()
    opts = base.solver_opts({"oracle_solver": {"ksp_type": "preonly", "pc_type": "lu"}})
    x, info = dispatch.solve_linear(op, b, mask, g, opts)
    assert info["inner"] == "host-lu"
    A = op.to_scipy().toarray()
    free = ~mask.numpy()
    np.testing.assert_allclose(
        A[np.ix_(free, free)] @ x[free], b.numpy()[free], rtol=1e-9, atol=1e-14
    )
    # the default options (cg, jacobi) off the lattice: float64 Jacobi CG,
    # the answer the LU gives
    x_j, info_j = dispatch.solve_linear(op, b, mask, g, base.solver_opts({}))
    assert info_j["inner"] == "jacobi-cg" and info_j["pc_used"] == "jacobi"
    np.testing.assert_allclose(x_j, x, rtol=1e-8, atol=1e-12)


def test_cg_matches_dense_solve():
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((40, 40))
    A = torch.as_tensor(Q @ Q.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal(40))
    diag = torch.diagonal(A)
    x, info = krylov.cg(lambda v: A @ v, b, M=krylov.jacobi_preconditioner(diag))
    assert info.converged and 0 < info.iterations < 40
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A.numpy(), b.numpy()), rtol=1e-8)

    # f32 inner + f64 outer reaches the f64 tolerance too
    A32 = A.float()
    x2, info2 = krylov.refined_solve(
        lambda v: A @ v, lambda v: A32 @ v, b,
        M32=krylov.jacobi_preconditioner(diag.float()), inner_iters=10,
    )
    assert info2.converged
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=1e-8)


def test_oracle_requires_device_and_rejects_unported():
    # the card unless the caller asks for the CPU; constructing touches no device
    assert OracleSolver().device.type == "cuda"
    assert OracleSolver(device="cpu").device.type == "cpu"
    cfg = copy.deepcopy(_case("poisson_basic"))
    cfg["pde"]["type"] = "darcy"
    cfg["pde"]["formulation"] = "no_such_formulation"
    with pytest.raises(NotImplementedError, match="unknown darcy formulation"):
        OracleSolver(device="cpu").solve(cfg)
    cfg["pde"]["type"] = "no_such_pde"
    with pytest.raises(ValueError):
        OracleSolver(device="cpu").solve(cfg)
    with pytest.raises(ValueError, match="unsupported complex domain"):
        base.build_mesh({"type": "no_such_domain"}, {"resolution": 8})
