"""The Stokes oracle on the CPU: OracleSolver(device="cpu") of the port
against the JAX reference on dataset cases cut small, one per route, and
the route's refusals and fall-through.

The port takes the lattice-layout MINRES on every device; the reference
takes it only on the TPU, so it is pinned here with
PDEBENCH_TPU_SADDLE_LAT=1. The two velocity preconditioners differ (the
port's CPU route runs kernel #3's plain version, 2 V-cycles with a Jacobi
coarse solve; the reference's CPU route one XLA V-cycle with a dense
coarse solve), and so do the MINRES iteration counts: both reach rtol
1e-10, so the grids are held to GRID_TOL and the errors to ERR_TOL."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pdebench_tpu.oracle.base as ref_base
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.oracle import OracleSolver, stokes
from pdebench_tpu_torch.oracle import base as port_base
from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-7  # relative L2 between the two packages' grids
ERR_TOL = 1e-5  # relative difference of baseline_error


def case(case_id, resolution, ref_resolution=None):
    """A dataset case's config at a cut mesh resolution (and its
    reference_config's)."""
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] == case_id:
                cfg = c["oracle_config"]
                break
        else:
            raise KeyError(case_id)
    cfg["mesh"]["resolution"] = resolution
    if ref_resolution is not None:
        cfg["reference_config"]["mesh"]["resolution"] = ref_resolution
    return cfg


@pytest.fixture
def pinned(monkeypatch):
    """The reference on its lattice-layout MINRES; each package runs its
    timed solve once (the warm run repeats the cold one, and no test here
    reads a time)."""
    monkeypatch.setenv("PDEBENCH_TPU_SADDLE_LAT", "1")
    monkeypatch.setattr(ref_base, "_COLD", True)
    monkeypatch.setattr(port_base, "timed_run", lambda run, device: (run(), 0.0, 0.0))


def launches():
    return stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES_RICHARDSON


@pytest.mark.parametrize("case_id,resolution,ref_resolution,inner,layout", [
    # P2-P1, 49^2 velocity lattice (49/25/13): kernel #3's plain version
    ("stokes_basic", 24, None, "minres+fused-richardson-torch", "lattice"),
    # P3-P2: nesting ratio 3/2, flat vectors and the cell-based apply
    ("stokes_p3p2_taylor_hood", 8, None, "minres+fused-richardson-torch", "flat"),
    # no exact solution: 17^2 (no level above the dense coarse solve: one
    # PyTorch V-cycle), the re-solve at resolution 16 (33/17)
    ("stokes_no_exact_lid_driven_cavity", 8, 16, "minres+vcycle", "lattice"),
    # 3-D: no GMG parts, the diagonal preconditioner, the d = 3 block apply
    ("stokes_3d_basic", 2, None, "minres+diag", "flat"),
    # 3-D direct request without GMG parts: the host SuperLU
    ("stokes_3d_low_nu", 2, None, "host-lu", None),
])
def test_stokes_matches_reference(pinned, case_id, resolution, ref_resolution, inner, layout):
    config = case(case_id, resolution, ref_resolution)
    ref = RefOracle().solve(copy.deepcopy(config))
    before = launches()
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert launches() == before  # CPU tensors: the plain versions
    info = res.solver_info
    assert info["pde"] == "stokes" and info["device"] == "cpu"
    assert info["inner"] == inner and info.get("saddle_layout") == layout
    assert info.get("saddle_layout") == ref.solver_info.get("saddle_layout")
    assert info["method"] == ref.solver_info["method"] and "iterative_failed" not in info
    if layout is not None:
        assert info["restarts"] >= 1 and info["iterations"] > 0
    assert res.reference.shape == ref.reference.shape and np.isfinite(res.reference).all()
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.num_dofs == ref.num_dofs


def test_without_gmg_parts_over_the_amg_gate_takes_saddle_amg(monkeypatch):
    """3-D MINRES solves from AMG_MIN_DOFS dofs on take the saddle AMG
    preconditioner (one SA-AMG V-cycle of the velocity block), below it
    the diagonal one (the gate patched between stokes_3d_basic's sizes at
    resolutions 2 and 3: 402 and 1,093 dofs); the AMG route's grid and
    error held to the reference's host LU; a direct request without GMG
    parts takes the host LU at any size."""
    monkeypatch.setattr(stokes, "AMG_MIN_DOFS", 1000)
    assert stokes.StokesProblem(case("stokes_3d_basic", 2), "cpu").route == "minres+diag"
    config = case("stokes_3d_basic", 3)
    ref_cfg = copy.deepcopy(config)
    ref_cfg["oracle_solver"] = {**ref_cfg["oracle_solver"], "ksp_type": "preonly", "pc_type": "lu"}
    ref = RefOracle().solve(ref_cfg)
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    info = res.solver_info
    assert info["inner"] == "minres+amg" and res.num_dofs == ref.num_dofs == 1093
    assert "iterative_failed" not in info and "amg_failed" not in info
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    # a direct request without GMG parts takes the host LU at any size
    assert stokes.StokesProblem(case("stokes_3d_low_nu", 3), "cpu").route == "host-lu"


def test_saddle_amg_precond_matches_reference():
    """mixed.saddle_amg_precond on stokes_exp_multi_connected_off_center_source's
    P2-P1 spaces at resolution 24 (a distmesh square with a hole, 4,890
    velocity and 642 pressure dofs: two AMG levels above a dense 76 x 76
    coarse one), applied to a seeded vector in float64
    and in float32 (MINRES-IR's recurrence): within 1e-12 of the
    reference's, the constrained entries passed through."""
    import jax.numpy as jnp

    from pdebench_tpu.oracle.mixed import saddle_amg_precond as ref_precond
    from pdebench_tpu_torch.fem.assemble import local_vector_laplacian
    from pdebench_tpu_torch.oracle import mixed

    config = case("stokes_exp_multi_connected_off_center_source", 24)
    ctx = mixed.setup_taylor_hood(config, "cpu")
    V, Q, nu = ctx.V, ctx.Q, 0.7
    A_loc = local_vector_laplacian(ctx.cb, nu)
    mask = ctx.mask.numpy()
    args = (A_loc, ctx.cb, ctx.psi, V.dofmap, Q.dofmap_scalar, V.ndof, Q.ndof, nu, mask)
    M, failed = mixed.saddle_amg_precond(*args, "cpu")
    ref_M = ref_precond(*args)
    assert failed is None and (V.ndof, Q.ndof) == (4890, 642)
    r = np.random.default_rng(3).standard_normal(ctx.N)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        r_in = torch.as_tensor(r).to(dtype)
        got = M(r_in).numpy()
        want = np.asarray(ref_M(jnp.asarray(r_in.numpy())))
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
        np.testing.assert_array_equal(got[mask], r_in.numpy()[mask])


def test_unconverged_minres_on_cpu_takes_the_host_lu(pinned, monkeypatch):
    """MINRES capped at 5 iterations: on CPU tensors the solve records
    iterative_failed and returns the host LU's solution, the converged
    MINRES grid's to GRID_TOL."""
    config = case("stokes_basic", 8)
    want = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    monkeypatch.setattr(stokes, "MAXITER", 5)
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    info = res.solver_info
    assert info["method"] == "lu" and info["inner"] == "host-lu"
    failed = info["iterative_failed"]
    assert failed["inner"] == want.solver_info["inner"] == "minres+vcycle"
    assert failed["iterations"] == 5 and failed["restarts"] == 1
    gap = np.linalg.norm(res.reference - want.reference) / np.linalg.norm(want.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - want.baseline_error) <= ERR_TOL * want.baseline_error
