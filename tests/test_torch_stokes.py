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


def test_without_gmg_parts_over_the_amg_gate_raises(monkeypatch):
    """3-D MINRES solves from AMG_MIN_DOFS dofs on take SA-AMG in the
    reference, which is not ported: NotImplementedError, and for a
    no-exact case whose re-solve is over the gate, before the case's own
    solve (the gate patched between the two sizes: 402 and 1,093 dofs)."""
    monkeypatch.setattr(stokes, "AMG_MIN_DOFS", 1000)
    runs = []
    run = stokes.StokesProblem.run
    monkeypatch.setattr(stokes.StokesProblem, "run", lambda self: runs.append(1) or run(self))
    with pytest.raises(NotImplementedError, match="SA-AMG"):
        OracleSolver(device="cpu").solve(case("stokes_3d_basic", 3))
    with pytest.raises(NotImplementedError, match="SA-AMG"):
        OracleSolver(device="cpu").solve(case("stokes_3d_body_force", 2, 3))
    assert not runs
    # a direct request without GMG parts takes the host LU at any size
    assert stokes.StokesProblem(case("stokes_3d_low_nu", 3), "cpu").route == "host-lu"


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
