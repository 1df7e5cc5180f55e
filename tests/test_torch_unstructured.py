"""The route off the lattice end to end on the CPU: OracleSolver of the port
against the JAX reference on small copies of dataset cases on the
signed-distance and periodic_square meshes (resolution cut to 12-90, a few
hundred to 9,000 dofs).

Both packages are pinned to one route. The reference's size gates are its
CPU ones, which the port keeps as module constants: PDEBENCH_TPU_AMG_MIN=0
and the port's AMG_MIN_DOFS = 0 send a small symmetric system to SA-AMG;
the nonsymmetric AMG route also needs the reference's host-direct gates
off (PDEBENCH_TPU_HOST_DIRECT_MAX=0, its platform read as "tpu") and the
port's HOST_LU_MAX_DOFS below the size. Grids agree within 1e-8 of their
largest magnitude, NaN outside the domain in both, and `baseline_error`
within 1e-6 relative; routes are compared by name, not by iteration
counts."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pdebench_tpu.solvers.dispatch as ref_dispatch
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.solvers import dispatch

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-8  # max |difference| over the grid's largest magnitude
MINRES_TOL = 1e-7  # a MINRES stopped at rtol 1e-10 against the host LU
ERR_TOL = 1e-6  # relative difference of baseline_error


def _case(case_id, resolution):
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = resolution
    return cfg


@pytest.fixture
def amg_everywhere(monkeypatch):
    """Both packages on SA-AMG whatever the size."""
    monkeypatch.setenv("PDEBENCH_TPU_AMG_MIN", "0")
    monkeypatch.setattr(dispatch, "AMG_MIN_DOFS", 0)


@pytest.fixture
def nonsymmetric_amg(amg_everywhere, monkeypatch):
    """... and nonsymmetric systems too: no host LU in either package."""
    monkeypatch.setenv("PDEBENCH_TPU_HOST_DIRECT_MAX", "0")
    monkeypatch.setattr(ref_dispatch, "_device_platform", lambda: "tpu")
    monkeypatch.setattr(dispatch, "HOST_LU_MAX_DOFS", 0)


def _compare(config):
    ref = RefOracle().solve(copy.deepcopy(config))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    got, want = res.reference, ref.reference
    assert got.shape == want.shape and res.num_dofs == ref.num_dofs
    outside = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), outside)
    assert np.isfinite(got[~outside]).all()
    scale = np.abs(want[~outside]).max()
    assert np.abs(got[~outside] - want[~outside]).max() <= GRID_TOL * scale
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert "iterative_failed" not in res.solver_info
    assert res.solver_info["pc_used"] == ref.solver_info["pc_used"]
    return res, ref


@pytest.mark.parametrize("case_id,resolution,inner,nan_outside", [
    # P2 on a distmesh circle, 859 dofs
    ("poisson_circle_sinsin", 16, "amg-cg-ir", True),
    # the split biharmonic's two solves, GMRES-IR (its gmres+ilu)
    ("biharmonic_circle_test_v1", 16, "amg-gmres-ir", True),
    # block-2 rigid-body AMG on a square with a circular hole, 1,204 dofs
    ("le_exp_multiconn_circle_hole", 12, "amg-cg-ir", True),
])
def test_symmetric_amg_route_matches_reference(amg_everywhere, case_id, resolution, inner, nan_outside):
    res, _ = _compare(_case(case_id, resolution))
    assert res.solver_info["inner"] == inner
    assert np.isnan(res.reference).any() == nan_outside


def test_periodic_square_jacobi_route_matches_reference():
    """periodic_square at resolution 16 (1,024 dofs, the periodic dofmap):
    below both packages' AMG gate, float64 Jacobi CG; no NaN on the grid."""
    res, ref = _compare(_case("poisson_periodic_trig", 16))
    assert res.solver_info["inner"] == "jacobi-cg" and ref.solver_info["pc_used"] == "jacobi"
    assert not np.isnan(res.reference).any()


def test_helmholtz_shifted_laplacian_amg_route_matches_reference(nonsymmetric_amg):
    """P1 on a square with a square hole at resolution 90 (9,047 dofs,
    over the 8,000 from which the oracle hands the AMG the shifted
    Laplacian K + k^2 M): FGMRES-IR with 60 inner steps, as on the card."""
    res, _ = _compare(_case("helmholtz_square_square_hole", 90))
    assert res.solver_info["inner"] == "amg-gmres-ir" and res.num_dofs >= 8000


def _off_lattice_case(case_id):
    """The five types that took no route off the lattice before the
    cell-local step loops and the last AMG preconditioners: cut to
    resolution 8-10 and 2-3 steps; the Stokes no-exact case's re-solve at
    P2-P1 and resolution 10, so that the port's re-solve (capped at P2-P1)
    and the reference's direct one solve the same problem."""
    cfg = _case(case_id, 8 if case_id.startswith("stokes") else 10)
    if "time" in cfg["pde"]:
        tc = cfg["pde"]["time"]
        tc["t_end"] = tc.get("t0", 0.0) + 3 * tc["dt"]
    elif case_id.startswith("burgers"):
        cfg["pde"]["t_final"] = 2 * cfg["pde"].get("dt", 0.01)
    if "reference_config" in cfg:
        cfg["reference_config"]["mesh"]["resolution"] = 10
        cfg["reference_config"]["fem"] = {"degree_u": 2, "degree_p": 1}
    return cfg


@pytest.mark.parametrize("case_id,inner", [
    # the host LU: the CPU branch of both packages up to 80,000 dofs
    ("wave_multiconn_circ_trig", "host-lu"),
    # the cell batch of every step on the device, GMRES(60) with Jacobi
    ("burgers_hole_v1", "jacobi-gmres-ir"),
    # the constant step matrix, CG(30) with Jacobi
    ("rd_square_hole_linear", "jacobi-cg-ir"),
    # steady and nonsymmetric: the host LU in both packages on the CPU
    ("convdiff_dumbbell_low_pe", "host-lu"),
    # MINRES with one SA-AMG V-cycle of the velocity block (the gate
    # patched to 0), held to the reference's host LU
    ("stokes_exp_multi_connected_off_center_source", "minres+amg"),
])
def test_off_lattice_types_take_their_routes(case_id, inner, monkeypatch):
    """Wave, Burgers, reaction-diffusion, convection-diffusion and the
    iterative Stokes solves off the lattice answer on the CPU, on the
    route the card takes or the reference's CPU branch, within GRID_TOL of
    the reference (Stokes: of its host LU, MINRES_TOL) and its
    baseline_error."""
    cfg = _off_lattice_case(case_id)
    ref_cfg, tol = copy.deepcopy(cfg), GRID_TOL
    if case_id.startswith("stokes"):
        from pdebench_tpu_torch.oracle import stokes

        monkeypatch.setattr(stokes, "AMG_MIN_DOFS", 0)
        for c in (ref_cfg, ref_cfg["reference_config"]):
            c["oracle_solver"] = {**ref_cfg["oracle_solver"], "ksp_type": "preonly", "pc_type": "lu"}
        tol = MINRES_TOL
    ref = RefOracle().solve(ref_cfg)
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    got, want = res.reference, ref.reference
    assert got.shape == want.shape and res.num_dofs == ref.num_dofs
    outside = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), outside)
    assert np.abs(got[~outside] - want[~outside]).max() <= tol * np.abs(want[~outside]).max()
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.solver_info["inner"] == inner and "iterative_failed" not in res.solver_info
