"""The Burgers slice on the CPU: OracleSolver(device="cpu") against the
JAX reference on `burgers_square_v1` cut to P2 at resolution 36 (73 x 73
nodes, just above the hierarchy's size gate) and 2 steps, and at
resolution 8 (17 x 17 nodes), where no hierarchy attaches and both
packages take the cell-local step solve.

Both packages solve every step with per-step stencil weights W_const +
W(u_n) (the port's match the reference's bit for bit:
tests/test_torch_bilinear_weights.py) to the reference's hard-coded rtol
1e-8, GMRES(20) preconditioned by the constant part's V-cycle, and the
f64 outer converges to the operator of those float32 weights: grids,
errors and the iteration counts agree."""

import copy

import numpy as np
import torch

from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.oracle import OracleSolver
from test_torch_heat import GRID_TOL, case, compare

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)


def burgers_case(resolution, steps):
    cfg = case("burgers_square_v1", resolution)
    # no time block: t_final and dt (0.01 by default) set the steps
    cfg["pde"]["t_final"] = steps * cfg["pde"].get("dt", 0.01)
    return cfg


def test_burgers_case_matches_reference():
    res, ref = compare(burgers_case(36, 2), "burgers")
    info = res.solver_info
    assert info["inner"] == "gmres+vcycle"
    assert info["num_steps"] == ref.solver_info["num_steps"] == 2
    assert info["iterations"] == ref.solver_info["iterations"] == 20 * sum(info["outer_rounds"])
    assert (info["rtol"], info["ksp_type"]) == (ref.solver_info["rtol"], "gmres")


def test_no_hierarchy_takes_the_cell_local_route():
    """17 x 17 P2 nodes, below the hierarchy's size gate: both packages
    leave the lattice for the cell-local step solve (each step's cell
    batch on the device, the exact f64 cell apply as the outer, GMRES(60)
    with Jacobi); the iterations agree."""
    res, ref = compare(burgers_case(8, 2), "burgers")
    assert np.abs(res.reference - ref.reference).max() <= 1e-9 * np.abs(ref.reference).max()
    info = res.solver_info
    assert info["inner"] == "jacobi-gmres-ir"
    assert info["iterations"] == ref.solver_info["iterations"] == 60 * sum(info["outer_rounds"])


def test_above_the_bilinear_gate_matches_reference(monkeypatch):
    """Above the bilinear map's size gate (patched to 0 here; the
    reference's opt-out PDEBENCH_TPU_BURGERS_CONV=0 takes the same branch)
    each step's cell batch, assembled on the device, is cast to float32
    and summed into the step weights: GMRES(20) with the constant part's
    V-cycle as before, on the weights of the batch. The float32 weights
    are the step's operator (the outer converges to it), and the two
    packages sum them in other orders (the reference scatter-adds, the
    port sums in a fixed order), so the errors are held to 1e-5
    relative, not 1e-6 (measured here: 8e-6), the grids to GRID_TOL."""
    from pdebench_tpu_torch.oracle import scalar

    monkeypatch.setenv("PDEBENCH_TPU_BURGERS_CONV", "0")
    monkeypatch.setattr(scalar, "BILINEAR_MAX_ENTRIES", 0)
    cfg = burgers_case(36, 2)
    ref = RefOracle().solve(copy.deepcopy(cfg))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= 1e-5 * ref.baseline_error
    assert res.solver_info["inner"] == "gmres+vcycle" and "iterative_failed" not in res.solver_info
    assert res.solver_info["num_steps"] == ref.solver_info["num_steps"] == 2
