"""The Burgers slice on the CPU: OracleSolver(device="cpu") against the
JAX reference on `burgers_square_v1` cut to P2 at resolution 36 (73 x 73
nodes, just above the hierarchy's size gate) and 2 steps, and the
per-step lattice's refusal without a hierarchy.

Both packages solve every step with per-step stencil weights W_const +
W(u_n) (the port's match the reference's bit for bit:
tests/test_torch_bilinear_weights.py) to the reference's hard-coded rtol
1e-8, GMRES(20) preconditioned by the constant part's V-cycle, and the
f64 outer converges to the operator of those float32 weights: grids,
errors and the iteration counts agree."""

import copy

import pytest
import torch

from pdebench_tpu_torch.oracle import OracleSolver
from test_torch_heat import case, compare

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


def test_no_hierarchy_raises():
    """17 x 17 P2 nodes, below the hierarchy's size gate: the reference's
    cell-apply solve is not ported."""
    with pytest.raises(NotImplementedError, match="GMG hierarchy"):
        OracleSolver(device="cpu").solve(copy.deepcopy(burgers_case(8, 2)))
