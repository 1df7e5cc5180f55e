"""The biharmonic slice on the CPU: OracleSolver(device="cpu") of the port
against the JAX reference on dataset cases at cut mesh resolutions (the
split formulation: two Poisson solves that share one lattice operator,
its hierarchy and its inner kernel object).

73^2 nodes halve to 37 and 19 (unpadded: kernel #2's plain version,
`fused-cg-torch`, 25 PCG steps a round); 71^2 halves to an even 36
(padded: the PyTorch V-cycle, `stencil-cg`). The reference's CPU route
runs its XLA V-cycle with a dense coarse solve, so the grids are held to
GRID_TOL and the errors to ERR_TOL, not the iteration counts."""

import pytest
import torch

from test_torch_heat import case, compare

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

# (case, mesh resolution cut from the dataset's, the port's CPU inner)
CASES = [
    ("biharmonic_polynomial_zero_bc", 72, "fused-cg-torch"),
    ("biharmonic_basic_sin", 70, "stencil-cg"),
]


@pytest.mark.parametrize("cid, res_, inner", CASES, ids=[c[0] for c in CASES])
def test_biharmonic_case_matches_reference(cid, res_, inner):
    res, ref = compare(case(cid, res_), "biharmonic")
    info = res.solver_info
    assert info["inner"] == inner
    assert info["method"] == ref.solver_info["method"] == "cg"
    assert info["pc_used"] == ref.solver_info["pc_used"] == "gmg+stencil-ir32"
    assert info["formulation"] == "split_mixed"
    # two solves of 25 steps a round, at least one round each
    assert info["iterations"] % 25 == 0 and info["iterations"] >= 50
