"""The reaction-diffusion slice on the CPU: the reaction library against
the JAX reference's, and OracleSolver(device="cpu") against the reference
on dataset cases cut to 2 steps, just above the hierarchy's size gate
(P1 at resolution 72, P2 at 36: 73 x 73 nodes, 5,329 dofs).

Linear reactions take heat's step loop (kernel #2's plain version on the
unpadded hierarchy, `fused-cg-torch`; the reference's CPU route runs its
XLA V-cycle in PCG), both to the case's tolerance, so grids and errors are
compared, not iteration counts. Nonlinear reactions take the Newton loop
with per-step Jacobian weights on both sides (`gmres+vcycle`), whose
float32 step weights match the reference's bit for bit
(tests/test_torch_bilinear_weights.py): there the Newton and linear
iteration counts are compared too."""

import copy

import numpy as np
import pytest
import torch
import sympy as sp

import pdebench_tpu.oracle.reaction_diffusion as ref_rd
from pdebench_tpu_torch.oracle import OracleSolver, reaction_diffusion, scalar
from test_torch_heat import case, compare

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)


@pytest.mark.parametrize("reaction", [
    {"type": "linear", "alpha": 1.5},
    {"type": "cubic", "alpha": 0.5, "beta": 2.0},
    {"type": "poly3"},
    {"type": "allen_cahn", "lambda": 3.0},
    {"type": "allen-cahn", "lam": 0.5},
    {"type": "logistic", "rho": 2.0},
    {"type": "fisher_kpp"},
])
def test_reaction_expr_matches_reference(reaction):
    got, nonlinear = reaction_diffusion.reaction_expr(reaction)
    want, ref_nonlinear = ref_rd.reaction_expr(reaction)
    assert nonlinear == ref_nonlinear
    assert sp.simplify(got - want) == 0
    with pytest.raises(ValueError):
        reaction_diffusion.reaction_expr({"type": "no_such_reaction"})


# (case, mesh resolution, the port's CPU inner); 2 steps each
E2E = [
    ("reaction_diffusion_linear_basic", 72, "fused-cg-torch"),
    ("reaction_diffusion_cubic_manufactured", 72, "gmres+vcycle"),
    ("reaction_diffusion_allen_cahn_p2", 36, "gmres+vcycle"),
]


@pytest.mark.parametrize("cid, res_, inner", E2E, ids=[e[0] for e in E2E])
def test_reaction_diffusion_case_matches_reference(cid, res_, inner):
    res, ref = compare(case(cid, res_, 2), "reaction_diffusion")
    info = res.solver_info
    assert info["inner"] == inner
    assert info["num_steps"] == ref.solver_info["num_steps"] == 2
    assert info["method"] == ref.solver_info["method"]
    if not info["nonlinear"]:
        # 12 fused PCG steps a round, the reference's count on its own route
        assert info["iterations"] == 12 * sum(info["outer_rounds"])
        return
    assert info["jacobian_weights"] == "bilinear"
    assert len(info["newton_iterations"]) == 2 and min(info["newton_iterations"]) >= 1
    assert info["iterations"] == sum(info["linear_iterations"]) == ref.solver_info["iterations"]


def test_cell_batch_jacobian_matches_reference(monkeypatch):
    """Above the bilinear map's size gate (3e7 entries of T: the
    dataset's largest P2 re-solves; set to 0 here) the Jacobian's weights
    come from the cell batch with R'(u) at the quadrature points, summed
    in a fixed order; the reference, told to skip its bilinear map
    (PDEBENCH_TPU_RD_CONV=0), scatter-adds the same batch. Cut: P1 at
    resolution 72, 1 step."""
    monkeypatch.setattr(scalar, "BILINEAR_MAX_ENTRIES", 0)
    monkeypatch.setenv("PDEBENCH_TPU_RD_CONV", "0")
    res, ref = compare(case("reaction_diffusion_cubic_manufactured", 72, 1), "reaction_diffusion")
    info = res.solver_info
    assert info["jacobian_weights"] == "cell-batch" and info["inner"] == "gmres+vcycle"
    assert len(info["newton_iterations"]) == 1 and info["newton_iterations"][0] >= 1


def test_no_exact_case_matches_reference():
    """No exact solution: baseline_error is the distance to the re-solve
    of merge_reference_config(refine_dt=dt / 2) (P2, reference_config's
    oracle options: rtol 1e-12, max_it 80), so that whole re-solve, 4
    Newton steps, is held against the reference's. Cut: P1 at resolution
    72 and 2 steps; the re-solve's mesh to resolution 36."""
    res, ref = compare(
        case("reaction_diffusion_no_exact_gaussian_source_allen_cahn", 72, 2, ref_resolution=36),
        "reaction_diffusion",
    )
    assert res.solver_info["inner"] == "gmres+vcycle"
    assert res.baseline_error > 0


def test_no_hierarchy_takes_the_cell_local_route():
    """A nonlinear reaction below the hierarchy's size gate (17 x 17 P1
    nodes): both packages leave the lattice for the cell-local Newton
    solve (the Jacobian's cell batch with R' at the quadrature points,
    GMRES(60) with Jacobi); the Newton and linear iterations agree."""
    res, ref = compare(case("reaction_diffusion_cubic_manufactured", 16, 2), "reaction_diffusion")
    assert np.abs(res.reference - ref.reference).max() <= 1e-9 * np.abs(ref.reference).max()
    info = res.solver_info
    assert info["inner"] == "jacobi-gmres-ir" and info["jacobian_weights"] == "cell-local"
    assert info["iterations"] == ref.solver_info["iterations"] == sum(info["linear_iterations"])


def test_unconverged_newton_is_recorded_on_cpu():
    """A Newton step that stops above its tolerance (max_it 0: no
    iteration at all) does not raise on the CPU: the loop goes on and
    records the first such step, as the reference's scan does."""
    cfg = case("reaction_diffusion_cubic_manufactured", 72, 2)
    cfg["oracle_solver"]["max_it"] = 0
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    info = res.solver_info
    assert info["iterative_failed"]["step"] == 1
    assert info["newton_iterations"] == [0, 0] and info["iterations"] == 0
    assert np.isfinite(res.reference).all()
