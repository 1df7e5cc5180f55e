"""Hyperelasticity and Cahn-Hilliard on the CPU against the JAX
reference, at the configurations of the reference's own tests
(tests/test_northstar_pdes.py), with that test's assertions on the port.

Hyperelasticity: the same Newton-CG on the same energy, 200 CG steps a
Newton step, the same line search; the port takes the gradient and the
quadrature-point tangent by torch.func and assembles them in a fixed
order, the reference differentiates through its gather, so the sums run
in other orders. Cahn-Hilliard: the same Newton on (c, mu), each step's
linear solve by solve_constrained's Jacobi GMRES(60) from the same
seeded random state. Both are held to GRID_TOL, with the Newton
iteration counts equal."""

import copy

import numpy as np
import pytest
import torch

from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.oracle import OracleSolver

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

GRID_TOL = 1e-8  # relative L2 between the two packages' grids

SMALL_STRAIN = {
    "domain": {"type": "unit_square"},
    "mesh": {"resolution": 12, "cell_type": "triangle"},
    "fem": {"family": "Lagrange", "degree": 1},
    "bc": {"dirichlet": {"on": "all", "value": ["0", "0"]}},
    "output": {"format": "npz", "field": "displacement_magnitude",
               "grid": {"bbox": [0, 1, 0, 1], "nx": 24, "ny": 24}},
    "oracle_solver": {"rtol": 1e-10, "atol": 1e-13, "max_it": 30},
    "pde": {"type": "hyperelasticity", "pde_params": {"E": 10.0, "nu": 0.3},
            "body_force": ["1e-3*sin(pi*x)*sin(pi*y)", "0"]},
}
STRETCH = {
    "pde": {"type": "hyperelasticity", "pde_params": {"E": 1.0, "nu": 0.3},
            "body_force": ["0", "0"]},
    "domain": {"type": "unit_square"},
    "mesh": {"resolution": 10, "cell_type": "triangle"},
    "fem": {"family": "Lagrange", "degree": 1},
    "bc": {"dirichlet": [{"on": "x0", "value": ["0", "0"]}, {"on": "x1", "value": ["0.2", "0"]}]},
    "output": {"field": "displacement_magnitude",
               "grid": {"bbox": [0, 1, 0, 1], "nx": 20, "ny": 20}},
    "oracle_solver": {"rtol": 1e-9, "max_it": 40},
}
CAHN_HILLIARD = {
    "pde": {"type": "cahn_hilliard", "pde_params": {"lambda": 1e-2, "M": 1.0},
            "time": {"t0": 0.0, "t_end": 5e-5, "dt": 5e-6},
            "initial_condition": "random", "seed": 3},
    "domain": {"type": "unit_square"},
    "mesh": {"resolution": 16, "cell_type": "triangle"},
    "fem": {"family": "Lagrange", "degree": 1},
    "bc": {},
    "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 24, "ny": 24}},
    "oracle_solver": {"rtol": 1e-8},
}
CASES = {"small_strain": SMALL_STRAIN, "stretch": STRETCH, "cahn_hilliard": CAHN_HILLIARD}


def _rel_l2(a, b):
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def solved():
    return {
        name: (OracleSolver(device="cpu").solve(copy.deepcopy(cfg)), RefOracle().solve(copy.deepcopy(cfg)))
        for name, cfg in CASES.items()
    }


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(solved, name):
    got, want = solved[name]
    assert got.num_dofs == want.num_dofs
    assert _rel_l2(got.reference, want.reference) < GRID_TOL
    key = "newton_iterations" if name == "cahn_hilliard" else "iterations"
    assert got.solver_info[key] == want.solver_info[key] > 0


def test_hyperelasticity_asserts_as_the_reference_does(solved):
    """The reference test's checks on the port: Newton converges, the
    stretch peaks at the pulled face, and a tiny load stays within 2e-2 of
    linear elasticity."""
    got, _ = solved["stretch"]
    assert got.solver_info["method"].startswith("newton") and got.solver_info["inner"] == "newton-cg(autodiff)"
    assert np.isfinite(got.reference).all() and got.solver_info["residual"] < 1e-6
    assert abs(np.nanmax(got.reference) - 0.2) < 0.02
    hyper, _ = solved["small_strain"]
    linear = copy.deepcopy(SMALL_STRAIN)
    linear["pde"] = {"type": "linear_elasticity", "pde_params": {"E": 10.0, "nu": 0.3},
                     "source_term": ["1e-3*sin(pi*x)*sin(pi*y)", "0"]}
    rl = OracleSolver(device="cpu").solve(linear)
    assert _rel_l2(hyper.reference, rl.reference) < 2e-2


def test_cahn_hilliard_asserts_as_the_reference_does(solved):
    """Mass conserved about the random start's 0.63, bounded, the last
    Newton residual below 1e-8; one GMRES solve a Newton iteration."""
    got, _ = solved["cahn_hilliard"]
    info = got.solver_info
    assert np.isfinite(got.reference).all()
    assert abs(np.nanmean(got.reference) - 0.63) < 0.02
    assert np.nanmin(got.reference) > -0.5 and np.nanmax(got.reference) < 1.5
    assert info["residual"] < 1e-8 and info["inner"] == "jacobi-gmres"
    assert len(info["newton_per_step"]) == info["num_steps"] == 10
    assert sum(info["newton_per_step"]) == info["newton_iterations"]
    assert all(its > 0 for its in info["linear_iterations"])
