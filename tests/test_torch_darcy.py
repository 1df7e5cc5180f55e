"""Darcy on the CPU against the JAX reference: the copied H(div) spaces
(fem/hdiv.py), the elliptic form (Poisson's pipeline on the pressure,
the lattice refinement with the fused GMG-PCG inner's plain version) and
the mixed RT_k x DG_k forms (the host sparse LU in both packages), at the
configurations of the reference's own Darcy tests.

The mixed forms assemble the same host arrays in the same order and
factor them with the same SuperLU, so their grids agree to rounding; the
elliptic form's iterative solves stop at rtol 1e-10 in both packages,
their sums in other orders: every grid and error is held to TOL."""

import copy

import numpy as np
import pytest
import torch

from pdebench_tpu.fem import hdiv as ref_hdiv
from pdebench_tpu.fem.mesh import unit_square_mesh as ref_unit_square_mesh
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.fem import hdiv
from pdebench_tpu_torch.fem.mesh import unit_square_mesh
from pdebench_tpu_torch.oracle import OracleSolver

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

TOL = 1e-10  # grids (relative L2) and baseline errors (relative)


def darcy(formulation, resolution, fem, kappa):
    return {
        "pde": {
            "type": "darcy",
            "formulation": formulation,
            "coefficients": {"kappa": kappa},
            "manufactured_solution": {"p": "sin(pi*x)*sin(pi*y)"},
        },
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": resolution, "cell_type": "triangle"},
        "fem": fem,
        "bc": {"dirichlet": {"on": "all", "value": "0"}},
        "output": {"format": "npz", "field": "scalar",
                   "grid": {"bbox": [0, 1, 0, 1], "nx": 40, "ny": 40}},
        "oracle_solver": {"ksp_type": "cg", "pc_type": "jacobi", "rtol": 1e-10},
    }


LINEAR = {"type": "expr", "expr": "1 + 0.5*x"}
ONE = {"type": "constant", "value": 1.0}
# the reference's tests/test_mixed_pdes.py configurations: name -> (config,
# its solver_info["formulation"])
CASES = {
    "elliptic": (darcy("elliptic", 24, {"family": "Lagrange", "degree": 1}, LINEAR), "elliptic"),
    "rt0": (darcy("mixed", 16, {"family": "RT", "degree": 1}, ONE), "mixed_rt0_dg0"),
    "rt1": (darcy("mixed", 8, {"family": "RT", "degree_u": 2, "degree_p": 1}, ONE), "mixed_rt1_dg1"),
    "rt2": (darcy("mixed", 6, {"family": "RT", "degree_u": 3, "degree_p": 2}, LINEAR), "mixed_rt2_dg2"),
}


def _rel_l2(a, b):
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("k", [1, 2])
def test_hdiv_arrays_equal_reference(k):
    mesh, ref_mesh = unit_square_mesh(5), ref_unit_square_mesh(5)
    np.testing.assert_array_equal(mesh.coords, ref_mesh.coords)
    np.testing.assert_array_equal(mesh.cells, ref_mesh.cells)
    space, ref_space = hdiv.rt0_space(mesh), ref_hdiv.rt0_space(ref_mesh)
    for name in ("edge_verts", "cell_edges", "signs", "opposite", "edge_lengths",
                 "boundary_edges", "edge_midpoints", "edge_normals"):
        np.testing.assert_array_equal(getattr(space, name), getattr(ref_space, name), err_msg=name)
    kinv_c = 1.0 / (1.0 + mesh.coords[mesh.cells].mean(axis=1)[:, 0])
    for got, want in zip(hdiv.rt0_local_matrices(space, kinv_c),
                         ref_hdiv.rt0_local_matrices(ref_space, kinv_c)):
        np.testing.assert_array_equal(got, want)
    kinv = lambda pts: 1.0 / (1.0 + 0.5 * pts[..., 0])
    got, want = hdiv.rtk_assemble(space, kinv, k=k), ref_hdiv.rtk_assemble(ref_space, kinv, k=k)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for key in ("xq", "wq", "xc", "h", "area"):
        np.testing.assert_array_equal(got[3][key], want[3][key])
    u_fns = [lambda p: np.sin(p[:, 0]) * p[:, 1], lambda p: np.cos(p[:, 1])]
    for a, b in zip(hdiv.rtk_boundary_flux(space, u_fns, k=k),
                    ref_hdiv.rtk_boundary_flux(ref_space, u_fns, k=k)):
        np.testing.assert_array_equal(a, b)
    X = np.random.default_rng(0).uniform(-1, 1, (7, 2))
    for a, b in zip(hdiv.rtk_tabulate(k, X), ref_hdiv.rtk_tabulate(k, X)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_darcy_matches_reference(name):
    cfg, formulation = CASES[name]
    got = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    want = RefOracle().solve(copy.deepcopy(cfg))
    assert got.solver_info["formulation"] == want.solver_info["formulation"] == formulation
    assert got.num_dofs == want.num_dofs
    assert got.reference.shape == (40, 40)
    assert _rel_l2(got.reference, want.reference) <= TOL
    assert abs(got.baseline_error - want.baseline_error) <= TOL * want.baseline_error
    if name == "elliptic":
        # 625 dofs: no hierarchy, the lattice refinement with Jacobi
        assert got.solver_info["inner"] == "stencil-cg"
    else:
        assert got.solver_info["inner"] == "host-lu"
        assert got.solver_info["residual"] < 1e-12


def test_degree_pairing_and_formulation_errors():
    """An explicit degree_p other than degree_u - 1 raises, as in the
    reference; so do an unknown formulation and a permeability that is not
    positive."""
    cfg = darcy("mixed", 4, {"family": "RT", "degree_u": 2, "degree_p": 0}, ONE)
    for solver in (OracleSolver(device="cpu"), RefOracle()):
        with pytest.raises(NotImplementedError, match="stable RT_k"):
            solver.solve(copy.deepcopy(cfg))
    cfg = darcy("primal-dual", 4, {"family": "Lagrange", "degree": 1}, ONE)
    with pytest.raises(NotImplementedError, match="unknown darcy formulation"):
        OracleSolver(device="cpu").solve(cfg)
    for form, fem in (("elliptic", {"family": "Lagrange", "degree": 1}),
                      ("mixed", {"family": "RT", "degree": 1}),
                      ("mixed", {"family": "RT", "degree_u": 2})):
        cfg = darcy(form, 4, fem, {"type": "expr", "expr": "x - 0.5"})
        with pytest.raises(ValueError, match="strictly positive"):
            OracleSolver(device="cpu").solve(cfg)
