"""`dispatch.solve_constrained`, the float64 Jacobi Krylov on cell-local
matrices, against the JAX reference's (pdebench_tpu/solvers/
dispatch.py:42-90), and the step loops that call it: heat and wave with a
non-CG ksp_type.

solve_constrained is held on a small constrained system (unit_square P1,
resolution 8, 81 dofs; the boundary dofs constrained to seeded values):
the SPD stiffness plus mass under CG, the stiffness plus an advection
under BiCGStab and GMRES(60). Both packages run the same recurrences in
float64 from the same start; their sums run in other orders, so x is held
to X_TOL and the iteration counts, which round-off does not move on
these systems, are equal.

Heat with ksp gmres solves every step with solve_constrained in both
packages (the reference on every platform). Wave with ksp gmres takes the
host LU on CPU tensors in both (the reference's CPU branch below 80,000
dofs); its device route, forced by patching the port's gate, is held to
that answer at WAVE_TOL (GMRES stops at rtol 1e-10 a step)."""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.solvers.dispatch import solve_constrained as ref_solve_constrained
from pdebench_tpu_torch.fem.assemble import LocalOperator
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.solvers import dispatch

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
X_TOL = 1e-10  # solve_constrained's x, max |diff| over max |x|
GRID_TOL = 1e-9  # max |diff| over the grid's largest magnitude
WAVE_TOL = 1e-7  # the device route against the host LU
ERR_TOL = 1e-6  # relative difference of baseline_error


def case(case_id, resolution, steps, ksp_type="gmres"):
    """A dataset case's config, its mesh resolution, number of steps
    (t_end = t0 + steps * dt) and ksp_type set."""
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = resolution
    tc = cfg["pde"]["time"]
    tc["t_end"] = tc.get("t0", 0.0) + steps * tc["dt"]
    cfg["oracle_solver"]["ksp_type"] = ksp_type
    return cfg


def grid_gap(got, want):
    """max |got - want| over max |want|, inside the domain; NaN alike."""
    outside = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), outside)
    return float(np.abs(got - want)[~outside].max() / np.abs(want)[~outside].max())


@pytest.fixture(scope="module")
def system():
    """(cell matrices by kind, dofmap, b, mask, g) of the small system."""
    mesh = unit_square_mesh(8)
    space = FunctionSpace(mesh, 1)
    cb = ref_assemble.cell_batch(mesh, 1)
    K = np.asarray(ref_assemble.local_stiffness(cb))
    M = np.asarray(ref_assemble.local_mass(cb))
    beta = np.broadcast_to(np.array([3.0, -2.0]), cb.qpts.shape)
    C = np.asarray(ref_assemble.local_advection(cb, beta))
    rng = np.random.default_rng(7)
    n = space.ndof
    mask = np.zeros(n, bool)
    mask[space.boundary_scalar_dofs] = True
    g = np.where(mask, rng.standard_normal(n), 0.0)
    b = rng.standard_normal(n)
    return {"spd": K + M, "nonsym": K + C}, space.dofmap_scalar, b, mask, g


@pytest.mark.parametrize("method,kind", [("cg", "spd"), ("bicgstab", "nonsym"), ("gmres", "nonsym")])
def test_solve_constrained_matches_reference(system, method, kind):
    A_loc, dofmap, b, mask, g = system
    A = A_loc[kind]
    n = b.shape[0]
    rtol, atol, maxiter = 1e-10, 1e-14, 2000
    x_ref, it_ref, res_ref, conv_ref = ref_solve_constrained(
        jnp.asarray(A), jnp.asarray(dofmap), jnp.asarray(b), jnp.asarray(mask), jnp.asarray(g),
        n, method, rtol, atol, maxiter,
    )
    t = lambda a: torch.as_tensor(np.asarray(a))
    x, its, res, conv = dispatch.solve_constrained(
        t(A), t(b), t(mask), t(g), method, rtol, atol, maxiter, dofmap=dofmap
    )
    x_ref = np.asarray(x_ref)
    assert conv and bool(conv_ref)
    assert its == int(it_ref) > 0
    assert x.dtype == torch.float64 and x.shape == (n,)
    assert np.abs(x.numpy() - x_ref).max() <= X_TOL * np.abs(x_ref).max()
    np.testing.assert_array_equal(x.numpy()[mask], g[mask])
    assert res <= max(rtol * np.linalg.norm(b), atol)
    # a LocalOperator gives the same solve, bit for bit
    x_op, its_op, _, _ = dispatch.solve_constrained(
        LocalOperator(t(A), dofmap, n), t(b), t(mask), t(g), method, rtol, atol, maxiter
    )
    assert its_op == its and torch.equal(x_op, x)


def test_heat_with_gmres_takes_solve_constrained():
    """heat_basic cut to resolution 16 and 2 steps, ksp gmres: every step
    a float64 Jacobi GMRES(60) on the cell-local operators, in both
    packages; the same iterations a step."""
    cfg = case("heat_basic", 16, 2)
    got = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    want = RefOracle().solve(copy.deepcopy(cfg))
    info = got.solver_info
    assert info["inner"] == "jacobi-gmres" and "iterative_failed" not in info
    assert "fallback" not in want.solver_info
    assert len(info["step_iterations"]) == info["num_steps"] == 2
    assert info["iterations"] == want.solver_info["iterations"]
    assert grid_gap(got.reference, want.reference) <= GRID_TOL
    assert abs(got.baseline_error - want.baseline_error) <= ERR_TOL * want.baseline_error


def test_wave_with_gmres_takes_host_lu_or_solve_constrained(monkeypatch):
    """wave_lshape_trig_cos cut to resolution 20 and 3 steps (P2, masked
    41^2 lattice), ksp gmres: the host LU on CPU tensors in both packages;
    with the port's host-LU gate at 0, every step by solve_constrained on
    the cell-local operators (the device route), held to the LU's answer."""
    cfg = case("wave_lshape_trig_cos", 20, 3)
    want = RefOracle().solve(copy.deepcopy(cfg))
    assert want.solver_info.get("fallback") == "direct"
    lu = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    assert lu.solver_info["inner"] == "host-lu" and lu.solver_info["host_lu"] == "cpu"
    assert grid_gap(lu.reference, want.reference) <= GRID_TOL
    monkeypatch.setattr(dispatch, "HOST_LU_MAX_DOFS", 0)
    got = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    info = got.solver_info
    assert info["inner"] == "jacobi-gmres" and "iterative_failed" not in info
    assert len(info["step_iterations"]) == 3 and min(info["step_iterations"]) > 0
    assert grid_gap(got.reference, want.reference) <= WAVE_TOL
    assert abs(got.baseline_error - want.baseline_error) <= ERR_TOL * want.baseline_error
