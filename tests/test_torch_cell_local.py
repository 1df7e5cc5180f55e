"""The cell-local step loops on the CPU: `dispatch.solve_constrained_ir`
without a lattice, and OracleSolver(device="cpu") of the port against the
JAX reference on small copies of dataset cases on meshes whose dofs form
no lattice (distmesh circle and annulus, resolution 8-26, 2 steps).

Both packages run the same algorithm: the exact float64 cell apply as the
refinement's outer, the float32 cast as its inner's operator, Jacobi on
the float32 batch's constrained diagonal (or an AMG V-cycle built once),
CG(30) for a constant SPD step matrix, GMRES(60) for Burgers' per-step
matrix and the Newton Jacobians. Their sums run in other orders (the
port's in a fixed one, `GatherSum`), so the grids are held to GRID_TOL of
their largest magnitude, and the iteration counts, which round-off does
not move on these small systems, are equal.

Wave off the lattice takes the host SuperLU on CPU tensors in both
packages (the reference's CPU branch); its device route, forced here by
patching the port's gate, is held to that answer: the refinement stops at
rtol 1e-10 a step, so WAVE_TOL. Steady convection-diffusion's SPD
surrogate AMG is pinned in both packages as tests/test_torch_unstructured.py
pins the route off the lattice."""

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pdebench_tpu.solvers.dispatch as ref_dispatch
from pdebench_tpu.fem import geometry as ref_geometry
from pdebench_tpu.fem.spaces import FunctionSpace as RefSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.solvers.amg import setup_amg_masked_pair as ref_amg_pair
from pdebench_tpu_torch.fem import geometry
from pdebench_tpu_torch.fem.assemble import (
    LocalOperator,
    cell_batch,
    local_advection,
    local_mass,
    local_stiffness,
)
from pdebench_tpu_torch.fem.spaces import FunctionSpace
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.solvers import dispatch
from pdebench_tpu_torch.solvers.amg import setup_amg_masked_pair

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-9  # max |difference| over the grid's largest magnitude
SURROGATE_TOL = 1e-8  # the steady AMG route (an f64 retry-free FGMRES-IR)
WAVE_TOL = 1e-7  # the device route against the host LU
ERR_TOL = 1e-6  # relative difference of baseline_error
X_TOL = 1e-10  # solve_constrained_ir's solution, relative max


def case(case_id, resolution, steps=None):
    """A dataset case's config, its mesh resolution and number of steps
    cut (t_end = t0 + steps * dt, or Burgers' t_final = steps * dt)."""
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = resolution
    pde = cfg["pde"]
    if steps is not None and "time" in pde:
        tc = pde["time"]
        tc["t_end"] = tc.get("t0", 0.0) + steps * tc.get("dt", 0.01)
    elif steps is not None:
        pde["t_final"] = steps * pde.get("dt", 0.01)
    return cfg


def grid_gap(got, want):
    """max |got - want| over max |want|, inside the domain; NaN alike."""
    outside = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), outside)
    assert np.isfinite(got[~outside]).all()
    return np.abs(got[~outside] - want[~outside]).max() / np.abs(want[~outside]).max()


def compare(config, tol=GRID_TOL):
    ref = RefOracle().solve(copy.deepcopy(config))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert res.reference.shape == ref.reference.shape and res.num_dofs == ref.num_dofs
    assert grid_gap(res.reference, ref.reference) <= tol
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert "iterative_failed" not in res.solver_info
    return res.solver_info, ref.solver_info


# -- solve_constrained_ir without a lattice ---------------------------------


@pytest.fixture(scope="module")
def circle_system():
    """P1 on the distmesh circle at resolution 8 in both packages (the
    same mesh), M / dt + K and the advection by beta = (1, 0.5), boundary
    dofs constrained, a seeded right-hand side and boundary values."""
    dom = {"type": "circle", "geometry_params": {"center": [0.5, 0.5], "radius": 0.5}}
    mesh = geometry.mesh_domain("circle", dom, 1.0 / 8)
    ref_mesh = ref_geometry.mesh_domain("circle", dom, 1.0 / 8)
    V, rV = FunctionSpace(mesh, 1), RefSpace(ref_mesh, 1)
    cb = cell_batch(mesh, 1)
    np.testing.assert_array_equal(V.dofmap_scalar, rV.dofmap_scalar)
    beta = np.broadcast_to(np.array([1.0, 0.5]), cb.qpts.shape).copy()
    spd = 40.0 * local_mass(cb) + local_stiffness(cb)
    nonsym = spd + 8.0 * local_advection(cb, beta)
    rng = np.random.default_rng(0)
    mask = np.zeros(V.ndof, dtype=bool)
    mask[V.boundary_dofs_on("all")] = True
    b, g = rng.standard_normal(V.ndof), np.where(mask, rng.standard_normal(V.ndof), 0.0)
    return V, rV, spd, nonsym, mask, b, g


@pytest.mark.parametrize("matrix,inner,amg", [
    ("spd", "cg", False), ("nonsym", "gmres", False), ("spd", "cg", True),
])
def test_cell_local_ir_matches_reference(circle_system, matrix, inner, amg):
    """The cell-local form: the iterations equal, the solutions within
    X_TOL, the inner named by its preconditioner."""
    V, rV, spd, nonsym, mask, b, g = circle_system
    A = spd if matrix == "spd" else nonsym
    n_inner = 30 if inner == "cg" else 60
    M32 = rM32 = None
    if amg:
        _, M32, _ = setup_amg_masked_pair(
            LocalOperator(torch.as_tensor(A), V.dofmap_scalar, V.ndof).to_scipy(), mask)
        _, rM32 = ref_amg_pair(
            LocalOperator(torch.as_tensor(A), V.dofmap_scalar, V.ndof).to_scipy(), mask)
    op = LocalOperator(torch.as_tensor(A), V.dofmap_scalar, V.ndof)
    t = torch.as_tensor
    x, its, res, conv, name = dispatch.solve_constrained_ir(
        op, t(b), t(mask), t(g), None, 1e-10, 1e-14,
        inner=inner, inner_iters=n_inner, max_outer=60, M32_custom=M32,
    )
    j = jax.numpy.asarray
    rx, rits, rres, rconv = jax.jit(lambda bb: ref_dispatch.solve_constrained_ir(
        j(A), j(A).astype(jax.numpy.float32), j(rV.dofmap_scalar), bb, j(mask), j(g), rV.ndof,
        1e-10, 1e-14, inner_iters=n_inner, max_outer=60, inner=inner, M32_custom=rM32,
    ))(j(b))
    assert name == f"{'amg' if amg else 'jacobi'}-{inner}-ir"
    assert conv and bool(rconv) and its == int(rits) > 0
    rx = np.asarray(rx)
    assert np.abs(x.numpy() - rx).max() <= X_TOL * np.abs(rx).max()


# -- the oracles off the lattice ---------------------------------------------


def test_burgers_circle_matches_reference():
    """burgers_circle_v1 at resolution 10 (P2, 318 dofs), 2 steps: the
    cell batch of every step on the device, GMRES(60) with Jacobi."""
    info, ref_info = compare(case("burgers_circle_v1", 10, 2))
    assert info["inner"] == "jacobi-gmres-ir"
    assert info["iterations"] == ref_info["iterations"] == 60 * sum(info["outer_rounds"])


def test_newton_circle_matches_reference():
    """rd_circle_allencahn at resolution 10 (P1, 362 dofs), 2 steps: the
    Newton Jacobian's cell batch with R' at the quadrature points."""
    info, ref_info = compare(case("rd_circle_allencahn", 10, 2))
    assert info["inner"] == "jacobi-gmres-ir" and info["jacobian_weights"] == "cell-local"
    assert info["iterations"] == ref_info["iterations"] == sum(info["linear_iterations"])
    assert info["newton_iterations"] == [2, 2]


def test_transient_convection_diffusion_off_the_lattice_matches_reference():
    """convdiff_annulus_axial_flow at resolution 8 (P2) made transient (2
    steps of dt 0.01 from its MMS solution): heat's loop on the cell-local
    M + dt A, GMRES(60) with Jacobi."""
    cfg = case("convdiff_annulus_axial_flow", 8)
    cfg["pde"]["time"] = {"t0": 0.0, "t_end": 0.02, "dt": 0.01}
    info, ref_info = compare(cfg)
    assert info["inner"] == "jacobi-gmres-ir" and info["num_steps"] == 2
    assert info["iterations"] == ref_info["iterations"] == 60 * sum(info["outer_rounds"])


def test_steady_convection_diffusion_spd_surrogate_matches_reference(monkeypatch):
    """convdiff_annulus_diag_supg at resolution 26 (P2, 9,006 dofs, over the
    8,000 below which both packages take Jacobi GMRES): SA-AMG on eps K +
    SUPG(eps = 0), FGMRES-IR; both packages' AMG gates at 0 and their host
    LU gates off."""
    monkeypatch.setenv("PDEBENCH_TPU_AMG_MIN", "0")
    monkeypatch.setenv("PDEBENCH_TPU_HOST_DIRECT_MAX", "0")
    monkeypatch.setattr(ref_dispatch, "_device_platform", lambda: "tpu")
    monkeypatch.setattr(dispatch, "AMG_MIN_DOFS", 0)
    monkeypatch.setattr(dispatch, "HOST_LU_MAX_DOFS", 0)
    info, ref_info = compare(case("convdiff_annulus_diag_supg", 26), SURROGATE_TOL)
    assert info["inner"] == "amg-gmres-ir" and info["pc_used"] == ref_info["pc_used"] == "amg+ir32"


# -- wave --------------------------------------------------------------------


@pytest.fixture(scope="module")
def wave_reference():
    """wave_annulus_trig at resolution 10 (P2, 1,021 dofs), 3 steps: the
    reference's answer, its host-LU loop (its CPU branch)."""
    cfg = case("wave_annulus_trig", 10, 3)
    ref = RefOracle().solve(copy.deepcopy(cfg))
    assert ref.solver_info["fallback"] == "direct"
    return cfg, ref


def test_wave_host_lu_matches_reference(wave_reference):
    cfg, ref = wave_reference
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    assert res.solver_info["inner"] == "host-lu" and res.solver_info["host_lu"] == "cpu"
    assert grid_gap(res.reference, ref.reference) <= 1e-11
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error


@pytest.mark.parametrize("amg", [False, True])
def test_wave_device_route_matches_host_lu(wave_reference, monkeypatch, amg):
    """The card's route on CPU tensors (the host-LU gate patched to 0):
    Jacobi CG-IR, 30 steps a round, or, with the AMG gate at 0, CG-IR with
    the float32 AMG V-cycle of the step matrix, 12 steps a round."""
    cfg, ref = wave_reference
    monkeypatch.setattr(dispatch, "HOST_LU_MAX_DOFS", 0)
    if amg:
        monkeypatch.setattr(dispatch, "AMG_MIN_DOFS", 0)
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    info = res.solver_info
    assert info["inner"] == ("amg-cg-ir" if amg else "jacobi-cg-ir")
    assert "iterative_failed" not in info and len(info["outer_rounds"]) == 3
    assert info["iterations"] == (12 if amg else 30) * sum(info["outer_rounds"])
    assert grid_gap(res.reference, ref.reference) <= WAVE_TOL
