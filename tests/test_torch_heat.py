"""The heat slice on the CPU: OracleSolver(device="cpu") of the port against
the JAX reference on dataset cases cut to 2-3 steps, and the pieces the
step loop adds (time parameters, time-dependent Dirichlet data, the f64
mass apply, the reference re-solve's config, the host-LU fallback).

The port's CPU route runs the plain versions of the kernels (kernel #2's
for the unpadded hierarchies: `fused-cg-torch`; the PyTorch V-cycle for
padded ones: `stencil-cg`); the reference's CPU route runs its XLA
V-cycle with a dense coarse solve. Both refine every step to rtol 1e-10,
so the grids are held to GRID_TOL and the errors to ERR_TOL, not the
iteration counts. 3-D cases pin the reference to its lattice route
(PDEBENCH_TPU_FORCE_STENCIL=1; its own CPU branch takes 3-D cases to AMG,
which the port does not have)."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pdebench_tpu.oracle.base as ref_base
import pdebench_tpu.oracle.heat as ref_heat
import pdebench_tpu.oracle.scalar as ref_scalar
from pdebench_tpu.fem import mesh as ref_mesh
from pdebench_tpu.fem.spaces import FunctionSpace as RefSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.fem import mesh as meshmod
from pdebench_tpu_torch.fem.assemble import cell_batch, local_mass
from pdebench_tpu_torch.fem.spaces import FunctionSpace
from pdebench_tpu_torch.oracle import OracleSolver, base, scalar
from pdebench_tpu_torch.solvers import dispatch, gmg_fused, stencil_kernel
from pdebench_tpu_torch.solvers.stencil import lattice_operator_from_local

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-7  # relative L2 between the two packages' grids
ERR_TOL = 1e-6  # relative difference of baseline_error


def case(case_id, resolution=None, steps=None, degree=None, ref_resolution=None):
    """A dataset case's config, its mesh resolution, element degree,
    number of steps (t_end = t0 + steps * dt) and reference_config's mesh
    resolution cut where given."""
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] == case_id:
                cfg = c["oracle_config"]
                break
        else:
            raise KeyError(case_id)
    if resolution is not None:
        cfg["mesh"]["resolution"] = resolution
    if degree is not None:
        cfg["fem"]["degree"] = degree
    if steps is not None:
        tc = cfg["pde"]["time"]
        tc["t_end"] = tc.get("t0", 0.0) + steps * tc["dt"]
    if ref_resolution is not None:
        cfg["reference_config"]["mesh"]["resolution"] = ref_resolution
    return cfg


def launches():
    return (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES, gmg_fused.LAUNCHES_RICHARDSON,
            gmg_fused.LAUNCHES_GMRES)


def compare(config, pde, monkeypatch=None):
    """Both packages on `config` (the reference pinned to its lattice route
    in 3-D): grids, errors, dofs; CPU tensors launch no kernel."""
    if monkeypatch is not None:
        monkeypatch.setenv("PDEBENCH_TPU_FORCE_STENCIL", "1")
    ref = RefOracle().solve(copy.deepcopy(config))
    before = launches()
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert launches() == before
    assert res.reference.shape == ref.reference.shape
    assert np.isfinite(res.reference).all()
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.num_dofs == ref.num_dofs
    assert res.solver_info["pde"] == pde and res.solver_info["device"] == "cpu"
    assert "iterative_failed" not in res.solver_info
    return res, ref


@pytest.mark.parametrize("pde", [
    {"time": {"t0": 0.0, "t_end": 0.1, "dt": 0.01}},
    {"time": {"t0": 0.05, "t_end": 0.12, "dt": 0.006}},
    {"time": {"t_end": 0.005, "dt": 0.001}},
    {"time": {"dt": 0.03}},
    {"t_final": 0.2, "dt": 0.04},
    {},
])
def test_time_params_match_reference(pde):
    assert base.time_params(pde) == ref_base.time_params(pde)


def test_dirichlet_traceable_later_segment_wins():
    """Two overlapping segments with different time-dependent values: the
    x0 side takes the later segment's value (the reference's g.at[].set
    loop), not the first as dirichlet_dofs_values keeps it."""
    bc = {"dirichlet": [{"on": "all", "value": "1 + t"}, {"on": "x0", "value": "x + 2*y + 3*t"}]}
    mesh = meshmod.unit_square_mesh(6, "triangle")
    space = FunctionSpace(mesh, 2)
    dofs, g_fn = base.dirichlet_traceable(space, bc, "cpu")
    rdofs, rg_fn = ref_base.dirichlet_traceable(RefSpace(ref_mesh.unit_square_mesh(6, "triangle"), 2), bc)
    np.testing.assert_array_equal(dofs, rdofs)
    left = space.boundary_dofs_on("x0")
    for t in (0.0, 0.37):
        g = g_fn(t)
        assert g.dtype == torch.float64 and g.shape == (space.ndof,)
        np.testing.assert_allclose(g.numpy(), np.asarray(rg_fn(t)), rtol=1e-12, atol=1e-12)
        y = space.dof_coords[left, 1]
        np.testing.assert_allclose(g.numpy()[left], 2 * y + 3 * t, rtol=1e-12, atol=1e-12)
    first_dofs, first_vals, _ = base.dirichlet_dofs_values(space, bc, t=0.37)
    np.testing.assert_allclose(first_vals[np.isin(first_dofs, left)], 1.37)


@pytest.mark.parametrize("cell, degree, n", [("triangle", 1, 9), ("triangle", 2, 5), ("tetrahedron", 1, 4)])
def test_mass_apply_matches_reference(cell, degree, n):
    """stencil_appliers64's f64 mass apply (the weight map and kernel #1's
    plain version) against the reference's, on P1 and P2 triangles and P1
    tetrahedra; the weights bit for bit (the same host bincount)."""
    import jax.numpy as jnp
    from pdebench_tpu.solvers.stencil import lattice_operator_from_local as ref_lattice
    from pdebench_tpu.solvers.stencil import lattice_weight_map as ref_wmap
    from pdebench_tpu_torch.solvers.stencil import lattice_weight_map

    mesh = meshmod.unit_square_mesh(n, cell) if cell == "triangle" else meshmod.unit_cube_mesh(n)
    space = FunctionSpace(mesh, degree)
    M = local_mass(cell_batch(mesh, degree))
    args = (M, space.dofmap_scalar, space.ndof, space.dof_coords)
    lat = lattice_operator_from_local(*args, device="cpu", dtype=torch.float32)
    rlat = ref_lattice(*args, dtype=jnp.float32)
    wm, rwm = lattice_weight_map(lat.lattice, space.dofmap_scalar), ref_wmap(rlat.lattice, space.dofmap_scalar)
    assert wm.offsets == rwm.offsets and wm.pad == rwm.pad
    np.testing.assert_array_equal(wm.weights_np(M), rwm.weights_np(M))
    v = np.random.default_rng(0).standard_normal(space.ndof)
    before = launches()
    got = scalar.stencil_appliers64(lat, space.dofmap_scalar, M)[0](torch.as_tensor(v))
    assert launches() == before
    want = np.asarray(ref_scalar.stencil_appliers64(rlat, space.dofmap_scalar, M)[0](jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    # and the cell-local apply it stands for
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_heat._apply_local(
        jnp.asarray(M), jnp.asarray(space.dofmap_scalar), space.ndof, jnp.asarray(v))),
        rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("ref_cfg", [
    {"mesh": {"resolution": 120}, "oracle_solver": {"rtol": 1e-12}},
    {"mesh": {"resolution": 120}, "time": {"dt": 0.001}},
])
def test_merge_reference_config_refine_dt(ref_cfg):
    cfg = case("heat_no_exact")
    cfg["reference_config"] = ref_cfg
    for refine_dt in (None, 0.01):
        got = scalar.merge_reference_config(copy.deepcopy(cfg), refine_dt=refine_dt)
        assert got == ref_scalar.merge_reference_config(copy.deepcopy(cfg), refine_dt=refine_dt)
    got = scalar.merge_reference_config(cfg, refine_dt=0.01)
    assert got["pde"]["time"]["dt"] == ref_cfg.get("time", {}).get("dt", 0.01)
    assert got["pde"]["time"]["t_end"] == cfg["pde"]["time"]["t_end"]


# (case, mesh resolution, steps, degree, the port's CPU inner, 3-D):
# 73^2 nodes halve to 37 and 19 (unpadded: kernel #2's plain version at 12
# PCG steps a round); 71^2 halves to an even 36 (padded: the PyTorch
# V-cycle); 21^3 P1 nodes halve to 11 (unpadded)
E2E = [
    ("heat_longer", 72, 2, None, "fused-cg-torch", False),
    ("heat_basic", 70, 2, None, "stencil-cg", False),
    ("heat_3d_basic_decay", 20, 2, 1, "fused-cg-torch", True),
]


@pytest.mark.parametrize("cid, res_, steps, degree, inner, three_d", E2E, ids=[e[0] for e in E2E])
def test_heat_case_matches_reference(cid, res_, steps, degree, inner, three_d, monkeypatch):
    res, ref = compare(case(cid, res_, steps, degree), "heat", monkeypatch if three_d else None)
    info = res.solver_info
    assert info["inner"] == inner
    assert info["num_steps"] == ref.solver_info["num_steps"] == steps
    assert len(info["outer_rounds"]) == steps and min(info["outer_rounds"]) >= 1
    # every lattice here has a hierarchy: 12 inner steps a round
    assert info["iterations"] == 12 * sum(info["outer_rounds"])


def test_heat_no_exact_case_matches_reference():
    """No exact solution: baseline_error is the distance to the re-solve
    that merge_reference_config(refine_dt=dt / 2) makes (P2 at
    reference_config's dt 0.01), so the whole re-solve is held against the
    reference's. Cut: 17^2 nodes (below the hierarchy's size gate: 30
    Jacobi-PCG steps a round), 2 steps; the re-solve's mesh to resolution
    12 (25^2 P2 nodes, 4 steps)."""
    res, ref = compare(case("heat_no_exact", 16, 2, ref_resolution=12), "heat")
    assert res.solver_info["inner"] == "stencil-cg"
    assert res.baseline_error > 0


def test_unconverged_step_takes_host_lu_on_cpu(monkeypatch):
    """Every step IR reports no convergence (both packages patched): the
    whole loop is solved again with the host SuperLU, and the port's grid
    matches the reference's direct result."""
    import jax.numpy as jnp

    real, ref_real = dispatch.solve_constrained_ir, ref_heat.solve_constrained_ir

    def unconverged(*a, **k):
        x, it, res, _, name = real(*a, **k)
        return x, it, res, False, name

    def ref_unconverged(*a, **k):
        x, it, res, _ = ref_real(*a, **k)
        return x, it, res, jnp.asarray(False)

    monkeypatch.setattr(dispatch, "solve_constrained_ir", unconverged)
    monkeypatch.setattr(ref_heat, "solve_constrained_ir", ref_unconverged)
    cfg = case("heat_longer", 16, 2)
    ref = RefOracle().solve(copy.deepcopy(cfg))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    assert ref.solver_info["fallback"] == res.solver_info["fallback"] == "direct"
    assert res.solver_info["inner"] == "host-lu"
    assert res.solver_info["iterative_failed"]["step"] == 1
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < 1e-12, gap
    assert abs(res.baseline_error - ref.baseline_error) <= 1e-10 * ref.baseline_error
