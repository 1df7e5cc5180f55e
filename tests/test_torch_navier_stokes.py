"""The port's Navier-Stokes oracle against the JAX reference on the CPU.

The forms, the block weight map and the f64 saddle stencil apply are held
to the reference's to 1e-12. End to end on the resolution-12 MMS case of
tests/test_mixed_pdes.py: the port's device Newton (its default on every
device; on CPU tensors kernel #5's plain version) against the reference
pinned to the same route (PDEBENCH_TPU_NS_DEVICE_NEWTON=1 with the
convected-hierarchy preconditioner, PDEBENCH_TPU_NS_CONV_M=hier), and the
port's host-LU Newton against the reference's CPU default: grid within
1e-7, baseline_error within 1e-8. Newton and Krylov counts may differ (an
inexact Newton sums in another order); the grid and the error may not."""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem.assemble import cell_batch as ref_cell_batch
from pdebench_tpu.fem.assemble import local_divergence as ref_local_divergence
from pdebench_tpu.fem.assemble import local_vector_laplacian as ref_local_vector_laplacian
from pdebench_tpu.fem.mesh import unit_square_mesh as ref_mesh
from pdebench_tpu.fem.refelem import element_tables as ref_tables
from pdebench_tpu.fem.refelem import tabulate as ref_tabulate
from pdebench_tpu.fem.spaces import FunctionSpace as RefSpace
from pdebench_tpu.oracle.navier_stokes import NavierStokesSolver as RefSolver
from pdebench_tpu.solvers.saddle_stencil import build_saddle_stencil as ref_build_sst
from pdebench_tpu.solvers.stencil import BlockLatticeWeightMap as RefWeightMap
from pdebench_tpu_torch.fem.assemble import (
    GatherSum,
    cell_batch,
    local_divergence,
    local_vector_laplacian,
    scatter_add,
)
from pdebench_tpu_torch.fem.mesh import unit_square_mesh
from pdebench_tpu_torch.fem.refelem import element_tables, tabulate
from pdebench_tpu_torch.fem.spaces import FunctionSpace
from pdebench_tpu_torch.oracle import OracleSolver, base, mixed
from pdebench_tpu_torch.oracle import navier_stokes as ns
from pdebench_tpu_torch.solvers.saddle_stencil import build_saddle_stencil
from pdebench_tpu_torch.solvers.stencil import BlockLatticeWeightMap, detect_lattice

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
TOL = 1e-12
GRID_TOL = 1e-7
ERR_TOL = 1e-8


def mms_config(resolution, nu, init="stokes"):
    """The MMS case of tests/test_mixed_pdes.py (Taylor-Green-like,
    divergence-free, P2-P1) at a given resolution and viscosity."""
    return {
        "pde": {
            "type": "navier_stokes",
            "pde_params": {"nu": nu},
            "manufactured_solution": {
                "u": ["pi*cos(pi*y)*sin(pi*x)", "-pi*cos(pi*x)*sin(pi*y)"],
                "p": "0",
            },
        },
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": resolution, "cell_type": "triangle"},
        "fem": {"degree_u": 2, "degree_p": 1},
        "bc": {"dirichlet": {"on": "all", "value": ["0", "0"]}},
        "output": {"format": "npz", "field": "velocity_magnitude",
                   "grid": {"bbox": [0, 1, 0, 1], "nx": 32, "ny": 32}},
        "oracle_solver": {"rtol": 1e-9, "atol": 1e-11, "max_it": 30, "init": init},
    }


def spaces(n, deg_u, cell_type="triangle"):
    """Both packages' Taylor-Hood pair and quadrature batch, and the
    pressure basis at the velocity quadrature points."""
    out = []
    for mesh_fn, space, cbf, tab, tables in (
        (ref_mesh, RefSpace, ref_cell_batch, ref_tabulate, ref_tables),
        (unit_square_mesh, FunctionSpace, cell_batch, tabulate, element_tables),
    ):
        mesh = mesh_fn(n, cell_type)
        V, Q = space(mesh, deg_u, ncomp=2), space(mesh, deg_u - 1)
        psi, _ = tab(mesh.cell_type, deg_u - 1, tables(mesh.cell_type, deg_u, 2 * deg_u + 2).qpoints)
        out.append((V, Q, cbf(mesh, deg_u), np.asarray(psi)))
    return out


@pytest.mark.parametrize("deg_u,cell_type", [(2, "triangle"), (3, "triangle"), (2, "quadrilateral")])
def test_taylor_hood_forms_match_reference(deg_u, cell_type):
    (_, _, cb_r, psi_r), (_, _, cb_p, psi_p) = spaces(4, deg_u, cell_type)
    np.testing.assert_allclose(
        local_vector_laplacian(cb_p, 0.3), np.asarray(ref_local_vector_laplacian(cb_r, 0.3)),
        rtol=TOL, atol=TOL,
    )
    # the reference's NS passes its pressure basis as a device array (the
    # general einsum); the affine GEMM path gives the same forms
    G_r = np.asarray(ref_local_divergence(cb_r, jnp.asarray(psi_r)))
    np.testing.assert_allclose(local_divergence(cb_p, psi_p), G_r, rtol=TOL, atol=TOL)


def test_block_weight_map_matches_reference():
    (V_r, _, _, _), (V_p, _, _, _) = spaces(5, 2)
    lat = detect_lattice(V_p.dof_coords)
    wm_r = RefWeightMap(lat, V_r.dofmap_scalar, 2)
    wm_p = BlockLatticeWeightMap(lat, V_p.dofmap_scalar, 2)
    assert wm_p.offsets == wm_r.offsets and wm_p.pad == wm_r.pad == 2
    rng = np.random.default_rng(0)
    A = rng.standard_normal((V_p.dofmap_scalar.shape[0], 12, 12))
    W_r = np.asarray(wm_r.weights(jnp.asarray(A)))
    W_p = wm_p.weights(torch.as_tensor(A))
    np.testing.assert_allclose(W_p.numpy(), W_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wm_p.weights_np(A), W_r, rtol=TOL, atol=TOL)
    # the same weights twice: the fixed summation order
    assert torch.equal(wm_p.weights(torch.as_tensor(A)), W_p)
    u = rng.standard_normal(lat.shape + (2,))
    np.testing.assert_allclose(
        wm_p.apply_grid(W_p, torch.as_tensor(u)).numpy(),
        np.asarray(wm_r.apply_grid(jnp.asarray(W_r), jnp.asarray(u))),
        rtol=TOL, atol=TOL * 10,
    )


def test_gather_sum_matches_scatter_add():
    (_, _, _, _), (V, _, _, _) = spaces(6, 2)
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(V.dofmap.shape))
    dm = torch.as_tensor(V.dofmap)
    got = GatherSum(V.dofmap, V.ndof, "cpu")(vals)
    np.testing.assert_allclose(got.numpy(), scatter_add(vals, dm, V.ndof).numpy(), rtol=TOL, atol=TOL)


def test_saddle_stencil_apply_matches_reference():
    """The f64 saddle apply (A block from per-step weights, G, G^T) against
    the reference's stencil apply and the port's cell-batched one."""
    (V_r, Q_r, cb_r, psi_r), (V_p, Q_p, cb_p, psi_p) = spaces(6, 2)
    G_loc = local_divergence(cb_p, psi_p)
    sst_r = ref_build_sst(V_r, Q_r, G_loc)
    sst_p = build_saddle_stencil(V_p, Q_p, G_loc)
    assert sst_p.offs_g == sst_r.offs_g and sst_p.offs_gt == sst_r.offs_gt
    rng = np.random.default_rng(3)
    A_loc = rng.standard_normal((G_loc.shape[0], 12, 12))
    x = rng.standard_normal(V_p.ndof + Q_p.ndof)
    WA_p = sst_p.wmapA.weights(torch.as_tensor(A_loc))
    y_p = sst_p.saddle_apply_w(WA_p)(torch.as_tensor(x)).numpy()
    y_r = np.asarray(sst_r.saddle_apply_w(sst_r.wmapA.weights(jnp.asarray(A_loc)))(jnp.asarray(x)))
    np.testing.assert_allclose(y_p, y_r, rtol=TOL, atol=TOL * np.abs(y_r).max())
    cell = mixed.saddle_apply(
        torch.as_tensor(A_loc), torch.as_tensor(G_loc), torch.as_tensor(V_p.dofmap),
        torch.as_tensor(Q_p.dofmap_scalar), GatherSum(V_p.dofmap, V_p.ndof, "cpu"),
        GatherSum(Q_p.dofmap_scalar, Q_p.ndof, "cpu"),
    )(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y_p, cell, rtol=TOL, atol=TOL * np.abs(cell).max())


def assert_same_solution(port, ref):
    diff = float(np.nanmax(np.abs(port.reference - ref.reference)))
    assert port.reference.shape == ref.reference.shape and np.isfinite(port.reference).all()
    assert diff < GRID_TOL, diff
    assert abs(port.baseline_error - ref.baseline_error) < ERR_TOL, (
        port.baseline_error, ref.baseline_error,
    )


def test_mms_device_newton_matches_reference(monkeypatch):
    cfg = mms_config(12, 0.5)
    port = OracleSolver("cpu").solve(cfg)
    info = port.solver_info
    assert info["inner"] == "newton-fgmres+fused-dyn-vcycle-torch", info
    assert info["device_newton"] and info["kry_its"] > 0 and info["residual"] < 1e-9
    monkeypatch.setenv("PDEBENCH_TPU_NS_DEVICE_NEWTON", "1")
    monkeypatch.setenv("PDEBENCH_TPU_NS_CONV_M", "hier")
    ref = RefSolver().solve(cfg)
    assert ref.solver_info["device_newton"], ref.solver_info
    assert_same_solution(port, ref)


@pytest.fixture(scope="module")
def ref_host_lu():
    """The reference's default (host-LU Newton) solve of the res-12 MMS
    case."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PDEBENCH_TPU_NS_DEVICE_NEWTON", raising=False)
        ref = RefSolver().solve(mms_config(12, 0.5))
    assert not ref.solver_info["device_newton"]
    return ref


def no_saddle_stencil(monkeypatch):
    """The no-stencil route of P3-P2 and P4-P3 lattices: host-LU Newton."""
    monkeypatch.setattr(ns, "build_saddle_stencil", lambda *a, **k: None)


def test_mms_host_lu_matches_reference(monkeypatch, ref_host_lu):
    no_saddle_stencil(monkeypatch)
    port = OracleSolver("cpu").solve(mms_config(12, 0.5))
    assert port.solver_info["inner"] == "newton-host-lu"
    assert not port.solver_info["device_newton"]
    assert_same_solution(port, ref_host_lu)


def test_padded_hierarchy_route_matches_host_lu(monkeypatch):
    """Resolution 21 (43 x 43 velocity nodes): 43 -> 22 is even, so level
    1 is identity-padded; the route is the PyTorch V-cycle, chosen before
    any solve, and lands on the host-LU solution."""
    cfg = mms_config(21, 0.5)
    prob = ns.NavierStokesProblem(cfg, "cpu")
    assert [sp.pad_to for sp in prob.spec.levels[:-1]] == [None, (23, 23)]
    assert prob.route == ns.ROUTE_DYN_VCYCLE and prob.fused is None
    port = OracleSolver("cpu").solve(cfg)
    assert port.solver_info["inner"] == ns.ROUTE_DYN_VCYCLE
    no_saddle_stencil(monkeypatch)
    lu = OracleSolver("cpu").solve(cfg)
    assert lu.solver_info["inner"] == "newton-host-lu"
    assert_same_solution(port, lu)


def test_device_linear_failure_falls_through_on_cpu(monkeypatch, ref_host_lu):
    """A device linear solve that cannot converge (GMRES(2), one round):
    on CPU tensors the solve falls through to the host-LU Newton, says so
    and lands on the reference's host-LU solution; on CUDA tensors it
    raises (tests/test_torch_kernels_cuda.py)."""
    monkeypatch.setattr(ns, "NS_INNER_ITERS", 2)
    monkeypatch.setattr(ns, "NS_MAX_OUTER", 1)
    cfg = mms_config(12, 0.5)
    res = OracleSolver("cpu").solve(cfg)
    info = res.solver_info
    assert info["inner"] == "newton-host-lu"
    assert "did not converge" in info["iterative_failed"] and "Newton step 0" in info["iterative_failed"]
    assert_same_solution(res, ref_host_lu)


# the Navier-Stokes dataset cases whose device linear solves raised on the
# H100 before the route rule (scripts/torch_sweep_cases.py --pde
# navier_stokes; PERF.md §6)
RAISED_ON_THE_CARD = {
    "navier_stokes_high_re", "navier_stokes_high_frequency_flow",
    "navier_stokes_low_nu_small_amplitude", "navier_stokes_exponential_stream",
    "navier_stokes_multiscale_stream", "navier_stokes_shear_layer_stream",
    "navier_stokes_quadrilateral_multiscale", "navier_stokes_two_vortices_gaussian_stream",
    "navier_stokes_tanh_x_shear_stream", "navier_stokes_sin3x2y_stream",
}


def test_route_rule_sends_the_stalling_lattices_to_the_host_lu():
    """host_lu_route over the 28 Navier-Stokes dataset configurations, no
    solve: every case that raised on the card takes the host LU, the two
    chip_smoke cases keep the device Newton; the route block decides it
    before any saddle stencil is built."""
    path = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
    cases = [json.loads(line) for line in path.read_text().splitlines()]
    cfgs = {c["id"]: c["oracle_config"] for c in cases
            if c["oracle_config"]["pde"]["type"] == "navier_stokes"}
    assert len(cfgs) == 28 and RAISED_ON_THE_CARD <= set(cfgs)
    def velocity_space(cfg):
        mesh = base.build_mesh(cfg["domain"], cfg.get("mesh", {}))
        return FunctionSpace(mesh, int(cfg.get("fem", {}).get("degree_u", 2)), ncomp=mesh.dim)

    host = {cid for cid, cfg in cfgs.items()
            if ns.host_lu_route(velocity_space(cfg), float(cfg["pde"]["pde_params"]["nu"]))}
    assert RAISED_ON_THE_CARD <= host
    assert not {"navier_stokes_basic", "navier_stokes_low_re"} & host
    # the two passing cases the rule also moves (velocity side 169 and 177,
    # nu 0.12 and 0.08); polynomial_stream_higher_degree (side 145, nu
    # 0.22) keeps the device Newton
    assert host - RAISED_ON_THE_CARD == {
        "navier_stokes_localized_vortex_gaussian", "navier_stokes_boundary_layer_stream",
    }
    prob = ns.NavierStokesProblem(cfgs["navier_stokes_high_re"], "cpu")
    assert prob.route == ns.ROUTE_HOST_LU and prob.sst is None and prob.spec is None


def test_ns_host_lu_fallback_retries_on_the_device(monkeypatch):
    """navier_stokes_high_re cut to resolution 12: the device Newton's
    linear solve stalls at its second step on the CPU (the plain kernel #5
    preconditioner), and the host-LU Newton it falls through to first
    retries each step on the device at rtol 1e-8, as the reference's
    fallback loop does (the reference pinned to its device Newton). The
    grids agree to rounding (2.6e-14 here; 1.6e-10 without the retry)."""
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == "navier_stokes_high_re")
    cfg["mesh"]["resolution"] = 12
    port = ns.NavierStokesSolver("cpu").solve(copy.deepcopy(cfg), _compute_baseline=False)
    info = port.solver_info
    assert info["inner"] == "newton-host-lu" and "Newton step 1" in info["iterative_failed"]
    assert info["device_retries"] >= 1
    monkeypatch.setenv("PDEBENCH_TPU_NS_DEVICE_NEWTON", "1")
    monkeypatch.setenv("PDEBENCH_TPU_NS_CONV_M", "hier")
    ref = RefSolver().solve(copy.deepcopy(cfg), _compute_baseline=False)
    assert float(np.nanmax(np.abs(port.reference - ref.reference))) < 1e-12
