"""The port's multi-device module (pdebench_tpu_torch/parallel/) against the
JAX package's (pdebench_tpu/parallel/), on the CPU.

The JAX side runs on the conftest's 8 virtual devices (a Mesh over the
first n); the port side on n gloo ranks, one process each, through
parallel/group.launch. The same numpy inputs go through both. Spawning
ranks costs seconds, so the n = 4 checks share one launch (a module-scoped
fixture running several legs) and the dry run takes one of its own; n = 1
runs in this process with no process group.

Tolerances: an apply is held to the port's whole-lattice apply bit for bit
(the same kernel arithmetic per site) and to the JAX apply at the f64
stencil tests' 1e-12 of scale (XLA may contract a multiply-add); a solve
is held to its JAX twin and to the single-device route within 1e-7 of
scale where both stop at rtol 1e-10 or tighter, the bound of
tests/test_parallel.py's dataset-case test.

The launches run in a background thread while this process runs the JAX
side. Dispatch's halo route is held to the JAX package's halo route on
poisson_p2; on the 3-D and elasticity cases to the JAX package's
single-device route: its halo route traces and compiles its shard_map
anew on every solve, ~75 s a solve for the 3-D lattice on this CPU.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pdebench_tpu.fem.assemble import cell_batch, local_elasticity, local_stiffness
from pdebench_tpu.fem.mesh import unit_cube_mesh, unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.parallel import halo as ref_halo
from pdebench_tpu.parallel import sharded as ref_sharded
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu_torch.parallel import Group, HaloStencilOperator, launch
from pdebench_tpu_torch.parallel import dryrun
from pdebench_tpu_torch.solvers import stencil

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
RANKS = 4
TOL_APPLY_F64 = 1e-12  # the f64 stencil applies' figure (tests/test_torch_stencil.py)
TOL_ROUTE = 1e-7  # tests/test_parallel.py::test_halo_route_dataset_case_*


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), axis_names=(axis,))


def _case(cid, resolution=None):
    for line in open(DATA):
        c = json.loads(line)
        if c["id"] == cid:
            oc = c["oracle_config"]
            if resolution is not None:
                oc.setdefault("mesh", {})["resolution"] = resolution
            return oc
    raise KeyError(cid)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _grid_rel(a, b):
    ma, mb = np.isnan(a), np.isnan(b)
    assert (ma == mb).all()
    both = ~ma
    return float(np.linalg.norm(a[both] - b[both]) / np.linalg.norm(b[both]))


# -- the shared inputs (numpy, from the JAX package's assembly) -------------


def _poisson7():
    m = unit_square_mesh(7)
    V = FunctionSpace(m, 1)
    K = np.asarray(local_stiffness(cell_batch(m, 1)))
    u = np.random.default_rng(0).standard_normal(V.ndof)
    return K, V, u


def _scalar_lattice(mesh, degree):
    V = FunctionSpace(mesh, degree)
    K = np.asarray(local_stiffness(cell_batch(mesh, degree)))
    ref = ref_stencil.lattice_operator_from_local(K, V.dofmap_scalar, V.ndof, V.dof_coords)
    port = stencil.lattice_operator_from_local(K, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu")
    return ref, port, V, K


def _elasticity_lattice(n):
    m = unit_square_mesh(n)
    V = FunctionSpace(m, 1, ncomp=2)
    K = np.asarray(local_elasticity(cell_batch(m, 1), 1.0, 1.0))
    ref = ref_stencil.block_lattice_operator_from_local(K, V.dofmap, V.ndof, V.dof_coords, 2)
    port = stencil.block_lattice_operator_from_local(K, V.dofmap, V.ndof, V.dof_coords, 2, "cpu")
    return ref, port


APPLIES = {  # name -> (reference lattice op, port lattice op, seed)
    "p2_square12": lambda: _scalar_lattice(unit_square_mesh(12), 2)[:2] + (0,),
    "p1_cube5": lambda: _scalar_lattice(unit_cube_mesh(5), 1)[:2] + (1,),
    "elasticity12": lambda: _elasticity_lattice(12) + (2,),
}


def _apply_input(name):
    ref, port, seed = APPLIES[name]()
    u = np.random.default_rng(seed).standard_normal(port.grid_shape)
    return ref, port, u


def _pcg_system():
    """The reference test's halo PCG system: P1 on unit_square_mesh(14)."""
    m = unit_square_mesh(14)
    ref, port, V, _ = _scalar_lattice(m, 1)
    rng = np.random.default_rng(2)
    b_dof = rng.standard_normal(V.ndof)
    mask_dof = np.zeros(V.ndof, dtype=bool)
    mask_dof[V.boundary_scalar_dofs] = True
    emb = ref.embedding
    b = emb.embed_np(b_dof, 0.0).reshape(ref.shape)
    mask = emb.embed_np(mask_dof, True).reshape(ref.shape)
    g = np.zeros(ref.shape)
    return ref, port, b, mask, g


def _too_small():
    """poisson_basic at P3 on mesh resolution 2: a lattice of 7 rows, 2-row
    stripes on 4 ranks, under its halo of 3."""
    oc = _case("poisson_basic", 2)
    oc["fem"]["degree"] = 3
    return oc


ROUTE_CASES = {  # name -> (case id, mesh resolution, JAX route held to: halo or not)
    "poisson_p2": ("poisson_p2", 48, True),
    "poisson_3d_smooth_trig": ("poisson_3d_smooth_trig", 8, False),
    "linear_elasticity_exponential_gradients": ("linear_elasticity_exponential_gradients", 40,
                                                False),
}


@pytest.fixture(scope="module")
def pool():
    with ThreadPoolExecutor(2) as ex:
        yield ex


@pytest.fixture(scope="module")
def dryrun2(pool):
    """dryrun_multichip(2, "cpu"), started at once (a future)."""
    return pool.submit(dryrun.dryrun_multichip, 2, "cpu")


@pytest.fixture(scope="module")
def ranks4(pool, dryrun2):
    """Every n = 4 check of the port in one launch of 4 gloo ranks, run in
    the background: a future of {leg name: rank 0's result}."""
    K7, V7, u7 = _poisson7()
    legs = {"sharded": (dryrun.sharded_apply, (K7, V7.dofmap_scalar, V7.ndof, u7))}
    for name in APPLIES:
        _, port, u = _apply_input(name)
        legs[name] = (dryrun.halo_apply, (port.W_f64.numpy(), port.offsets,
                                          getattr(port, "ncomp", 1), u))
    _, port, b, mask, g = _pcg_system()
    legs["halo_pcg"] = (dryrun.halo_cg_solve, (port.W_f64.numpy(), port.offsets, 1, b, mask, g,
                                               1e-12))
    legs["poisson_cells"] = (dryrun.step_leg, ("poisson", 8))
    legs["elasticity_halo"] = (dryrun.step_leg, ("elasticity", 12))
    legs["stokes_halo"] = (dryrun.step_leg, ("stokes", 8, 1e-9))
    for name, (cid, res, _) in ROUTE_CASES.items():
        legs[f"route:{name}"] = (dryrun.oracle_solve, (_case(cid, res),))
    legs["too_small"] = (dryrun.oracle_solve, (_too_small(),))
    return pool.submit(lambda: dict(zip(legs, launch(dryrun.run_legs, RANKS, "cpu",
                                                      list(legs.values())))))


# -- (d) dispatch's halo route (first: its JAX solves overlap the launches) --


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_halo_route_matches_reference_and_single_device(name, ranks4, monkeypatch):
    from pdebench_tpu.oracle import OracleSolver as RefOracleSolver
    from pdebench_tpu_torch.oracle import OracleSolver

    cid, res, ref_halo_route = ROUTE_CASES[name]
    # the reference's 3-D CPU branch is AMG: pin its lattice route
    monkeypatch.setenv("PDEBENCH_TPU_FORCE_STENCIL", "1")
    if ref_halo_route:
        monkeypatch.setenv("PDEBENCH_TPU_HALO", "1")
    ref = RefOracleSolver().solve(_case(cid, res))
    monkeypatch.delenv("PDEBENCH_TPU_HALO", raising=False)
    want = "halo-sharded[8]" if ref_halo_route else "stencil-ir32"
    assert want in ref.solver_info["pc_used"], ref.solver_info
    single = OracleSolver(device="cpu").solve(_case(cid, res))
    assert "halo" not in single.solver_info.get("pc_used", "")
    got = ranks4.result()[f"route:{name}"]
    info = got["solver_info"]
    assert info["pc_used"] == f"jacobi+halo-sharded[{RANKS}]", info
    assert info["inner"] == "halo-cg" and info["halo_backend"] == "gloo"
    assert got["launches"] == [0] * RANKS  # CPU tensors: the plain version
    assert _grid_rel(got["grid"], ref.reference) < TOL_ROUTE
    assert _grid_rel(got["grid"], single.reference) < TOL_ROUTE
    assert got["baseline_error"] < 1e-2
    assert abs(got["baseline_error"] - single.baseline_error) <= 1e-6 * single.baseline_error


# -- (a) cell-parallel operator ----------------------------------------------


@pytest.mark.parametrize("n", [1, RANKS])
def test_sharded_operator_matches_reference(n, ranks4):
    K, V, u = _poisson7()
    ref = ref_sharded.ShardedOperator(K, V.dofmap_scalar, V.ndof, _mesh(n, "cells"))
    y_ref, d_ref = np.asarray(ref(jnp.asarray(u))), np.asarray(ref.diagonal())
    if n == 1:
        y, d = dryrun.sharded_apply(Group(0, 1, "cpu"), K, V.dofmap_scalar, V.ndof, u)
    else:
        y, d = ranks4.result()["sharded"]
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(d, d_ref, rtol=1e-12)


# -- (b) halo apply ------------------------------------------------------------


@pytest.mark.parametrize("name,n", [("p2_square12", 1), ("p2_square12", RANKS),
                                    ("p1_cube5", RANKS), ("elasticity12", RANKS)])
def test_halo_apply_matches_whole_lattice_and_reference(name, n, ranks4):
    ref, port, u = _apply_input(name)
    hop = ref_halo.HaloStencilOperator.from_lattice_operator(ref, _mesh(n, "stripe"))
    y_ref = np.asarray(hop.crop_grid(hop(hop.pad_grid(u))))
    if n == 1:
        got = dryrun.halo_apply(Group(0, 1, "cpu"), port.W_f64, port.offsets,
                                getattr(port, "ncomp", 1), u)
    else:
        got = ranks4.result()[name]
    y = got["y"]
    whole = port.apply_grid_w(port.W_f64, torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(y, whole)  # bit for bit
    assert got["launches"] == [0] * n  # CPU tensors: the plain version
    assert _rel(y, y_ref) <= TOL_APPLY_F64


# -- (c) the solves ------------------------------------------------------------


def test_halo_pcg_matches_reference(ranks4):
    ref, _, b, mask, g = _pcg_system()
    hop = ref_halo.HaloStencilOperator.from_lattice_operator(ref, _mesh(RANKS, "stripe"))
    x_ref, info = ref_halo.halo_pcg(hop, b, mask, g, rtol=1e-12)
    assert bool(info.converged)
    got = ranks4.result()["halo_pcg"]
    assert got["converged"]
    # both stop at rtol 1e-12: the reference test's 1e-9 of scale holds
    assert _rel(got["x"], x_ref) <= 1e-9
    assert abs(got["iterations"] - int(info.iterations)) <= 2


def test_sharded_poisson_step_matches_reference(ranks4):
    step, args = ref_sharded.sharded_poisson_step(8, _mesh(RANKS, "cells"))
    x, its, res = jax.jit(step)(*args)
    got = ranks4.result()["poisson_cells"]
    assert got["residual"] < 1e-6 and float(res) < 1e-6
    assert got["iterations"] == int(its)
    # the same Jacobi-PCG recurrence for 6 steps, sums in another order
    assert _rel(got["x"], x) <= 1e-10


def test_sharded_elasticity_step_matches_reference(ranks4):
    step, args = ref_halo.sharded_elasticity_step(12, _mesh(RANKS, "stripe"))
    x, its, res = jax.jit(step)(*args)
    got = ranks4.result()["elasticity_halo"]
    assert got["residual"] < 1e-6 and float(res) < 1e-6
    assert np.all(np.isfinite(got["x"]))
    # both stop at rtol 1e-8 of ||b||
    assert _rel(got["x"], x) <= 1e-6
    assert abs(got["iterations"] - int(its)) <= 2


def test_sharded_stokes_step_matches_reference_and_direct(ranks4):
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    from pdebench_tpu.fem import symbolic
    from pdebench_tpu.fem.assemble import (
        local_divergence,
        local_vector_laplacian,
        local_vector_load,
        scatter_add,
    )
    from pdebench_tpu.solvers.saddle_stencil import build_saddle_stencil

    n = 8
    step, (b_g, mask_g, g_g) = ref_halo.sharded_stokes_step(n, _mesh(RANKS, "stripe"), rtol=1e-9)
    x_twin, _, _ = jax.jit(step)(b_g, mask_g, g_g)

    # the independent reference of tests/test_parallel.py: the same
    # constrained saddle assembled in scipy and solved directly
    fmesh = unit_square_mesh(n)
    V = FunctionSpace(fmesh, 2, ncomp=2)
    Q = FunctionSpace(fmesh, 1)
    cb1 = cell_batch(fmesh, 1, qdegree=4)
    cb2 = cell_batch(fmesh, 2, qdegree=4)
    A_loc = np.asarray(local_vector_laplacian(cb2, 1.0))
    G_loc = np.asarray(local_divergence(cb2, np.asarray(cb1.phi)))
    n_u, n_p = V.ndof, Q.ndof
    N = n_u + n_p
    dmU, dmP = np.asarray(V.dofmap), np.asarray(Q.dofmap_scalar)
    _, nlu, nlp = G_loc.shape
    A = sps.coo_matrix((A_loc.reshape(-1), (np.repeat(dmU, nlu, axis=1).reshape(-1),
                                            np.tile(dmU, (1, nlu)).reshape(-1))), shape=(N, N))
    G = sps.coo_matrix((G_loc.reshape(-1), (np.repeat(dmU, nlp, axis=1).reshape(-1),
                                            (n_u + np.tile(dmP, (1, nlu))).reshape(-1))),
                       shape=(N, N))
    S = (A + G + G.T).tocsr()
    fx = symbolic.lambdify_spatial("2*pi**2*sin(pi*x)*sin(pi*y)", 2)
    fy = symbolic.lambdify_spatial("x*(1-x) + y*(1-y)", 2)
    qp = np.asarray(cb2.qpts)
    f_q = np.stack([fx(qp), fy(qp)], axis=-1)
    b_u = np.asarray(scatter_add(local_vector_load(cb2, jnp.asarray(f_q)),
                                 jnp.asarray(V.dofmap), n_u))
    b = np.concatenate([b_u, np.zeros(n_p)])
    mask = np.zeros(N, dtype=bool)
    bs = V.boundary_scalar_dofs
    mask[(bs[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)] = True
    mask[n_u] = True
    Sd = S.tolil()
    for i in np.nonzero(mask)[0]:
        Sd.rows[i] = [i]
        Sd.data[i] = [1.0]
    x_ref = spla.spsolve(Sd.tocsr(), np.where(mask, 0.0, b))

    sst = build_saddle_stencil(V, Q, G_loc)
    op = ref_halo.HaloSaddleOperator(sst, sst.wmapA.weights_np(A_loc), _mesh(RANKS, "stripe"))
    got = ranks4.result()["stokes_halo"]
    assert got["residual"] < 1e-6 and got["iterations"] > 0
    x_dof = op.extract_np(got["x"])
    assert np.abs(x_dof - x_ref).max() / np.abs(x_ref).max() < 1e-6
    # the JAX twin's MINRES stops at the same rtol 1e-9
    assert _rel(got["x"], np.asarray(x_twin)) < 1e-6


# -- (e) a lattice too small for the ranks -------------------------------------


def test_halo_rejects_too_many_devices():
    m = unit_square_mesh(3)
    V = FunctionSpace(m, 2)
    K = np.asarray(local_stiffness(cell_batch(m, 2)))
    lat = stencil.lattice_operator_from_local(K, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu")
    # the check runs before any collective: a group of 8 needs no processes
    with pytest.raises(ValueError, match="too small"):
        HaloStencilOperator.from_lattice_operator(lat, Group(0, 8, "cpu"))


# -- the ranks' devices and backend --------------------------------------------


@pytest.mark.parametrize("device,size,cards,devices,backend", [
    ("cpu", 4, 4, ["cpu"] * 4, "gloo"),
    ("cuda", 4, 4, [f"cuda:{r}" for r in range(4)], "nccl"),  # a card a rank
    ("cuda", 4, 1, ["cuda:0"] * 4, "gloo"),  # the ranks share the card
    ("cuda:0", 4, 4, ["cuda:0"] * 4, "gloo"),  # a named card: shared
    ("cuda:1", 2, 4, ["cuda:1"] * 2, "gloo"),
])
def test_backend_follows_the_ranks_devices(device, size, cards, devices, backend, monkeypatch):
    from pdebench_tpu_torch.parallel import group as grp

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert [str(grp.rank_device(device, r, size)) for r in range(size)] == devices
    assert grp.backend_for(device, size) == backend


def test_check_halo_route_holds_each_criterion():
    single = np.array([[1.0, 2.0], [np.nan, 4.0]])
    good = {"grid": single * (1 + 1e-9), "baseline_error": 1e-3, "launches": [3, 3],
            "device": "cuda", "solver_info": {"pc_used": "jacobi+halo-sharded[2]"}}
    assert dryrun.check_halo_route("c", good, single, 2) < dryrun.HALO_GRID_TOL
    bad = [dict(good, grid=single * 1.01), dict(good, baseline_error=0.1),
           dict(good, launches=[3, 0]), dict(good, solver_info={"pc_used": "jacobi"}),
           dict(good, grid=np.nan_to_num(single))]
    for got in bad:
        with pytest.raises(RuntimeError):
            dryrun.check_halo_route("c", got, single, 2)
    # no kernel on the CPU: its launches are not counted
    assert dryrun.check_halo_route("c", dict(good, launches=[0, 0], device="cpu"), single, 2) < 1e-7


# -- (f) a failed halo route on CPU tensors ------------------------------------


def test_halo_failure_on_cpu_is_recorded_and_the_solve_goes_on(ranks4):
    got = ranks4.result()["too_small"]
    info = got["solver_info"]
    assert info["halo_failed"].startswith("ValueError") and "too small" in info["halo_failed"]
    assert "halo" not in info["pc_used"] and info["inner"] != "halo-cg"
    assert np.all(np.isfinite(got["grid"]))


# -- (g) the dry run -----------------------------------------------------------


def test_dryrun_multichip_on_two_cpu_ranks(dryrun2):
    out = dryrun2.result()
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    for leg in ("poisson_p2", "poisson_3d"):
        assert out[leg]["pc_used"] == "jacobi+halo-sharded[2]"
        assert out[leg]["baseline_error"] < 1e-2
    for leg in ("poisson_cells", "elasticity_halo"):
        assert out[leg]["residual"] < 1e-6
    assert out["stokes_halo"]["residual"] < 1e-5
