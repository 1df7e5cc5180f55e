"""The wave slice on the CPU: the masked l_shape and t_junction lattices
of the rectilinear mesher, kernel #1's and kernel #2's plain versions on
them against the Pallas kernels in interpret mode, and OracleSolver(
device="cpu") of the port against the JAX reference on dataset cases cut
to a few steps (grids, errors and per-step outer rounds).

Both packages refine every step to rtol 1e-10, so the grids are held to
GRID_TOL and the errors to ERR_TOL, the tolerances of the heat slice's
tests. Each reference solve costs seconds of XLA compiles whatever its
size, so every case is solved once per module and shared."""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdebench_tpu.oracle.wave as ref_wave
from pdebench_tpu.fem.assemble import cell_batch as ref_cell_batch
from pdebench_tpu.fem.assemble import local_mass as ref_local_mass
from pdebench_tpu.fem.assemble import local_stiffness as ref_local_stiffness
from pdebench_tpu.fem.spaces import FunctionSpace as RefSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.oracle import base as ref_base
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers.gmg import attach_lattice_gmg as ref_attach
from pdebench_tpu.solvers.stencil import lattice_operator_from_local as ref_lattice
from pdebench_tpu.solvers.stencil import lattice_weight_map as ref_wmap
from pdebench_tpu.solvers.stencil_pallas import stencil_apply_2d as pallas_apply
from pdebench_tpu_torch.oracle import OracleSolver, base
from pdebench_tpu_torch.solvers import dispatch, gmg, gmg_fused, stencil, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-7  # relative L2 between the two packages' grids (NaN outside)
ERR_TOL = 1e-6  # relative difference of baseline_error
TOL_PRECOND = 1e-5  # f32 sums in another order through a V-cycle
TOL_CG = 2e-4  # ... and through the PCG recurrence (tests/test_gmg_fused.py)


def case(case_id, resolution, steps, ref_resolution=None, ref_degree=None):
    """A dataset case's config with its mesh resolution and number of
    steps (t_end = t0 + steps * dt) cut, and reference_config's mesh
    resolution and degree where given."""
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] == case_id:
                cfg = c["oracle_config"]
                break
        else:
            raise KeyError(case_id)
    cfg["mesh"]["resolution"] = resolution
    tc = cfg["pde"]["time"]
    tc["t_end"] = tc.get("t0", 0.0) + steps * tc["dt"]
    if ref_resolution is not None:
        cfg["reference_config"]["mesh"]["resolution"] = ref_resolution
        cfg["reference_config"]["fem"]["degree"] = ref_degree
    return cfg


def launches():
    return stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES


def grid_gap(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def solve_both(config, monkeypatch):
    """Both packages on `config`, each running its timed solve once (the
    warm run repeats the cold one, and no test here reads a time); the
    reference's per-step inner iterations, read from its scan by a
    callback: the main solve's steps, then its re-solve's."""
    seen = []
    real = ref_wave.solve_constrained_ir

    def spy(*a, **k):
        out = real(*a, **k)
        jax.debug.callback(lambda it: seen.append(int(it)), out[1])
        return out

    monkeypatch.setattr(ref_base, "_COLD", True)
    monkeypatch.setattr(base, "timed_run", lambda run, device: (run(), 0.0, 0.0))
    monkeypatch.setattr(ref_wave, "solve_constrained_ir", spy)
    ref = RefOracle().solve(copy.deepcopy(config))
    monkeypatch.setattr(ref_wave, "solve_constrained_ir", real)
    before = launches()
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert launches() == before  # CPU tensors: the plain versions
    monkeypatch.undo()
    return res, ref, seen


# (case, resolution, steps, reference_config's resolution and degree):
# the l_shape MMS case (P2, 41^2 masked lattice, 1,281 dofs: 30 Jacobi-PCG
# steps a round); the t_junction no-exact case (P2, 27 x 41, 715 dofs), its
# dt / 2 re-solve cut from P3 at 160 to P2 at 16 (6 steps)
E2E = {
    "wave_lshape_trig_cos": ("wave_lshape_trig_cos", 20, 3, None, None),
    "wave_tjunc_source_gauss": ("wave_tjunc_source_gauss", 20, 3, 16, 2),
}


@pytest.fixture(scope="module")
def solved():
    mp = pytest.MonkeyPatch()
    try:
        yield {key: solve_both(case(*args), mp) for key, args in E2E.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("key", list(E2E))
def test_wave_case_matches_reference(solved, key):
    res, ref, ref_its = solved[key]
    info = res.solver_info
    steps = E2E[key][2]
    assert res.reference.shape == ref.reference.shape
    assert np.isnan(res.reference).any() and not np.isnan(res.reference).all()
    gap = grid_gap(res.reference, ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.num_dofs == ref.num_dofs
    assert info["pde"] == "wave" and info["device"] == "cpu" and info["theta"] == 0.25
    assert info["inner"] == "stencil-cg" and "iterative_failed" not in info
    assert info["num_steps"] == ref.solver_info["num_steps"] == steps
    # per step: the port's outer rounds are the reference's (30 inner
    # steps a round without a hierarchy); the no-exact case's re-solve
    # takes twice the steps at dt / 2
    assert len(ref_its) == (steps if key == "wave_lshape_trig_cos" else 3 * steps)
    assert info["outer_rounds"] == [it // 30 for it in ref_its[:steps]]
    assert info["iterations"] == ref.solver_info["iterations"]


def test_wave_unconverged_step_takes_host_lu_on_cpu(solved, monkeypatch):
    """Every step IR reports no convergence: the port solves the whole
    Newmark loop again with the host SuperLU, which lands on the
    reference's iterative grid within the refinement's tolerance."""
    real = dispatch.solve_constrained_ir

    def unconverged(*a, **k):
        x, it, r, _, name = real(*a, **k)
        return x, it, r, False, name

    monkeypatch.setattr(dispatch, "solve_constrained_ir", unconverged)
    res = OracleSolver(device="cpu").solve(case(*E2E["wave_lshape_trig_cos"]))
    _, ref, _ = solved["wave_lshape_trig_cos"]
    info = res.solver_info
    assert info["fallback"] == "direct" and info["inner"] == "host-lu"
    assert info["iterative_failed"]["step"] == 1
    gap = grid_gap(res.reference, ref.reference)
    assert gap < GRID_TOL, gap


def test_poisson_tjunction_matches_reference(monkeypatch):
    """An already-ported type on a masked non-square lattice: the dataset's
    Poisson t_junction case at resolution 12 (P2, 25 x 49), each package's
    timed solve run once."""
    cfg = json.loads(next(l for l in open(DATA) if '"poisson_tjunction_sinsin"' in l))["oracle_config"]
    cfg["mesh"]["resolution"] = 12
    monkeypatch.setattr(ref_base, "_COLD", True)
    monkeypatch.setattr(base, "timed_run", lambda run, device: (run(), 0.0, 0.0))
    ref = RefOracle().solve(copy.deepcopy(cfg))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    assert grid_gap(res.reference, ref.reference) < GRID_TOL
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.solver_info["inner"] == "stencil-cg"


def masked_operator(case_id, resolution):
    """A wave case's masked lattice at `resolution` (P2): the reference's
    f32 lattice operator of A = M / dt^2 + K / 4 with its GMG hierarchy
    (boundary dofs constrained), the space, the mask and the cell-local M
    and K."""
    cfg = case(case_id, resolution, 1)
    mesh = ref_base.build_mesh(cfg["domain"], cfg["mesh"])
    V = RefSpace(mesh, 2)
    cb = ref_cell_batch(mesh, 2)
    M, K = np.asarray(ref_local_mass(cb)), np.asarray(ref_local_stiffness(cb))
    A = M / 0.005**2 + 0.25 * K
    lat = ref_lattice(A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32)
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    ref_attach(lat, mask)
    return lat, V, mask, M, K


@pytest.fixture(scope="module")
def tjunction():
    """wave_tjunc_cos2's masked non-square lattice at resolution 12 (P2,
    27 x 41), the reference's hierarchy on it (one level; the fused
    kernels probe a 14 x 21 one below it) and the port's copy of that
    hierarchy."""
    lat, V, mask, _, K = masked_operator("wave_tjunc_cos2", 12)
    ref = lat.gmg
    port = gmg.lattice_gmg_from_numpy(
        [dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
              diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
         for l in ref.levels],
        np.asarray(ref.coarse_inv), ref.coarse_shape, "cpu", padded=ref.padded,
    )
    return lat, V, mask, K, ref, port


def test_plain_stencil_on_masked_nonsquare_lattice_matches_pallas_interpret(tjunction):
    """Kernel #1's plain version with wave's stiffness weights on the
    masked, non-square lattice, the field embedded as the oracle embeds it
    (absent sites zero): f32 against the Pallas kernel in interpret mode,
    f64 against the reference's weight-map apply. (The masked square
    l_shape lattice's applies are held to the reference's through the
    wave cases above.)"""
    lat, V, _, K, _, _ = tjunction
    shape = (27, 41)
    assert lat.shape == shape and lat.lattice.masked
    wm = stencil.lattice_weight_map(stencil.detect_lattice(V.dof_coords), V.dofmap_scalar)
    rwm = ref_wmap(lat.lattice, V.dofmap_scalar)
    W64 = wm.weights_np(K)
    np.testing.assert_array_equal(W64, rwm.weights_np(K))
    v = np.random.default_rng(0).standard_normal(V.ndof)
    u = np.asarray(lat.lattice.embed(jnp.asarray(v), 0.0)).reshape(shape)
    assert (u == 0).sum() >= (lat.lattice.perm == lat.lattice.n_dof).sum() > 0
    before = launches()
    W32, u32 = W64.astype(np.float32), u.astype(np.float32)
    y_ref = np.asarray(pallas_apply(jnp.asarray(np.pad(u32, wm.pad)), jnp.asarray(W32),
                                    tuple(wm.offsets), wm.pad, tile=32, interpret=True))
    y = stencil_kernel.stencil_plain(torch.as_tensor(u32), torch.as_tensor(W32), wm.offsets, wm.pad)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5 * np.abs(y_ref).max())
    y64 = wm.apply_grid(torch.as_tensor(W64), torch.as_tensor(u)).numpy()
    want = np.asarray(rwm.apply_grid(jnp.asarray(W64), jnp.asarray(u)))
    assert np.abs(y64 - want).max() <= 1e-12 * np.abs(want).max()
    assert launches() == before


@pytest.mark.parametrize("iters, tol", [(1, TOL_PRECOND), (4, TOL_CG)])
def test_plain_fused_cg_on_masked_nonsquare_hierarchy_matches_pallas_interpret(
        tjunction, iters, tol):
    """Kernel #2's plain version on the masked non-square hierarchy: one
    PCG step (the V-cycle's arithmetic, at its own tolerance) and 4."""
    lat, V, mask, _, ref, port = tjunction
    assert [l.shape for l in ref.levels] == [(27, 41)] and not ref.padded
    assert [(l.ny, l.nx) for l in gmg_fused._scalar_hierarchy(port)[0]] == [(27, 41), (14, 21)]
    assert lat.lattice.masked and not port.padded
    inner_ref = ref_fused.build_fused_inner_cg(ref, iters, interpret=True)
    inner = gmg_fused.build_fused_inner_cg(port, iters, "cpu")
    r = np.random.default_rng(iters).standard_normal(V.ndof)
    r[mask] = 0.0
    r_lat = lat.embedding.embed_np(r.astype(np.float32), 0.0)
    before = launches()
    z = inner(torch.as_tensor(r_lat)).numpy()
    assert launches() == before
    z_ref = np.asarray(inner_ref(jnp.asarray(r_lat)))
    np.testing.assert_allclose(z, z_ref, rtol=tol, atol=tol * np.abs(z_ref).max())
