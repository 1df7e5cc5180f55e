"""The reference's route switches in the port, on the CPU.

PDEBENCH_TPU_FUSED=arnoldi (kernel #6's whole Arnoldi cycle on per-step
operators and on every steady scalar hierarchy), PDEBENCH_TPU_STEP_RICH=1
(kernel #3 as the per-step preconditioner), PDEBENCH_TPU_STEP_OUTER=cell
(the step's exact float64 cell batch as the outer), the timing protocol
(PDEBENCH_TPU_WARM_REPEATS, PDEBENCH_TPU_COLD_TIMING), the host-LU
requests (PDEBENCH_TPU_FORCE_DIRECT, PDEBENCH_TPU_STRUCTURED_LU=direct) and
the Navier-Stokes host-LU Newton's device retry.

Kernel level: #6 on a Burgers step's and a reaction Jacobian's float32
weights (their own offsets, m = 20 and 15) and #3 on the constant part's
hierarchy, the plain versions against the Pallas kernels in interpret
mode on the reference's hierarchy. End to end: the reference never takes
a fused route on the CPU (its platform gate), so the port's fused routes
are held to the reference's default route by grids and errors
(test_torch_heat.GRID_TOL, ERR_TOL), not iteration counts; the switches
the reference honours on the CPU (the cell outer, the host-LU requests)
are held to the reference under the same switch."""

import copy
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem.assemble import cell_batch, local_advection, local_mass, local_stiffness
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu.solvers.gmg import attach_lattice_gmg as ref_attach
from pdebench_tpu_torch.oracle import OracleSolver, base
from pdebench_tpu_torch.oracle.poisson import PoissonSolver
from pdebench_tpu_torch.solvers import dispatch, gmg, gmg_fused
from pdebench_tpu_torch.solvers.stencil_kernel import stencil_plain
from test_torch_heat import ERR_TOL, GRID_TOL, case, launches

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

# f32 sums in another order through one Arnoldi step or a chain of two
# V-cycles (tests/test_torch_gmg_fused_krylov.py)
TOL = 1e-5
# true-operator residuals below this are float32 Gram-Schmidt rounding,
# where no ratio holds (chip_smoke.RESID_FLOOR)
RESID_FLOOR = 1e-5


# -- kernels #6 and #3 on per-step systems --------------------------------


def _step_system(kind, n):
    """A per-step system as the oracles build it, on the reference's side:
    the constant part's f32 lattice with its GMG hierarchy (the reference's
    and the port's copy of it), the constrained float32 weights of the
    step's operator on its own weight map's offsets, and a residual.
    "burgers": P2, A = M / dt + advection(u) + nu K, u = sin sin (19
    taps); "reaction": P1, the Jacobian M / dt + eps K + mass(R'(u)) of a
    cubic reaction (7 taps)."""
    degree = 2 if kind == "burgers" else 1
    mesh = unit_square_mesh(n)
    V = FunctionSpace(mesh, degree)
    cb = cell_batch(mesh, degree)
    M, K = np.asarray(local_mass(cb)), np.asarray(local_stiffness(cb))
    dt = 0.01
    xy = np.asarray(V.dof_coords)
    u = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
    phi = np.asarray(cb.phi)
    u_q = np.einsum("qi,ci->cq", phi, u[np.asarray(V.dofmap_scalar)])
    if kind == "burgers":
        A_const = M / dt + 0.01 * K
        beta = np.repeat(u_q[..., None], 2, axis=-1)
        A_step = A_const + np.asarray(local_advection(cb, beta))
    else:
        A_const = M / dt + 0.1 * K
        A_step = A_const + np.asarray(local_mass(cb, jnp.asarray(0.5 + 6.0 * u_q ** 2)))
    lat = ref_stencil.lattice_operator_from_local(
        A_const, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32
    )
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    ref_attach(lat, mask)
    ref = lat.gmg
    assert not ref.padded and not ref.surrogate
    port = gmg.lattice_gmg_from_numpy(
        [dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape, diag_inv=np.asarray(l.diag_inv),
              omega=l.omega, pad_to=l.pad_to) for l in ref.levels],
        np.asarray(ref.coarse_inv), ref.coarse_shape, "cpu",
    )
    wmap = ref_stencil.lattice_weight_map(lat.lattice, V.dofmap_scalar)
    keep = jnp.asarray((1.0 - lat.embedding.embed_np(mask, True).astype(np.float32)).reshape(lat.grid_shape))
    W32 = jnp.asarray(wmap.weights_np(A_step), jnp.float32)
    W32c = np.asarray(ref_stencil.constrain_step_weights(W32, wmap.offsets, keep))
    r = np.random.default_rng(3).standard_normal(V.ndof)
    r[mask] = 0.0
    return lat, wmap.offsets, ref, port, W32c, lat.embedding.embed_np(r.astype(np.float32), 0.0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _true_residual(lat, offsets, W32c, r, z):
    pad = max(abs(o) for off in offsets for o in off)
    u = torch.as_tensor(np.asarray(z)).reshape(lat.shape)
    Az = stencil_plain(u, torch.as_tensor(W32c), offsets, pad).reshape(-1)
    r = torch.as_tensor(r)
    return float(torch.linalg.norm(r - Az) / torch.linalg.norm(r))


@pytest.mark.parametrize("kind,n,m,taps", [("burgers", 16, 20, 19), ("reaction", 32, 15, 7)])
def test_step_arnoldi_matches_pallas_interpret(kind, n, m, taps):
    """Kernel #6 with a per-step operator (the step weights' own offsets,
    the constant part's hierarchy as preconditioner) at the main path's m.
    The first step per element (beta, V[0], the first Hessenberg column):
    on these mass-dominated step operators H[j+1, j] is 0.06-0.27, so each
    later step multiplies the two float32 recurrences' rounding gap by
    4-16 (V[5] parts by 1e-4 / 0.4 of its scale here). The whole cycle's
    correction per element (measured 4e-7 / 9e-7 of its scale) and by its
    true-operator residual."""
    lat, offsets, ref, port, W32c, r = _step_system(kind, n)
    assert len(offsets) == taps
    fg_ref = ref_fused.build_fused_inner_gmres(ref, m, interpret=True, step_offsets=offsets)
    fg = gmg_fused.build_fused_inner_gmres(port, m, "cpu", offsets)
    Vp, Hout, S = fg_ref.debug_raw(jnp.asarray(r), jnp.asarray(W32c))
    ny, nx = lat.shape
    V_ref = np.asarray(Vp)[:, :ny, :nx].reshape(m + 1, -1)
    H_ref = np.asarray(Hout)[:, 0, : m + 1].T
    before = launches()
    Vb, H, beta = fg.raw(torch.as_tensor(r), torch.as_tensor(W32c))
    assert launches() == before  # CPU tensors: the plain version
    _close(Vb.numpy()[0], V_ref[0])
    _close(H.numpy()[:2, 0], H_ref[:2, 0])
    assert abs(float(beta) - float(np.asarray(S)[0, 0])) <= TOL * abs(float(np.asarray(S)[0, 0]))
    z = fg(torch.as_tensor(r), torch.as_tensor(W32c)).numpy()
    z_ref = np.asarray(fg_ref(jnp.asarray(r), jnp.asarray(W32c)))
    _close(z, z_ref)
    rel, rel_ref = (_true_residual(lat, offsets, W32c, r, zz) for zz in (z, z_ref))
    assert rel < 0.05 and rel <= 1.5 * max(rel_ref, RESID_FLOOR), (rel, rel_ref)


def test_step_richardson_matches_pallas_interpret():
    """Kernel #3, 2 V-cycles of a Burgers step system's constant-part
    hierarchy (the per-step preconditioner of PDEBENCH_TPU_STEP_RICH=1)."""
    lat, _, ref, port, _, r = _step_system("burgers", 16)
    fr_ref = ref_fused.build_fused_richardson(ref, 2, interpret=True)
    fr = gmg_fused.build_fused_richardson(port, dispatch.RICHARDSON_CYCLES, "cpu")
    _close(fr(torch.as_tensor(r)).numpy(), np.asarray(fr_ref(jnp.asarray(r))))


# -- the switches end to end ----------------------------------------------


def _cut(cid, resolution, steps=None):
    cfg = case(cid, resolution)
    if steps is not None and "time" in cfg["pde"]:
        tc = cfg["pde"]["time"]
        tc["t_end"] = tc.get("t0", 0.0) + steps * tc["dt"]
    elif steps is not None:
        # Burgers: t_final and dt (0.01 by default) set the steps
        cfg["pde"]["t_final"] = steps * cfg["pde"].get("dt", 0.01)
    return cfg


# burgers_square_v1 at P2 resolution 48 (97 x 97 nodes: 97 -> 49 -> 25 ->
# 13, unpadded), 2 steps; reaction_diffusion_allen_cahn_p2 likewise
BURGERS = ("burgers_square_v1", 48, 2)
ALLEN_CAHN = ("reaction_diffusion_allen_cahn_p2", 48, 2)


def _ref_solve(spec, env=None):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        return RefOracle().solve(_cut(*spec))


@pytest.fixture(scope="module")
def burgers_ref():
    return _ref_solve(BURGERS)


@pytest.fixture(scope="module")
def burgers_ref_cell():
    return _ref_solve(BURGERS, {"PDEBENCH_TPU_STEP_OUTER": "cell"})


def _port(spec, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = launches()
    res = OracleSolver(device="cpu").solve(_cut(*spec))
    assert launches() == before
    assert np.isfinite(res.reference).all() and "iterative_failed" not in res.solver_info
    return res


def _held(res, ref):
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error


@pytest.mark.parametrize("env,inner", [
    ({"PDEBENCH_TPU_FUSED": "arnoldi"}, "fused-gmres-step-torch"),
    ({"PDEBENCH_TPU_STEP_RICH": "1"}, "gmres+fused-richardson-step-torch"),
], ids=["arnoldi", "step-rich"])
def test_burgers_per_step_routes_match_reference(monkeypatch, burgers_ref, env, inner):
    res = _port(BURGERS, monkeypatch, env)
    info = res.solver_info
    assert info["inner"] == inner and info["step_outer"] == "stencil"
    assert info["num_steps"] == 2
    _held(res, burgers_ref)


def test_burgers_cell_outer_matches_reference(monkeypatch, burgers_ref, burgers_ref_cell):
    """PDEBENCH_TPU_STEP_OUTER=cell on both packages: the exact float64
    cell batch as the outer, grid for grid and the iterations; the error
    moves off the stencil-cast outer's (the operator of the float32
    weights) by far more than ERR_TOL (1.0e-4 relative here)."""
    res = _port(BURGERS, monkeypatch, {"PDEBENCH_TPU_STEP_OUTER": "cell"})
    info = res.solver_info
    assert info["inner"] == "gmres+vcycle" and info["step_outer"] == "cell"
    _held(res, burgers_ref_cell)
    assert info["iterations"] == burgers_ref_cell.solver_info["iterations"]
    moved = abs(burgers_ref_cell.baseline_error - burgers_ref.baseline_error)
    assert moved > 10 * ERR_TOL * burgers_ref.baseline_error


def test_step_outer_cell_takes_the_cell_batch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PDEBENCH_TPU_STEP_OUTER", "cell")
        assert dispatch.step_outer() == "cell"
        mp.setenv("PDEBENCH_TPU_STEP_OUTER", "cells")
        with pytest.raises(ValueError):
            dispatch.step_outer()
        mp.setenv("PDEBENCH_TPU_FUSED", "none")
        with pytest.raises(NotImplementedError):
            dispatch.fused_mode()


@pytest.mark.parametrize("env,inner,outer", [
    ({"PDEBENCH_TPU_FUSED": "arnoldi"}, "fused-gmres-step-torch", "stencil"),
    ({"PDEBENCH_TPU_STEP_OUTER": "cell"}, "gmres+vcycle", "cell"),
], ids=["arnoldi", "cell-outer"])
def test_newton_per_step_routes_match_reference(monkeypatch, env, inner, outer):
    """The reaction Newton's Jacobian solves on the new routes (P2 97^2,
    unpadded), held to the reference under the same switch (the reference
    runs its default route on the CPU under PDEBENCH_TPU_FUSED=arnoldi)."""
    res = _port(ALLEN_CAHN, monkeypatch, env)
    info = res.solver_info
    assert info["inner"] == inner and info["step_outer"] == outer
    _held(res, _ref_solve(ALLEN_CAHN, env))


@pytest.mark.parametrize("cid,res_", [("helmholtz_basic_k5", 96), ("convdiff_low_pe", 96)],
                         ids=["surrogate", "own-operator"])
def test_steady_arnoldi_matches_reference(monkeypatch, cid, res_):
    """PDEBENCH_TPU_FUSED=arnoldi on steady lattices below the fused
    cycle's size gate (97^2, 9,409 dofs), where the default routes are
    gmres+fused-richardson and gmres+vcycle: Helmholtz's surrogate
    hierarchy and convection-diffusion's own-operator one take the whole
    Arnoldi cycle, the operator the constrained float32 weights."""
    ref = RefOracle().solve(_cut(cid, res_))
    res = _port((cid, res_), monkeypatch, {"PDEBENCH_TPU_FUSED": "arnoldi"})
    assert res.solver_info["inner"] == "fused-gmres-torch"
    _held(res, ref)


def test_padded_hierarchy_keeps_the_vcycle(monkeypatch):
    """burgers_square_v1 at P2 resolution 37 (75 -> 38: a padded
    hierarchy): no kernel takes it, so both switches leave the per-step
    inner on the PyTorch V-cycle, and its name says so."""
    monkeypatch.setenv("PDEBENCH_TPU_FUSED", "arnoldi")
    monkeypatch.setenv("PDEBENCH_TPU_STEP_RICH", "1")
    res = OracleSolver(device="cpu").solve(_cut("burgers_square_v1", 37, 1))
    assert res.solver_info["inner"] == "gmres+vcycle"


def test_timed_run_keeps_the_fastest_warm_pass(monkeypatch):
    passes = []

    def run():
        passes.append(len(passes))
        return len(passes), {}

    clock = iter([0.0, 5.0, 5.0, 9.0, 9.0, 10.0, 10.0, 13.0])
    monkeypatch.setattr(base, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    monkeypatch.setenv("PDEBENCH_TPU_WARM_REPEATS", "3")
    (result, info), t_warm, t_cold = base.timed_run(run, "cpu")
    # a cold pass of 5 s, warm passes of 4, 1 and 3 s
    assert (result, t_warm, t_cold, len(passes)) == (4, 1.0, 5.0, 4)
    assert info == {"warm_passes": 3, "warm_pass_s": [4.0, 1.0, 3.0], "cold_timing": False}
    monkeypatch.setenv("PDEBENCH_TPU_COLD_TIMING", "1")
    passes.clear()
    clock = iter([0.0, 7.0])
    assert base.timed_run(run, "cpu") == (
        (1, {"warm_passes": 0, "warm_pass_s": [], "cold_timing": True}), 7.0, 7.0
    )
    assert len(passes) == 1


def test_oracle_reports_the_timing_protocol(monkeypatch):
    """Through the oracle, also a solver class called directly: each solve
    reports its own passes."""
    monkeypatch.setenv("PDEBENCH_TPU_WARM_REPEATS", "2")
    info = OracleSolver(device="cpu").solve(_cut("poisson_basic", 24)).solver_info
    assert (info["warm_passes"], info["cold_timing"]) == (2, False)
    assert len(info["warm_pass_s"]) == 2 and info["t_warm"] == min(info["warm_pass_s"])
    monkeypatch.setenv("PDEBENCH_TPU_WARM_REPEATS", "3")
    for _ in range(2):
        info = PoissonSolver("cpu").solve(_cut("poisson_basic", 24)).solver_info
        assert info["warm_passes"] == 3 and len(info["warm_pass_s"]) == 3
        assert info["t_warm"] == min(info["warm_pass_s"])


@pytest.mark.parametrize("cid,res_,steps", [("poisson_basic", 24, None), ("heat_longer", 24, 1)],
                         ids=["steady-cg", "step-loop-cg"])
def test_fused_none_raises_on_every_lattice_route(monkeypatch, cid, res_, steps):
    """PDEBENCH_TPU_FUSED=0 / none, the reference's lattice routes without
    a fused kernel, is not ported: a CG lattice solve raises too (steady
    through solve_linear, and a step loop's solve_constrained_ir), not only
    the GMRES routes that read the mode."""
    for mode in ("0", "none"):
        monkeypatch.setenv("PDEBENCH_TPU_FUSED", mode)
        with pytest.raises(NotImplementedError, match=f"PDEBENCH_TPU_FUSED={mode}"):
            OracleSolver(device="cpu").solve(_cut(cid, res_, steps))


@pytest.mark.parametrize("env,ksp", [
    ({"PDEBENCH_TPU_FORCE_DIRECT": "1"}, "cg"),
    ({"PDEBENCH_TPU_STRUCTURED_LU": "direct"}, "preonly"),
], ids=["force-direct", "structured-lu"])
def test_host_lu_requests_match_reference(monkeypatch, env, ksp):
    """The explicit host-LU requests on a lattice case (poisson_basic at
    resolution 80, 6,561 dofs, a hierarchy attached by default): both
    packages' host LU, held to each other; named in solver_info, not a
    fallback."""
    cfg = _cut("poisson_basic", 80)
    cfg["oracle_solver"] = dict(cfg["oracle_solver"], ksp_type=ksp, pc_type="lu" if ksp == "preonly" else "hypre")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = RefOracle().solve(copy.deepcopy(cfg))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    info = res.solver_info
    assert info["inner"] == "host-lu" and info["host_request"] == "{}={}".format(*next(iter(env.items())))
    assert "direct_rerouted" not in info and "iterative_failed" not in info
    assert ref.solver_info["method"] == "lu" and "direct_rerouted" not in ref.solver_info
    # one SuperLU factorisation each of matrices summed in other orders
    np.testing.assert_allclose(res.reference, ref.reference, rtol=1e-10, atol=1e-12)
    assert abs(res.baseline_error - ref.baseline_error) <= 1e-9 * ref.baseline_error
