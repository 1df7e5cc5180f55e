"""The convection-diffusion slice on the CPU: the advection and SUPG forms
against the JAX reference, the transient step count, and
OracleSolver(device="cpu") against the reference on dataset cases at cut
sizes (steady and transient, SUPG, 2-D and 3-D).

Every lattice route here with a hierarchy is "gmres+vcycle" (below the
hierarchy's size gate, "gmres+jacobi": GMRES(60) with Jacobi): it is coarsened
from the nonsymmetric operator itself, and the inner is one GMRES cycle a
refinement round (30 steady, 20 a transient step) preconditioned by the
PyTorch V-cycle, as the reference's CPU route does with its XLA ops. 3-D
cases pin the reference to its lattice route
(PDEBENCH_TPU_FORCE_STENCIL=1)."""

import copy

import numpy as np
import pytest
import torch

import pdebench_tpu.fem.assemble as ref_asm
import pdebench_tpu.fem.mesh as ref_mesh
from pdebench_tpu_torch.fem import assemble as asm
from pdebench_tpu_torch.fem import mesh as meshmod
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.oracle import OracleSolver, base
from pdebench_tpu_torch.oracle.convection_diffusion import transient_time
from pdebench_tpu_torch.solvers import dispatch
from test_torch_heat import GRID_TOL, case, compare

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

FORMS = [("triangle", 2, 4), ("quadrilateral", 1, 4), ("tetrahedron", 2, 2)]


def _batches(cell, degree, n):
    """The same mesh's cell batch in both packages, a smooth beta at its
    quadrature points and a cell-wise tau."""
    if cell == "tetrahedron":
        mine, theirs = meshmod.unit_cube_mesh(n), ref_mesh.unit_cube_mesh(n)
    else:
        mine, theirs = meshmod.unit_square_mesh(n, cell), ref_mesh.unit_square_mesh(n, cell)
    cb, rcb = asm.cell_batch(mine, degree), ref_asm.cell_batch(theirs, degree)
    q = np.asarray(cb.qpts)
    beta = np.stack([np.sin(3 * q[..., d] + d) + 0.5 * q[..., 0] for d in range(q.shape[-1])], -1)
    rng = np.random.default_rng(0)
    return cb, rcb, beta, rng.uniform(0.01, 0.1, cb.n_cells), np.cos(q.sum(-1))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("cell, degree, n", FORMS)
def test_weak_forms_match_reference(cell, degree, n):
    """laplace_phys, local_advection, local_supg (epsilon 0 and not) and
    local_supg_load against the reference, array against array."""
    cb, rcb, beta, tau, f_q = _batches(cell, degree, n)
    _close(cb.laplace_phys(), rcb.laplace_phys())
    if degree > 1 and cell != "quadrilateral":
        assert np.abs(cb.laplace_phys()).max() > 1.0  # the epsilon term is not empty
    _close(asm.local_advection(cb, beta), ref_asm.local_advection(rcb, beta))
    for eps in (0.0, 0.03):
        _close(asm.local_supg(cb, beta, tau, eps), ref_asm.local_supg(rcb, beta, tau, eps))
    _close(asm.local_supg_load(cb, beta, tau, f_q), ref_asm.local_supg_load(rcb, beta, tau, f_q))


@pytest.mark.parametrize("tc, steps, rounded", [
    ({"t0": 0.0, "t_end": 0.1, "dt": 0.02}, 5, 5),  # 4.999...: both give 5
    ({"t0": 0.0, "t_end": 0.1, "dt": 0.03}, 4, 3),  # 3.33
    ({"t_end": 0.2, "dt": 0.06}, 4, 3),  # 3.33
    ({"t0": 0.0, "t_end": 0.1, "dt": 0.04}, 3, 3),  # 2.5
    ({"t0": 0.1, "t_end": 0.1, "dt": 0.01}, 1, 1),  # at least one step
    ({"t_end": 0.1}, 10, 10),  # dt defaults to 0.01
])
def test_transient_steps_are_the_ceiling(tc, steps, rounded):
    """Transient convection-diffusion takes the ceiling of (t_end - t0) /
    dt; base.time_params (heat) rounds."""
    t0, t_end, dt, n = transient_time(tc)
    assert n == steps
    assert base.time_params({"time": tc}) == (t0, t_end, dt, rounded)


# (case, mesh resolution, steps, degree, reference_config's resolution,
# the port's CPU inner, 3-D), cut as stated: 73^2 and 21^3 nodes, unpadded
# hierarchies; the no-exact case to 17^2 nodes (no hierarchy), its
# re-solve (P2 at reference_config's dt 0.01, 4 steps) to 25^2 nodes
E2E = [
    ("convdiff_high_pe", 72, None, None, None, "gmres+vcycle", False),  # steady, SUPG
    ("convdiff_parabolic_high_pe_supg", 72, 2, None, None, "gmres+vcycle", False),  # transient
    ("convdiff_parabolic_no_exact_forcing", 16, 2, None, 12, "gmres+jacobi", False),
    ("cd_3d_transient_basic", 20, 2, 1, None, "gmres+vcycle", True),
]


@pytest.mark.parametrize("cid, res_, steps, degree, ref_res, inner, three_d", E2E, ids=[e[0] for e in E2E])
def test_convection_diffusion_case_matches_reference(cid, res_, steps, degree, ref_res, inner, three_d,
                                                     monkeypatch):
    res, ref = compare(case(cid, res_, steps, degree, ref_res), "convection_diffusion",
                       monkeypatch if three_d else None)
    info = res.solver_info
    assert info["inner"] == inner
    if steps is None:
        assert info["method"] == ref.solver_info["method"] == "gmres"
        assert info["pc_used"] == ref.solver_info["pc_used"] == "gmg+stencil-ir32"
        assert info["iterations"] % 30 == 0
    else:
        assert info["num_steps"] == ref.solver_info["num_steps"] == steps
        assert len(info["outer_rounds"]) == steps
        assert info["iterations"] == (60 if inner == "gmres+jacobi" else 20) * sum(info["outer_rounds"])


def test_unconverged_step_keeps_its_iterate_on_cpu(monkeypatch):
    """Every step IR reports no convergence: on the CPU the loop goes on
    from each step's iterate, as the reference's scan does (it does not
    look at convergence), records the first such step, and takes no host
    solve; the grid still matches the reference's. Cut: 17^2 nodes (no
    hierarchy: GMRES(60) with Jacobi), 2 steps."""
    real = dispatch.solve_constrained_ir

    def unconverged(*a, **k):
        x, it, res, _, name = real(*a, **k)
        return x, it, res, False, name

    monkeypatch.setattr(dispatch, "solve_constrained_ir", unconverged)
    cfg = case("convdiff_parabolic_high_pe_supg", 16, 2)
    ref = RefOracle().solve(copy.deepcopy(cfg))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    info = res.solver_info
    assert info["inner"] == "gmres+jacobi" and "fallback" not in info
    assert info["iterative_failed"]["step"] == 1 and len(info["outer_rounds"]) == 2
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
