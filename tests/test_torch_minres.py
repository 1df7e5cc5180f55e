"""The Stokes slice's solver pieces against the JAX reference on the CPU.

`krylov.minres` on seeded symmetric indefinite systems with an SPD
diagonal M: without an f32 twin the same recurrence as the reference's
(equal iterations, x within 1e-12); with one (MINRES-IR) converged to the
true-residual tolerance; a stalling restart keeps the best iterate and
ends the solve. `LatticeSaddleVectors` (embed, extract, apply_w,
block_diag_M) on seeded vectors within 1e-12 in f64. The saddle
preconditioner's host pieces array-equal to the reference's, and its
velocity solve (`Mv_grid`, kernel #3's plain version, 2 V-cycles a
component) against the reference's `build_fused_richardson(gmg, 2,
interpret=True)` on the same scalar hierarchy (a resolution-24 P2 lattice,
49/25/13) within f32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.oracle import mixed as ref_mixed
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers.gmg import setup_gmg as ref_setup_gmg
from pdebench_tpu.solvers.krylov import minres as ref_minres
from pdebench_tpu.solvers.saddle_stencil import LatticeSaddleVectors as RefLSV
from pdebench_tpu.solvers.saddle_stencil import build_saddle_stencil as ref_build_sst
from pdebench_tpu.solvers.stencil import LatticeOperator as RefLatticeOperator
from pdebench_tpu_torch.fem.assemble import LocalOperator, local_divergence, local_stiffness, local_vector_laplacian
from pdebench_tpu_torch.oracle import mixed
from pdebench_tpu_torch.solvers import gmg_fused, krylov
from pdebench_tpu_torch.solvers.amg import constrained_csr
from pdebench_tpu_torch.solvers.saddle_stencil import LatticeSaddleVectors, build_saddle_stencil
from pdebench_tpu_torch.solvers.stencil import detect_lattice
from test_torch_navier_stokes import spaces

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

TOL = 1e-12
# f32 sums in another order through two V-cycles (tests/test_torch_gmg_fused.py)
TOL_VCYCLE = 1e-5


def indefinite_system(n, seed, n_neg):
    """A = Q diag(lam) Q^T with n_neg negative eigenvalues, an SPD diagonal
    M, b seeded."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([-rng.uniform(0.5, 2.0, n_neg), rng.uniform(0.5, 2.0, n - n_neg)])
    return (Q * lam) @ Q.T, rng.uniform(0.8, 1.25, n), rng.standard_normal(n)


def few_eigenvalue_system(n, seed, distinct):
    """A = M^-1/2 B M^-1/2 with B symmetric indefinite of `distinct`
    eigenvalues and M an SPD diagonal: the preconditioned operator has
    `distinct` eigenvalues, so MINRES ends at that iteration with the
    solution to rounding, whatever the order of the sums."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    centers = np.concatenate([-rng.uniform(0.5, 3.0, distinct // 3), rng.uniform(0.5, 3.0, distinct - distinct // 3)])
    m = rng.uniform(0.5, 2.0, n)
    B = (Q * centers[np.arange(n) % distinct]) @ Q.T
    return B / np.sqrt(np.outer(m, m)), m, rng.standard_normal(n)


def both_minres(A, m, b, rtol):
    """The port's and the reference's MINRES on A x = b with M = diag(m),
    f64 throughout."""
    x, info = krylov.minres(
        lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), M=lambda r: torch.as_tensor(m) * r,
        rtol=rtol, atol=1e-14,
    )
    x_r, info_r = ref_minres(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=lambda r: jnp.asarray(m) * r,
        rtol=rtol, atol=1e-14,
    )
    assert info.converged and bool(info_r.converged)
    assert np.linalg.norm(b - A @ x.numpy()) <= rtol * np.linalg.norm(b) + 1e-14
    return x.numpy(), info, np.asarray(x_r), info_r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minres_matches_reference(seed):
    """The port's host loop runs the reference's recurrence: on a system
    whose preconditioned operator has 12 eigenvalues, both end at
    iteration 12, x within TOL."""
    x, info, x_r, info_r = both_minres(*few_eigenvalue_system(120, seed, 12), rtol=1e-10)
    assert info.iterations == int(info_r.iterations) == 12 and info.restarts == 1
    np.testing.assert_allclose(x, x_r, rtol=TOL, atol=TOL * np.abs(x_r).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minres_long_recurrence_matches_reference(seed):
    """A spread indefinite spectrum, ~80 iterations: the same count as the
    reference's; x agrees to the accuracy the tolerance fixes (rtol times
    the condition number, 4), not to rounding: the two runs sum their dot
    products in other orders, and a long Lanczos recurrence amplifies
    that."""
    x, info, x_r, info_r = both_minres(*indefinite_system(150, seed, 50), rtol=1e-10)
    assert info.iterations == int(info_r.iterations) > 50
    np.testing.assert_allclose(x, x_r, rtol=0, atol=1e-9 * np.abs(x_r).max())


def test_minres_ir_reaches_the_true_tolerance():
    """MINRES-IR: the recurrence in f32 (A32, M's output cast), restarts
    from the true f64 residual until it meets rtol ||b|| + atol."""
    A, dinv, b = indefinite_system(80, 3, 25)
    A64, A32 = torch.as_tensor(A), torch.as_tensor(A, dtype=torch.float32)
    x0 = torch.as_tensor(np.random.default_rng(4).standard_normal(80))
    x, info = krylov.minres(
        lambda v: A64 @ v, torch.as_tensor(b), x0=x0, M=lambda r: torch.as_tensor(dinv) * r,
        rtol=1e-10, atol=1e-14, A32=lambda v: A32 @ v,
    )
    assert x.dtype == torch.float64
    assert info.converged and 2 <= info.restarts <= 8
    res = np.linalg.norm(b - A @ x.numpy())
    assert res == pytest.approx(info.residual, rel=1e-12)
    assert res <= 1e-10 * np.linalg.norm(b) + 1e-14


def test_minres_keeps_the_best_iterate_when_a_restart_stalls():
    """A wrong f32 twin (0.8 A on most eigenvectors, 0.45 A on the rest):
    each restart shrinks the residual's components on the first by 4 and
    grows the rest by 1.22, so the restarts improve and then one does not.
    The solve ends there, before its 8 restarts, and returns the best
    iterate, whose true residual it reports."""
    rng = np.random.default_rng(3)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([-rng.uniform(1.0, 2.0, 15), rng.uniform(1.0, 2.0, n - 15)])
    s = np.where(np.arange(n) % 4 == 0, 0.45, 0.8)
    A, A_wrong = (Q * lam) @ Q.T, (Q * (lam * s)) @ Q.T
    b = Q @ np.where(s == 0.8, 1.0, 1e-3)
    A64, A32 = torch.as_tensor(A), torch.as_tensor(A_wrong, dtype=torch.float32)
    seen = []

    def A_rec(v):
        seen.append(v.clone())
        return A64 @ v

    x, info = krylov.minres(A_rec, torch.as_tensor(b), rtol=1e-12, atol=0.0, A32=lambda v: A32 @ v)
    res = [np.linalg.norm(b - A @ v.numpy()) for v in seen]  # x0, then each restart's iterate
    assert not info.converged and 2 <= info.restarts < 8
    assert len(res) == info.restarts + 1
    assert res[1] < res[0] and res[-1] >= min(res[:-1])  # improved, then stalled
    best = int(np.argmin(res))
    assert torch.equal(x, seen[best]) and info.residual == pytest.approx(res[best], rel=1e-12)


def _saddle_pair(n):
    """Both packages' saddle stencils on a P2-P1 unit_square lattice of
    resolution n, with a Dirichlet mask on the boundary velocity and one
    pinned pressure dof."""
    (V_r, Q_r, cb_r, psi_r), (V, Q, cb, psi) = spaces(n, 2)
    G_loc = local_divergence(cb, psi)
    mask = np.zeros(V.ndof + Q.ndof, dtype=bool)
    bnd = V.boundary_scalar_dofs
    mask[np.concatenate([2 * bnd, 2 * bnd + 1])] = True
    mask[V.ndof + int(np.argmin(np.linalg.norm(Q.dof_coords, axis=1)))] = True
    return ref_build_sst(V_r, Q_r, G_loc), build_saddle_stencil(V, Q, G_loc), mask, (V, Q, cb, psi)


def test_lattice_saddle_vectors_match_reference():
    sst_r, sst, mask, (V, Q, cb, psi) = _saddle_pair(5)
    lsv_r, lsv = RefLSV(sst_r, mask), LatticeSaddleVectors(sst, mask, "cpu")
    np.testing.assert_array_equal(lsv.mask_lat.numpy(), np.asarray(lsv_r.mask_lat))
    assert lsv.n == lsv_r.n and lsv.n_u == lsv_r.n_u
    rng = np.random.default_rng(4)
    x = rng.standard_normal(V.ndof + Q.ndof)
    x_lat = lsv.embed(torch.as_tensor(x))
    np.testing.assert_array_equal(x_lat.numpy(), np.asarray(lsv_r.embed(jnp.asarray(x))))
    np.testing.assert_array_equal(lsv.extract(x_lat).numpy(), x)

    WA = sst.wmapA.weights_np(local_vector_laplacian(cb, 0.7))
    np.testing.assert_array_equal(WA, sst_r.wmapA.weights_np(local_vector_laplacian(cb, 0.7)))
    v = rng.standard_normal(lsv.n)
    y = lsv.apply_w(torch.as_tensor(WA))(torch.as_tensor(v)).numpy()
    y_r = np.asarray(lsv_r.apply_w(jnp.asarray(WA))(jnp.asarray(v)))
    np.testing.assert_allclose(y, y_r, rtol=TOL, atol=TOL * np.abs(y_r).max())

    # block-diagonal M: a fixed velocity map and the lattice-shaped Schur
    # diagonal, both packages on the same planes
    w = rng.uniform(0.5, 2.0, sst.fine + (2,))
    inv_p = mixed.schur_diag(cb, psi, Q.dofmap_scalar, Q.ndof, 0.7, mask, V.ndof)
    M = lsv.block_diag_M(lambda r: torch.as_tensor(w) * r, lsv.embed_plane_p(inv_p))
    M_r = lsv_r.block_diag_M(lambda r: jnp.asarray(w) * r, lsv_r.embed_plane_p(inv_p))
    np.testing.assert_allclose(M(torch.as_tensor(v)).numpy(), np.asarray(M_r(jnp.asarray(v))), rtol=TOL, atol=TOL)


def _precond_pair(n, nu):
    """The port's saddle preconditioner on a P2-P1 lattice of resolution n
    and the reference's hierarchy on the same constrained scalar stiffness
    stencil (its saddle_gmg_precond_parts keeps the hierarchy inside its
    closures), with the reference's own parts."""
    (V_r, Q_r, cb_r, psi_r), (V, Q, cb, psi) = spaces(n, 2)
    _, _, mask, _ = _saddle_pair(n)
    parts = mixed.saddle_gmg_precond_parts(V, nu, cb, psi, Q.dofmap_scalar, Q.ndof, mask, "cpu")
    parts_r = ref_mixed.saddle_gmg_precond_parts(
        V_r, nu, cb_r, jnp.asarray(psi_r), jnp.asarray(Q_r.dofmap_scalar), Q_r.ndof, jnp.asarray(mask)
    )
    lat = detect_lattice(V.dof_coords)
    mask_u = mask[: V.ndof].reshape(-1, 2).any(axis=1)
    A_s = LocalOperator(torch.as_tensor(local_stiffness(cb) * nu), V.dofmap_scalar, V.n_scalar_dofs).to_scipy()
    lat_r = RefLatticeOperator(constrained_csr(A_s, mask_u), lat, dtype=jnp.float32)
    gmg_r = ref_setup_gmg(np.asarray(lat_r.W, dtype=np.float64), lat_r.offsets, lat_r.shape, dtype=jnp.float32)
    return parts, parts_r, gmg_r, lat_r, (lat, mask_u)


def test_saddle_precond_host_pieces_match_reference():
    """The scalar stiffness stencil of the hierarchy and its levels are the
    reference's arrays; the Schur diagonal agrees within TOL."""
    parts, parts_r, gmg_r, lat_r, _ = _precond_pair(12, 0.3)
    assert parts.route == "fused-richardson-torch"
    assert [l.shape for l in parts.gmg.levels] == [l.shape for l in gmg_r.levels] == [(25, 25)]
    lv, lv_r = parts.gmg.levels[0], gmg_r.levels[0]
    assert list(lv.offsets) == list(lv_r.offsets) == list(lat_r.offsets)
    np.testing.assert_array_equal(lv.W.numpy(), np.asarray(lv_r.W))
    np.testing.assert_array_equal(lv.W.numpy(), np.asarray(lat_r.W))
    np.testing.assert_array_equal(lv.diag_inv.numpy(), np.asarray(lv_r.diag_inv))
    # the lumped mass sums in another order (bincount, the reference's scatter-add)
    np.testing.assert_allclose(parts.inv_p.numpy(), np.asarray(parts_r.inv_p), rtol=TOL, atol=0)
    np.testing.assert_array_equal(parts.mask_full.numpy(), np.asarray(parts_r.mask_full))


def test_velocity_solve_matches_pallas_interpret():
    """Mv_grid (kernel #3's plain version, 2 V-cycles on each component
    plane) against the reference's fused Richardson chain in interpret
    mode on the same 49/25/13 hierarchy; Mv (flat dofs) agrees with it."""
    parts, _, gmg_r, _, (lat, mask_u) = _precond_pair(24, 1.0)
    assert [l.shape for l in parts.gmg.levels] == [(49, 49), (25, 25)]
    rich_r = ref_fused.build_fused_richardson(gmg_r, 2, interpret=True)
    assert rich_r is not None
    r_dof = np.random.default_rng(5).standard_normal((lat.n_dof, 2))
    r_dof[mask_u] = 0.0
    r_grid = np.stack([lat.embed_np(r_dof[:, c], 0.0).reshape(lat.shape) for c in range(2)], axis=-1)
    before = gmg_fused.LAUNCHES_RICHARDSON
    z = parts.Mv_grid(torch.as_tensor(r_grid))
    z_flat = parts.Mv(torch.as_tensor(r_dof.reshape(-1))).reshape(-1, 2)
    assert gmg_fused.LAUNCHES_RICHARDSON == before  # CPU tensors: the plain version
    assert z.dtype == z_flat.dtype == torch.float64 and z.shape == (49, 49, 2)
    for c in range(2):
        z_r = np.asarray(rich_r(jnp.asarray(r_grid[..., c].reshape(-1), dtype=jnp.float32))).reshape(lat.shape)
        np.testing.assert_allclose(z[..., c].numpy(), z_r, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * np.abs(z_r).max())
        np.testing.assert_array_equal(z_flat[:, c].numpy(), z[..., c].reshape(-1)[lat.inv].numpy())
