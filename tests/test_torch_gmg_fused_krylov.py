"""The Helmholtz slice's building blocks against the JAX reference.

Kernels #3 (fused Richardson chain) and #6 (fused Arnoldi cycle) through
their plain PyTorch versions, against the Pallas kernels in interpret mode
on the same shifted-Laplacian (surrogate) hierarchy, handed over with
lattice_gmg_from_numpy; the GMRES inner of refined_solve; the surrogate
route of attach_lattice_gmg; local_mass, constrained_csr and
constrain_step_weights. The CUDA kernels are held against the plain
versions on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pdebench_tpu.fem.assemble import cell_batch, local_mass, local_stiffness
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.solvers import amg as ref_amg
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers import krylov as ref_krylov
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu.solvers.gmg import attach_lattice_gmg as ref_attach
from pdebench_tpu_torch.fem import assemble
from pdebench_tpu_torch.solvers import amg, gmg, gmg_fused, krylov, stencil
from pdebench_tpu_torch.solvers.stencil_kernel import stencil_plain

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

K2 = 25.0  # k = 5: indefinite K - k^2 M, surrogate K + k^2 M
# f32 sums in another order through a chain of V-cycles or one Arnoldi
# step: the V-cycle tolerance of tests/test_torch_gmg_fused.py
TOL = 1e-5
# linearity of the Richardson chain (tests/test_gmg_fused.py)
TOL_LINEAR = 2e-4


def _csr(A_local, V):
    dm = np.asarray(V.dofmap_scalar, dtype=np.int64)
    nl = dm.shape[1]
    rows = np.repeat(dm, nl, axis=1).reshape(-1)
    cols = np.tile(dm, (1, nl)).reshape(-1)
    return sps.coo_matrix(
        (np.asarray(A_local).reshape(-1), (rows, cols)), shape=(V.ndof, V.ndof)
    ).tocsr()


def _helmholtz(n, degree=1):
    """Reference lattice of K - k^2 M with its shifted-Laplacian GMG, the
    port's copy of the same hierarchy, and the true constrained f32
    weights (the reference's, as dispatch builds them)."""
    mesh = unit_square_mesh(n)
    V = FunctionSpace(mesh, degree)
    cb = cell_batch(mesh, degree)
    K, M = np.asarray(local_stiffness(cb)), np.asarray(local_mass(cb))
    lat = ref_stencil.lattice_operator_from_local(
        K - K2 * M, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32
    )
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    ref_attach(lat, mask, A_override=_csr(K + K2 * M, V))
    ref = lat.gmg
    assert ref.surrogate and not ref.padded
    port = gmg.lattice_gmg_from_numpy(
        [
            dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
                 diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
            for l in ref.levels
        ],
        np.asarray(ref.coarse_inv), ref.coarse_shape, "cpu",
        padded=ref.padded, surrogate=ref.surrogate,
    )
    keep = jnp.asarray(
        (1.0 - lat.embedding.embed_np(mask, True).astype(np.float32)).reshape(lat.grid_shape)
    )
    W32c = np.asarray(ref_stencil.constrain_step_weights(lat.W.astype(jnp.float32), lat.offsets, keep))
    return V, lat, mask, ref, port, W32c


def _rhs(V, lat, mask, seed):
    r = np.random.default_rng(seed).standard_normal(V.ndof)
    r[mask] = 0.0
    return lat.embedding.embed_np(r.astype(np.float32), 0.0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _true_residual(lat, W32c, r_lat, z):
    u = torch.as_tensor(np.asarray(z)).reshape(lat.shape)
    Az = stencil_plain(u, torch.as_tensor(W32c), lat.offsets, lat.pad).reshape(-1)
    r = torch.as_tensor(r_lat)
    return float(torch.linalg.norm(r - Az) / torch.linalg.norm(r))


# -- kernel #3: the fused Richardson chain ------------------------------


@pytest.mark.parametrize("n,degree", [(32, 1), (48, 1), (24, 2)])
def test_plain_richardson_matches_pallas_interpret(n, degree):
    V, lat, mask, ref, port, _ = _helmholtz(n, degree)
    fused_ref = ref_fused.build_fused_richardson(ref, 2, interpret=True)
    fused = gmg_fused.build_fused_richardson(port, 2, "cpu")
    assert fused_ref is not None and fused is not None and fused.mode == "richardson"
    before = gmg_fused.LAUNCHES_RICHARDSON
    r1, r2 = _rhs(V, lat, mask, 1), _rhs(V, lat, mask, 2)
    z1 = fused(torch.as_tensor(r1)).numpy()
    _close(z1, np.asarray(fused_ref(jnp.asarray(r1))))
    # linear in r, unlike the CG mode
    z2 = fused(torch.as_tensor(r2)).numpy()
    z12 = fused(torch.as_tensor(r1 + 2.0 * r2)).numpy()
    np.testing.assert_allclose(z12, z1 + 2.0 * z2, rtol=TOL_LINEAR, atol=TOL_LINEAR * np.abs(z1).max())
    assert gmg_fused.LAUNCHES_RICHARDSON == before  # CPU tensors: plain version


def test_plain_richardson_one_cycle_is_one_vcycle():
    """One cycle of the chain is the fused V-cycle itself: one PCG step's
    direction before the step length."""
    V, lat, mask, ref, port, _ = _helmholtz(32)
    fused_ref = ref_fused.build_fused_richardson(ref, 1, interpret=True)
    fused = gmg_fused.build_fused_richardson(port, 1, "cpu")
    r = _rhs(V, lat, mask, 3)
    _close(fused(torch.as_tensor(r)).numpy(), np.asarray(fused_ref(jnp.asarray(r))))
    with pytest.raises(ValueError):
        gmg_fused.build_fused_richardson(port, 0, "cpu")


# -- kernel #6: the fused Arnoldi cycle ---------------------------------


def _pallas_raw(ref, lat, m, r, W32c):
    """(V, H, beta) of the Pallas kernel in interpret mode, its (8, 128)
    tile padding cropped."""
    fg = ref_fused.build_fused_inner_gmres(ref, m, interpret=True, step_offsets=lat.offsets)
    Vp, Hout, S = fg.debug_raw(jnp.asarray(r), jnp.asarray(W32c))
    ny, nx = lat.shape
    V = np.asarray(Vp)[:, :ny, :nx].reshape(m + 1, -1)
    return V, np.asarray(Hout)[:, 0, : m + 1].T, float(np.asarray(S)[0, 0])


@pytest.mark.parametrize("m", [1, 4])
def test_plain_arnoldi_matches_pallas_interpret(m):
    """The basis, the Hessenberg matrix and beta per element. The Pallas
    builder takes m >= 4 only: m = 1 is held against its first step."""
    V, lat, mask, ref, port, W32c = _helmholtz(32)
    r = _rhs(V, lat, mask, 4)
    V_ref, H_ref, beta_ref = _pallas_raw(ref, lat, 4, r, W32c)
    fg = gmg_fused.build_fused_inner_gmres(port, m, "cpu", lat.offsets)
    before = gmg_fused.LAUNCHES_GMRES
    Vb, H, beta = fg.raw(torch.as_tensor(r), torch.as_tensor(W32c))
    assert gmg_fused.LAUNCHES_GMRES == before
    assert Vb.shape == (m + 1, V.ndof) and H.shape == (m + 1, m)
    _close(Vb.numpy(), V_ref[: m + 1])
    _close(H.numpy(), H_ref[: m + 1, :m])
    assert abs(float(beta) - beta_ref) <= TOL * abs(beta_ref)


def test_plain_arnoldi_cycle_matches_pallas_interpret():
    """m = 12: float MGS in another order parts the recurrences after a
    few steps, so the correction is held by its true-operator residual,
    and z itself at the looser tolerance of the fused CG's whole solve."""
    V, lat, mask, ref, port, W32c = _helmholtz(48)
    r = _rhs(V, lat, mask, 5)
    fg_ref = ref_fused.build_fused_inner_gmres(ref, 12, interpret=True, step_offsets=lat.offsets)
    fg = gmg_fused.build_fused_inner_gmres(port, 12, "cpu", lat.offsets)
    z_ref = np.asarray(fg_ref(jnp.asarray(r), jnp.asarray(W32c)))
    z = fg(torch.as_tensor(r), torch.as_tensor(W32c)).numpy()
    _close(z, z_ref, tol=2e-4)
    rel, rel_ref = _true_residual(lat, W32c, r, z), _true_residual(lat, W32c, r, z_ref)
    assert rel < 0.05 and rel <= 1.5 * rel_ref, (rel, rel_ref)


def test_arnoldi_on_surrogate_level_zero_misses_the_true_system():
    """The surrogate trap (tests/test_gmg_fused.py): fed hierarchy level 0
    (K + k^2 M) as its operator, the cycle solves the wrong system and
    leaves the TRUE residual far higher than the cycle fed the true
    constrained weights."""
    V, lat, mask, ref, port, W32c = _helmholtz(48)
    r = torch.as_tensor(_rhs(V, lat, mask, 11))
    lv0 = port.levels[0]
    baked = gmg_fused.build_fused_inner_gmres(port, 12, "cpu", lv0.offsets)
    true_op = gmg_fused.build_fused_inner_gmres(port, 12, "cpu", lat.offsets)
    rel_true = _true_residual(lat, W32c, r, true_op(r, torch.as_tensor(W32c)))
    rel_baked = _true_residual(lat, W32c, r, baked(r, lv0.W))
    assert rel_true < 0.05, rel_true
    assert rel_baked > 5 * rel_true, (rel_baked, rel_true)


def test_arnoldi_rejects_mismatched_inputs():
    V, lat, mask, ref, port, W32c = _helmholtz(32)
    fg = gmg_fused.build_fused_inner_gmres(port, 2, "cpu", lat.offsets)
    r = torch.as_tensor(_rhs(V, lat, mask, 6))
    W = torch.as_tensor(W32c)
    with pytest.raises(ValueError):
        fg(r.double(), W)
    with pytest.raises(ValueError):
        fg(r, W[:-1])
    with pytest.raises(ValueError):
        fg.launch_raw(r, W)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError):
        gmg_fused.build_fused_inner_gmres(port, 0, "cpu", lat.offsets)


def test_padded_hierarchy_is_out_of_scope():
    """n = 75: the halving chain hits an even axis; neither new kernel
    takes an identity-padded hierarchy."""
    mesh = unit_square_mesh(75)
    V = FunctionSpace(mesh, 1)
    cb = cell_batch(mesh, 1)
    A = np.asarray(local_stiffness(cb) + 0.5 * local_mass(cb))
    op = stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu", dtype=torch.float32)
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    gmg.attach_lattice_gmg(op, mask)
    assert op.gmg.padded and not op.gmg.surrogate
    assert gmg_fused.build_fused_richardson(op.gmg, 2, "cpu") is None
    assert gmg_fused.build_fused_inner_gmres(op.gmg, 4, "cpu", op.offsets) is None


# -- the GMRES inner of the refinement, and the surrogate hierarchy -----


@pytest.mark.parametrize("n,degree", [(32, 1), (16, 2)])
def test_attach_surrogate_gmg_matches_reference(n, degree):
    """attach_lattice_gmg(A_override=...) in the port: the CSR route, same
    levels, offsets and damping, weights to f32 rounding."""
    mesh = unit_square_mesh(n)
    V = FunctionSpace(mesh, degree)
    cb = assemble.cell_batch(mesh, degree)
    K, M = assemble.local_stiffness(cb), assemble.local_mass(cb)
    op = stencil.lattice_operator_from_local(
        K - K2 * M, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu", dtype=torch.float32
    )
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    gmg.attach_lattice_gmg(op, mask, A_override=_csr(K + K2 * M, V))
    _, _, _, ref, _, _ = _helmholtz(n, degree)
    mine = op.gmg
    assert mine.surrogate and not mine.padded and mine.coarse_shape == ref.coarse_shape
    assert len(mine.levels) == len(ref.levels)
    for l, lr in zip(mine.levels, ref.levels):
        assert l.shape == lr.shape and l.offsets == lr.offsets and l.pad == lr.pad
        assert abs(l.omega - lr.omega) <= 1e-12 * abs(lr.omega)
        np.testing.assert_allclose(l.W.numpy(), np.asarray(lr.W), rtol=1e-6, atol=1e-6 * float(np.abs(lr.W).max()))
        np.testing.assert_allclose(l.diag_inv.numpy(), np.asarray(lr.diag_inv), rtol=1e-6)
    np.testing.assert_allclose(
        mine.coarse_inv.numpy(), np.asarray(ref.coarse_inv), rtol=1e-5,
        atol=1e-5 * float(np.abs(ref.coarse_inv).max()),
    )


def _refine(pkg, lat, W32c, M32, b, inner_iters, max_outer):
    """refined_solve of one package on the lattice system, in lattice
    order: f64 outer with the constrained weights, f32 inner."""
    shape, offs, pad = lat.shape, lat.offsets, lat.pad
    if pkg == "ref":
        W64 = jnp.asarray(W32c, jnp.float64)

        def app(W, v):
            up = jnp.pad(v.reshape(shape), pad)
            out = jnp.zeros(shape, v.dtype)
            for k, (dy, dx) in enumerate(offs):
                out = out + W[k] * up[pad + dy: pad + dy + shape[0], pad + dx: pad + dx + shape[1]]
            return out.reshape(-1)

        W32 = jnp.asarray(W32c)
        x, info = ref_krylov.refined_solve(
            lambda v: app(W64, v), lambda v: app(W32, v), jnp.asarray(b), M32=M32,
            inner_iters=inner_iters, max_outer=max_outer, inner="gmres",
        )
        return np.asarray(x), info
    W64 = torch.as_tensor(W32c).double()
    W32 = torch.as_tensor(W32c)

    def app(W, v):
        return stencil_plain(v.reshape(shape), W, offs, pad).reshape(-1)

    x, info = krylov.refined_solve(
        lambda v: app(W64, v), lambda v: app(W32, v), torch.as_tensor(b), M32=M32,
        inner_iters=inner_iters, max_outer=max_outer, inner="gmres",
    )
    return x.numpy(), info


def test_refined_solve_gmres_inner_matches_reference():
    """The CGS2 Arnoldi inner with the V-cycle preconditioner: one outer
    round (one inner cycle) agrees to f32 rounding through 30 steps, the
    converged solutions to the refinement's rtol."""
    V, lat, mask, ref, port, W32c = _helmholtz(48)
    b = np.random.default_rng(7).standard_normal(V.ndof)
    b[mask] = 0.0
    b_lat = lat.embedding.embed_np(b, 0.0)
    shape = lat.shape
    vc_ref, vc = ref.precond(), port.precond()
    M_ref = lambda r: vc_ref(r.reshape(shape)).reshape(-1)
    M = lambda r: vc(r.reshape(shape)).reshape(-1)
    one_ref, _ = _refine("ref", lat, W32c, M_ref, b_lat, 30, 1)
    one, _ = _refine("port", lat, W32c, M, b_lat, 30, 1)
    _close(one, one_ref, tol=2e-4)
    x_ref, info_ref = _refine("ref", lat, W32c, M_ref, b_lat, 30, 40)
    x, info = _refine("port", lat, W32c, M, b_lat, 30, 40)
    assert info.converged and bool(info_ref.converged)
    assert info.iterations == int(info_ref.iterations)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-8 * np.abs(x_ref).max())


def test_lstsq_hessenberg_matches_dense_least_squares():
    rng = np.random.default_rng(8)
    H = np.triu(rng.standard_normal((13, 12)), -1)
    y = krylov.lstsq_hessenberg(torch.as_tensor(H), torch.tensor(2.5, dtype=torch.float64)).numpy()
    e1 = np.zeros(13)
    e1[0] = 2.5
    np.testing.assert_allclose(y, np.linalg.lstsq(H, e1, rcond=None)[0], rtol=1e-10)
    # a frozen cycle: zero columns leave zero diagonal entries, guarded
    H[:, 6:] = 0.0
    y = krylov.lstsq_hessenberg(torch.as_tensor(H, dtype=torch.float32), torch.tensor(2.5))
    assert torch.isfinite(y).all()


# -- host-side pieces ---------------------------------------------------


@pytest.mark.parametrize("cell_type,degree", [("triangle", 1), ("triangle", 2), ("quadrilateral", 1)])
def test_local_mass_matches_reference(cell_type, degree):
    from pdebench_tpu_torch.fem import mesh as port_mesh

    mesh = unit_square_mesh(6, cell_type=cell_type)
    cb_ref = cell_batch(mesh, degree)
    cb = assemble.cell_batch(port_mesh.unit_square_mesh(6, cell_type=cell_type), degree)
    coef = 1.0 + np.asarray(cb.qpts)[..., 0]
    np.testing.assert_allclose(assemble.local_mass(cb), np.asarray(local_mass(cb_ref)), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        assemble.local_mass(cb, torch.as_tensor(coef)).numpy(),
        np.asarray(local_mass(cb_ref, jnp.asarray(coef))), rtol=1e-12, atol=1e-15,
    )


def test_constrained_csr_equals_reference():
    mesh = unit_square_mesh(10)
    V = FunctionSpace(mesh, 2)
    cb = cell_batch(mesh, 2)
    A = _csr(np.asarray(local_stiffness(cb) + K2 * local_mass(cb)), V)
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    got, want = amg.constrained_csr(A, mask), ref_amg.constrained_csr(A, mask)
    assert (got != want).nnz == 0
    np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("degree", [1, 2])
def test_constrain_step_weights_matches_reference(degree):
    V, lat, mask, ref, port, W32c = _helmholtz(16, degree)
    keep = (1.0 - lat.embedding.embed_np(mask, True).astype(np.float32)).reshape(lat.shape)
    got = stencil.constrain_step_weights(torch.as_tensor(np.asarray(lat.W)), lat.offsets, torch.as_tensor(keep))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), W32c, rtol=1e-12, atol=0)
    # f64 weights too
    W64 = np.asarray(lat.W_f64)
    got64 = stencil.constrain_step_weights(torch.as_tensor(W64), lat.offsets, torch.as_tensor(keep).double())
    want64 = ref_stencil.constrain_step_weights(jnp.asarray(W64), lat.offsets, jnp.asarray(keep, jnp.float64))
    np.testing.assert_allclose(got64.numpy(), np.asarray(want64), rtol=1e-12, atol=0)
