"""The fused block (d = 2) inner solve's plain version against the JAX
reference's Pallas kernel in interpret mode, on the same block hierarchy
(handed over with block_lattice_gmg_from_numpy). The CUDA kernel is held
against the plain version on the card (tests/test_torch_kernels_cuda.py).

The shear modulus varies from cell to cell: with constant Lame parameters
every 2 x 2 tap block of the assembled stencil is symmetric at every
unconstrained site (the coupling's antisymmetric part integrates to a
boundary term that vanishes with the basis function), and a kernel that
read W[k, b, a] for W[k, a, b] would agree with the right one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem.assemble import cell_batch, local_elasticity
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers.gmg import attach_lattice_gmg as ref_attach
from pdebench_tpu.solvers.stencil import block_lattice_operator_from_local as ref_block_lattice
from pdebench_tpu_torch.solvers import gmg, gmg_fused

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

# f32 sums in another order through one V-cycle
TOL_VCYCLE = 1e-5
# f32 sums in another order through the PCG recurrence (the tolerance
# tests/test_gmg_fused.py holds the Pallas kernel to)
TOL_CG = 2e-4
TOL_LINEAR = 2e-4
# plane-strain Lame parameters of E = 1, nu = 0.3
MU = 1.0 / (2.0 * 1.3)
LAM = 0.3 / (1.3 * 0.4)


def port_block_gmg(ref, device="cpu"):
    """The port's copy of a reference BlockLatticeGMG."""
    return gmg.block_lattice_gmg_from_numpy(
        [
            dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
                 diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
            for l in ref.levels
        ],
        np.asarray(ref.coarse_inv), ref.coarse_shape, ref.d, device, padded=ref.padded,
    )


def rough_mu(n_cells, seed=0):
    """A cell-wise shear modulus between MU / 2 and 2 MU: its jumps make
    the per-site 2 x 2 tap blocks non-symmetric."""
    return MU * np.exp(np.random.default_rng(seed).uniform(np.log(0.5), np.log(2.0), n_cells))


def setup_block(n, degree=1, lam=LAM):
    """Reference block lattice + block GMG of an elasticity operator with
    a rough shear modulus and every boundary node clamped, and the port's
    copy of the hierarchy."""
    mesh = unit_square_mesh(n)
    space = FunctionSpace(mesh, degree, ncomp=2)
    cb = cell_batch(mesh, degree)
    K = np.asarray(local_elasticity(cb, rough_mu(mesh.n_cells), lam))
    lat = ref_block_lattice(K, space.dofmap, space.ndof, space.dof_coords, 2, dtype=jnp.float32)
    mask = np.zeros(space.ndof, bool)
    bs = space.boundary_scalar_dofs
    mask[(bs[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)] = True
    ref_attach(lat, mask)
    return space, lat, mask, lat.gmg, port_block_gmg(lat.gmg)


def block_rhs(space, lat, mask, seed):
    r = np.random.default_rng(seed).standard_normal(space.ndof)
    r[mask] = 0.0
    return lat.embedding.embed_np(r.astype(np.float32), 0.0)


@pytest.fixture(scope="module", params=[(32, 1), (24, 2)], ids=["P1-n32", "P2-n24"])
def block(request):
    n, degree = request.param
    return setup_block(n, degree)


def test_tap_blocks_are_not_symmetric(block):
    """The operator these tests run on tells W[k, a, b] from W[k, b, a]."""
    W = np.asarray(block[3].levels[0].W)
    assert np.abs(W - np.swapaxes(W, -1, -2)).max() > 1e-2 * np.abs(W).max()


def test_block_hierarchy_equals_reference(block, monkeypatch):
    """The fused block levels, the probed coarsest one included, are the
    reference builder's arrays without its (8, 128) tile padding."""
    space, lat, mask, ref, port = block
    seen = []

    class Recording(ref_fused._BlockLevel):
        def __init__(self, *args):
            super().__init__(*args)
            seen.append(self)

    monkeypatch.setattr(ref_fused, "_BlockLevel", Recording)
    assert ref_fused.build_fused_block_inner_cg(ref, 1, interpret=True) is not None
    lv, Bry, Brx, Bpy, Bpx = gmg_fused._block_hierarchy(port)
    assert len(lv) == len(seen) == len(port.levels) + 1  # the probed level
    for l, lr in zip(lv, seen):
        assert (l.ny, l.nx, l.pad) == (lr.ny, lr.nx, lr.pad) and l.offsets == lr.offsets
        np.testing.assert_array_equal(l.W, lr.W[..., : l.ny, : l.nx])
        np.testing.assert_array_equal(l.dinv, lr.dinv[..., : l.ny, : l.nx])
        assert not lr.W[..., l.ny :, :].any() and not lr.W[..., l.nx :].any()
    for bands in (Bry, Brx, Bpy, Bpx):
        assert len(bands) == len(lv) - 1


def _pair(port, ref, iters, mode="cg"):
    inner = gmg_fused.build_fused_block_inner_cg(port, iters, "cpu", mode=mode)
    inner_ref = ref_fused.build_fused_block_inner_cg(ref, iters, interpret=True, mode=mode)
    assert inner is not None and inner_ref is not None
    return inner, inner_ref


def test_plain_block_pcg_step_matches_pallas_interpret(block):
    """One PCG step, z = alpha V(r): the block V-cycle element by element."""
    space, lat, mask, ref, port = block
    inner, inner_ref = _pair(port, ref, 1)
    r_lat = block_rhs(space, lat, mask, 3)
    before = gmg_fused.LAUNCHES_BLOCK
    z = inner(torch.as_tensor(r_lat)).numpy()
    assert gmg_fused.LAUNCHES_BLOCK == before  # CPU tensors: plain version
    z_ref = np.asarray(inner_ref(jnp.asarray(r_lat)))
    np.testing.assert_allclose(z, z_ref, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * np.abs(z_ref).max())


def test_plain_block_step_reads_smoother_blocks_untransposed():
    """The diagonal blocks of a symmetric operator are symmetric; with an
    antisymmetric part added to every level's block inverse diagonal (on
    both packages' hierarchies), one PCG step tells D[a, b] from D[b, a]."""
    space, lat, mask, ref, _ = setup_block(32)
    rng = np.random.default_rng(11)
    for i, lv in enumerate(ref.levels):
        D = np.array(lv.diag_inv)
        s = np.abs(D).max() * rng.uniform(0.0, 0.2, D.shape[:-2])
        D[..., 0, 1] += s
        D[..., 1, 0] -= s
        ref.levels[i] = dataclasses.replace(lv, diag_inv=jnp.asarray(D))
    port = port_block_gmg(ref)
    D0 = np.asarray(port.levels[0].diag_inv)
    assert np.abs(D0[..., 0, 1] - D0[..., 1, 0]).max() > 1e-2 * np.abs(D0).max()
    inner, inner_ref = _pair(port, ref, 1)
    r_lat = block_rhs(space, lat, mask, 12)
    z = inner(torch.as_tensor(r_lat)).numpy()
    z_ref = np.asarray(inner_ref(jnp.asarray(r_lat)))
    np.testing.assert_allclose(z, z_ref, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * np.abs(z_ref).max())


def test_plain_block_pcg_matches_pallas_interpret(block):
    space, lat, mask, ref, port = block
    inner, inner_ref = _pair(port, ref, 12)
    r_lat = block_rhs(space, lat, mask, 4)
    z = inner(torch.as_tensor(r_lat)).numpy()
    z_ref = np.asarray(inner_ref(jnp.asarray(r_lat)))
    np.testing.assert_allclose(z, z_ref, rtol=TOL_CG, atol=TOL_CG * np.abs(z_ref).max())


@pytest.mark.parametrize("cycles", [1, 2])
def test_plain_block_richardson_matches_pallas_interpret(block, cycles):
    space, lat, mask, ref, port = block
    inner, inner_ref = _pair(port, ref, cycles, mode="richardson")
    r1, r2 = block_rhs(space, lat, mask, 5), block_rhs(space, lat, mask, 6)
    before = gmg_fused.LAUNCHES_BLOCK_RICHARDSON
    z1 = inner(torch.as_tensor(r1))
    assert gmg_fused.LAUNCHES_BLOCK_RICHARDSON == before
    z_ref = np.asarray(inner_ref(jnp.asarray(r1)))
    scale = np.abs(z_ref).max()
    np.testing.assert_allclose(z1.numpy(), z_ref, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    # linear in r
    z12 = inner(torch.as_tensor(r1 + 2.0 * r2))
    z2 = inner(torch.as_tensor(r2))
    np.testing.assert_allclose(z12.numpy(), (z1 + 2.0 * z2).numpy(), rtol=TOL_LINEAR, atol=TOL_LINEAR * scale)


def test_plain_block_pcg_solves_the_fine_system():
    space, lat, mask, ref, port = setup_block(32)
    inner = gmg_fused.build_fused_block_inner_cg(port, 12, "cpu")
    r_lat = block_rhs(space, lat, mask, 7)
    z = inner(torch.as_tensor(r_lat))
    lv0 = port.levels[0]
    Az = gmg._device_apply_block(lv0, z.reshape(lv0.shape + (2,)))
    rel = float(np.linalg.norm(r_lat - Az.reshape(-1).numpy()) / np.linalg.norm(r_lat))
    # the bound tests/test_gmg_fused.py holds the Pallas kernel to
    assert rel < 1e-3, rel


def test_block_builder_scope():
    """Scalar and padded hierarchies are out of the block kernel's scope,
    block ones out of the scalar kernels'; bad inputs raise."""
    space, lat, mask, ref, port = setup_block(32)
    assert gmg_fused.build_fused_inner_cg(port, 4, "cpu") is None
    inner = gmg_fused.build_fused_block_inner_cg(port, 2, "cpu")
    with pytest.raises(ValueError):
        inner(torch.zeros(space.ndof, dtype=torch.float64))
    with pytest.raises(ValueError):
        inner(torch.zeros(space.ndof // 2, dtype=torch.float32))
    with pytest.raises(ValueError):
        inner.launch(torch.zeros(space.ndof, dtype=torch.float32))
    # n = 50: 51 -> 26 lands on an even axis, the hierarchy is padded
    _, _, _, ref_p, port_p = setup_block(50)
    assert port_p.padded and gmg_fused.build_fused_block_inner_cg(port_p, 4, "cpu") is None
