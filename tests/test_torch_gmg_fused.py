"""Stencil GMG and the fused inner CG's plain version against the JAX
reference: the same hierarchy (handed over with lattice_gmg_from_numpy)
through LatticeGMG.precond and through the Pallas kernel in interpret
mode. The CUDA kernel is held against the plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem.assemble import cell_batch, local_mass, local_stiffness
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers.gmg import attach_lattice_gmg as ref_attach
from pdebench_tpu.solvers.stencil import lattice_operator_from_local as ref_lattice
from pdebench_tpu_torch.solvers import gmg, gmg_fused, stencil

# f32 sums in another order through a V-cycle
TOL_PRECOND = 1e-5
# f32 sums in another order through the PCG recurrence: the tolerance
# tests/test_gmg_fused.py uses
TOL_CG = 2e-4


def _setup(n, degree=1):
    """Reference lattice + GMG on a Poisson-plus-mass operator, and the
    port's copy of the same hierarchy."""
    mesh = unit_square_mesh(n)
    V = FunctionSpace(mesh, degree)
    cb = cell_batch(mesh, degree)
    A = np.asarray(local_stiffness(cb) + 0.5 * local_mass(cb))
    lat = ref_lattice(A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32)
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    ref_attach(lat, mask)
    ref = lat.gmg
    port = gmg.lattice_gmg_from_numpy(
        [
            dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
                 diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
            for l in ref.levels
        ],
        np.asarray(ref.coarse_inv), ref.coarse_shape, "cpu", padded=ref.padded,
    )
    return V, A, lat, mask, ref, port


def _rhs(V, lat, mask, seed):
    r = np.random.default_rng(seed).standard_normal(V.ndof)
    r[mask] = 0.0
    return lat.embedding.embed_np(r.astype(np.float32), 0.0)


def test_scalar_hierarchy_equals_reference():
    V, A, lat, mask, ref, port = _setup(32)
    got = gmg_fused._scalar_hierarchy(port)
    want = ref_fused._scalar_hierarchy(ref)
    lv, lv_ref = got[0], want[0]
    assert [(l.ny, l.nx) for l in lv] == [(l.ny, l.nx) for l in lv_ref]
    assert [(l.ny, l.nx) for l in lv] == [(33, 33), (17, 17)]
    for l, lr in zip(lv, lv_ref):
        assert l.offsets == lr.offsets and l.pad == lr.pad
        # the reference pads to (8, 128) tiles with zeros; the port does not
        np.testing.assert_array_equal(l.W, lr.W[:, : l.ny, : l.nx])
        np.testing.assert_array_equal(l.dinv, lr.dinv[: l.ny, : l.nx])
        assert not lr.W[:, l.ny :, :].any() and not lr.W[:, :, l.nx :].any()
    for bands, bands_ref in zip(got[1:5], want[1:5]):
        for b, br in zip(bands, bands_ref):
            np.testing.assert_array_equal(b, br[: b.shape[0], : b.shape[1]])


def test_port_hierarchy_build_matches_reference():
    """setup_gmg from the port's own lattice operator: same shapes,
    offsets, damping and weights up to f32 rounding."""
    V, A, lat, mask, ref, _ = _setup(32, degree=2)
    op = stencil.lattice_operator_from_local(
        A, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu", dtype=torch.float32
    )
    gmg.attach_lattice_gmg(op, mask)
    mine = op.gmg
    assert not mine.padded and mine.coarse_shape == ref.coarse_shape
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


@pytest.mark.parametrize("n", [32, 48])
def test_precond_matches_reference(n):
    V, A, lat, mask, ref, port = _setup(n)
    r_lat = _rhs(V, lat, mask, 1).reshape(lat.shape)
    z = port.precond()(torch.as_tensor(r_lat)).numpy()
    z_ref = np.asarray(ref.precond()(jnp.asarray(r_lat)))
    assert z.dtype == np.float32
    np.testing.assert_allclose(z, z_ref, rtol=TOL_PRECOND, atol=TOL_PRECOND * np.abs(z_ref).max())


@pytest.mark.parametrize("n", [32, 64])
def test_plain_fused_cg_matches_pallas_interpret(n):
    V, A, lat, mask, ref, port = _setup(n)
    inner_ref = ref_fused.build_fused_inner_cg(ref, 4, interpret=True)
    inner = gmg_fused.build_fused_inner_cg(port, 4, "cpu")
    assert inner_ref is not None and inner is not None
    before = gmg_fused.LAUNCHES
    for seed in (0, 1):
        r_lat = _rhs(V, lat, mask, seed)
        z = inner(torch.as_tensor(r_lat)).numpy()
        z_ref = np.asarray(inner_ref(jnp.asarray(r_lat)))
        np.testing.assert_allclose(z, z_ref, rtol=TOL_CG, atol=TOL_CG * np.abs(z_ref).max())
    assert gmg_fused.LAUNCHES == before  # CPU tensors: plain version


def test_plain_fused_vcycle_step_matches_pallas_interpret():
    """One PCG step, z = alpha V(r): the V-cycle's arithmetic at the
    V-cycle's own tolerance."""
    V, A, lat, mask, ref, port = _setup(32)
    inner_ref = ref_fused.build_fused_inner_cg(ref, 1, interpret=True)
    inner = gmg_fused.build_fused_inner_cg(port, 1, "cpu")
    r_lat = _rhs(V, lat, mask, 3)
    z = inner(torch.as_tensor(r_lat)).numpy()
    z_ref = np.asarray(inner_ref(jnp.asarray(r_lat)))
    np.testing.assert_allclose(z, z_ref, rtol=TOL_PRECOND, atol=TOL_PRECOND * np.abs(z_ref).max())


def test_plain_fused_cg_solves_the_fine_system():
    V, A, lat, mask, ref, port = _setup(48, degree=2)
    inner = gmg_fused.build_fused_inner_cg(port, 12, "cpu")
    r_lat = _rhs(V, lat, mask, 2)
    z = inner(torch.as_tensor(r_lat))
    lv0 = port.levels[0]
    Az = stencil.apply_stencil(lv0.W, lv0.offsets, lv0.pad, z.reshape(lv0.shape))
    rel = float(torch.linalg.norm(torch.as_tensor(r_lat) - Az.reshape(-1)) / np.linalg.norm(r_lat))
    assert rel < 1e-4, rel


def test_fused_cg_rejects_mismatched_input():
    V, A, lat, mask, ref, port = _setup(32)
    inner = gmg_fused.build_fused_inner_cg(port, 2, "cpu")
    with pytest.raises(ValueError):
        inner(torch.zeros(V.ndof, dtype=torch.float64))
    with pytest.raises(ValueError):
        inner(torch.zeros(V.ndof + 1, dtype=torch.float32))
    with pytest.raises(ValueError):
        inner.launch(torch.zeros(V.ndof, dtype=torch.float32))


def test_padded_hierarchy_skips_fused_and_contracts():
    """n=75: the halving chain hits an even axis (76), the hierarchy is
    identity-padded, the fused inner is out of scope, and the V-cycle
    still contracts."""
    V, A, lat, mask, ref, port = _setup(75)
    assert port.padded and any(l.pad_to is not None for l in port.levels)
    assert gmg_fused.build_fused_inner_cg(port, 4, "cpu") is None
    M = port.precond()
    lv0 = port.levels[0]
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(lv0.shape), dtype=torch.float32)
    x = torch.zeros_like(r)
    for _ in range(10):
        x = x + M(r - gmg._device_apply(lv0, x))
    rel = float(torch.linalg.norm(r - gmg._device_apply(lv0, x)) / torch.linalg.norm(r))
    assert rel < 1e-2, rel
    z_ref = np.asarray(ref.precond()(jnp.asarray(r.numpy())))
    np.testing.assert_allclose(M(r).numpy(), z_ref, rtol=TOL_PRECOND, atol=TOL_PRECOND * np.abs(z_ref).max())
