"""Lattice stencil operators and the stencil kernel's plain version against
the JAX reference (its XLA stencil apply and the Pallas kernel in
interpret mode). The CUDA kernel itself is held against the plain version
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu.solvers.stencil_pallas import stencil_apply_2d as pallas_apply
from pdebench_tpu_torch.solvers import stencil, stencil_kernel


def _local(res, degree, mass=0.0):
    mesh = unit_square_mesh(res)
    V = FunctionSpace(mesh, degree)
    cb = ref_assemble.cell_batch(mesh, degree)
    A = ref_assemble.local_stiffness(cb)
    if mass:
        A = A + mass * np.asarray(ref_assemble.local_mass(cb))
    return np.asarray(A), V


@pytest.mark.parametrize("res,degree", [(12, 1), (10, 2), (8, 3)])
def test_lattice_operator_matches_reference(res, degree):
    A, V = _local(res, degree, mass=0.5)
    ref = ref_stencil.lattice_operator_from_local(
        A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32
    )
    op = stencil.lattice_operator_from_local(
        A, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu", dtype=torch.float32
    )
    assert op.shape == ref.shape == (degree * res + 1,) * 2
    assert op.offsets == ref.offsets
    assert op.pad == ref.pad == degree
    np.testing.assert_array_equal(op.W_f64.numpy(), np.asarray(ref.W_f64))
    np.testing.assert_array_equal(op.W.numpy(), np.asarray(ref.W))
    np.testing.assert_array_equal(op.lattice.perm, ref.lattice.perm)
    np.testing.assert_array_equal(op.lattice.inv, ref.lattice.inv)

    # f64 apply (the refinement outer's residual) at 1e-12
    u = np.random.default_rng(0).standard_normal(op.shape)
    y = op.apply_grid_w(op.W_f64, torch.as_tensor(u)).numpy()
    y_ref = np.asarray(ref.apply_grid_w(ref.W_f64, jnp.asarray(u)))
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    # flat dof-ordered apply
    v = np.random.default_rng(1).standard_normal(V.ndof)
    np.testing.assert_allclose(
        op(torch.as_tensor(v)).numpy(), np.asarray(ref(jnp.asarray(v))),
        rtol=1e-5, atol=1e-5 * np.abs(v).max(),
    )


# shapes and offsets of tests/test_stencil_pallas.py
PALLAS_OFFS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (2, 2), (-2, -1), (1, -2))


@pytest.mark.parametrize("shape,tile", [((37, 41), 16), ((64, 30), 32)])
def test_plain_stencil_matches_pallas_interpret(shape, tile):
    rng = np.random.default_rng(0)
    ny, nx = shape
    pad = 2
    W = rng.standard_normal((len(PALLAS_OFFS), ny, nx)).astype(np.float32)
    u = rng.standard_normal((ny, nx)).astype(np.float32)
    upn = np.pad(u, pad)
    y_ref = np.asarray(
        pallas_apply(jnp.asarray(upn), jnp.asarray(W), PALLAS_OFFS, pad,
                     tile=tile, interpret=True)
    )
    before = stencil_kernel.LAUNCHES
    y = stencil_kernel.stencil_apply_2d(
        torch.as_tensor(upn), torch.as_tensor(W), PALLAS_OFFS, pad
    )
    assert stencil_kernel.LAUNCHES == before  # CPU tensors: plain version
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)


def test_plain_stencil_f64_matches_reference_apply():
    rng = np.random.default_rng(3)
    ny, nx, pad = 41, 29, 3
    offs = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4) if abs(dy) + abs(dx) <= 4]
    W = rng.standard_normal((len(offs), ny, nx))
    u = rng.standard_normal((ny, nx))
    y = stencil_kernel.stencil_apply_2d(
        torch.as_tensor(np.pad(u, pad)), torch.as_tensor(W), offs, pad
    )
    y_ref = np.zeros((ny, nx))
    up = np.pad(u, pad)
    for k, (dy, dx) in enumerate(offs):
        y_ref += W[k] * up[pad + dy : pad + dy + ny, pad + dx : pad + dx + nx]
    assert y.dtype == torch.float64
    assert np.abs(y.numpy() - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


@pytest.mark.parametrize(
    "bad",
    ["u_shape", "tap_beyond_pad", "tap_count", "dtype_mismatch"],
)
def test_stencil_wrapper_rejects_bad_arguments(bad):
    W = torch.zeros((2, 5, 6))
    up = torch.zeros((7, 8))
    offs = [(0, 0), (1, -1)]
    if bad == "u_shape":
        up = torch.zeros((7, 9))
    elif bad == "tap_beyond_pad":
        offs = [(0, 0), (2, 0)]
    elif bad == "tap_count":
        offs = [(0, 0)]
    else:
        up = up.double()
    with pytest.raises(ValueError):
        stencil_kernel.stencil_apply_2d(up, W, offs, 1)


def test_constrain_stencil_weights_matches_reference():
    A, V = _local(9, 2)
    op = stencil.lattice_operator_from_local(
        A, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu"
    )
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    mask_lat = op.lattice.embed_np(mask, True).reshape(op.shape)
    W = op.W_f64.numpy()
    got = stencil.constrain_stencil_weights(W, op.offsets, mask_lat)
    want = ref_stencil.constrain_stencil_weights(W, op.offsets, mask_lat)
    np.testing.assert_array_equal(got, want)


def test_lattice_operator_from_reference_arrays():
    """The reference's stencil arrays carried over: same operator."""
    A, V = _local(10, 2, mass=0.5)
    ref = ref_stencil.lattice_operator_from_local(
        A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32
    )
    lat = stencil.Lattice(
        shape=ref.lattice.shape, perm=ref.lattice.perm, inv=ref.lattice.inv,
        n_dof=ref.lattice.n_dof, masked=ref.lattice.masked,
    )
    op = stencil.LatticeOperator.from_numpy(
        np.asarray(ref.W_f64), ref.offsets, lat, "cpu", dtype=torch.float32
    )
    assert op.pad == ref.pad and op.offsets == ref.offsets
    np.testing.assert_array_equal(op.W.numpy(), np.asarray(ref.W))
    np.testing.assert_array_equal(op.W_f64.numpy(), np.asarray(ref.W_f64))
    v = np.random.default_rng(4).standard_normal(V.ndof)
    np.testing.assert_allclose(
        op(torch.as_tensor(v)).numpy(), np.asarray(ref(jnp.asarray(v))),
        rtol=1e-5, atol=1e-5 * np.abs(v).max(),
    )


def test_detect_lattice_rejects_unstructured_points():
    pts = np.random.default_rng(2).random((50, 2))
    assert stencil.detect_lattice(pts) is None
    assert ref_stencil.detect_lattice(pts) is None
