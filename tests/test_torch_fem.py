"""The port's FEM core against the JAX reference on unit_square P1-P3.

The numpy modules (mesh, spaces, refelem, sampling) are copies, so their
arrays must be equal. Assembly runs numpy in both packages for host
operands (affine fast paths) and torch / jax einsums for device
coefficients: equal to 1e-12 relative (float64 summation order).
"""

import numpy as np
import pytest
import torch

from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem import mesh as ref_mesh
from pdebench_tpu.fem import spaces as ref_spaces
from pdebench_tpu.fem import symbolic as ref_symbolic
from pdebench_tpu_torch.fem import assemble, mesh, spaces, symbolic

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

TOL = 1e-12
CASES = [(8, 1), (16, 1), (8, 2), (12, 2), (8, 3), (16, 3)]
KAPPA = "1 + 0.3*sin(2*pi*x)*cos(2*pi*y)"


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _both(res, degree):
    m_ref = ref_mesh.unit_square_mesh(res)
    m = mesh.unit_square_mesh(res)
    return (
        m_ref, ref_spaces.FunctionSpace(m_ref, degree),
        m, spaces.FunctionSpace(m, degree),
    )


@pytest.mark.parametrize("res,degree", CASES)
def test_mesh_space_dofmap_equal(res, degree):
    m_ref, V_ref, m, V = _both(res, degree)
    np.testing.assert_array_equal(m.coords, m_ref.coords)
    np.testing.assert_array_equal(m.cells, m_ref.cells)
    assert V.ndof == V_ref.ndof == (degree * res + 1) ** 2
    np.testing.assert_array_equal(V.dofmap_scalar, V_ref.dofmap_scalar)
    np.testing.assert_array_equal(V.dof_coords, V_ref.dof_coords)
    np.testing.assert_array_equal(V.boundary_scalar_dofs, V_ref.boundary_scalar_dofs)


@pytest.mark.parametrize("res,degree", CASES)
def test_cell_batch_equal(res, degree):
    m_ref, _, m, _ = _both(res, degree)
    cb_ref = ref_assemble.cell_batch(m_ref, degree)
    cb = assemble.cell_batch(m, degree)
    for name in ("phi", "dphi", "qw", "qpts", "invJ", "detJ"):
        np.testing.assert_array_equal(getattr(cb, name), np.asarray(getattr(cb_ref, name)))
    assert cb.affine_host() is not None


@pytest.mark.parametrize("res,degree", CASES)
def test_local_stiffness_and_load_match(res, degree):
    m_ref, V_ref, m, V = _both(res, degree)
    cb_ref = ref_assemble.cell_batch(m_ref, degree)
    cb = assemble.cell_batch(m, degree)

    # constant coefficient, host operands: the affine GEMM path in both
    K = assemble.local_stiffness(cb)
    K_ref = ref_assemble.local_stiffness(cb_ref)
    assert isinstance(K, np.ndarray)
    assert _rel(K, K_ref) < TOL

    # coefficient evaluated onto the device: torch einsum vs jax einsum
    kap = symbolic.lambdify_spatial(KAPPA, 2, "cpu")(cb.qpts)
    kap_ref = ref_symbolic.lambdify_spatial(KAPPA, 2)(cb_ref.qpts)
    assert isinstance(kap, torch.Tensor) and kap.dtype == torch.float64
    assert _rel(kap.numpy(), kap_ref) < TOL
    Kk = assemble.local_stiffness(cb, kap)
    assert isinstance(Kk, torch.Tensor)
    assert _rel(Kk.numpy(), ref_assemble.local_stiffness(cb_ref, kap_ref)) < TOL

    # load vector through the scatter-add
    f = "2*pi**2*sin(pi*x)*sin(pi*y)"
    fq = symbolic.lambdify_spatial(f, 2, "cpu")(cb.qpts)
    fq_ref = ref_symbolic.lambdify_spatial(f, 2)(cb_ref.qpts)
    b = assemble.scatter_add(
        assemble.local_load(cb, fq),
        torch.as_tensor(V.dofmap_scalar, dtype=torch.int64),
        V.ndof,
    )
    b_ref = ref_assemble.scatter_add(
        ref_assemble.local_load(cb_ref, fq_ref), V_ref.dofmap_scalar, V_ref.ndof
    )
    assert _rel(b.numpy(), b_ref) < TOL


def test_local_operator_and_constraints_match():
    m_ref, V_ref, m, V = _both(10, 2)
    cb = assemble.cell_batch(m, 2)
    K = torch.as_tensor(assemble.local_stiffness(cb))
    op = assemble.LocalOperator(K, V.dofmap_scalar, V.ndof)
    op_ref = ref_assemble.LocalOperator(np.asarray(K.numpy()), V_ref.dofmap_scalar, V_ref.ndof)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(V.ndof)
    assert _rel(op(torch.as_tensor(u)).numpy(), op_ref(u)) < TOL
    assert _rel(op.diagonal().numpy(), op_ref.diagonal()) < TOL
    assert (op.to_scipy() != op_ref.to_scipy()).nnz == 0

    dofs = V.boundary_scalar_dofs
    vals = rng.standard_normal(len(dofs))
    mask, g = assemble.bc_mask_values(V.ndof, dofs, vals, "cpu")
    mask_ref, g_ref = ref_assemble.bc_mask_values(V.ndof, dofs, vals)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    A = assemble.constrained_operator(op, mask)
    A_ref = ref_assemble.constrained_operator(op_ref, mask_ref)
    assert _rel(A(torch.as_tensor(u)).numpy(), A_ref(u)) < TOL
    b = rng.standard_normal(V.ndof)
    r = assemble.constrained_rhs(op, torch.as_tensor(b), mask, g)
    r_ref = ref_assemble.constrained_rhs(op_ref, b, mask_ref, g_ref)
    assert _rel(r.numpy(), r_ref) < TOL


def test_symbolic_mms_source_matches():
    u = "sin(pi*x)*sin(pi*y)"
    src = symbolic.poisson_source(u, KAPPA, 2)
    assert src == ref_symbolic.poisson_source(u, KAPPA, 2)
    pts = np.random.default_rng(1).random((7, 5, 2))
    got = symbolic.lambdify_spatial(src, 2, "cpu")(torch.as_tensor(pts))
    assert tuple(got.shape) == (7, 5)
    assert _rel(got.numpy(), ref_symbolic.lambdify_spatial(src, 2)(pts)) < TOL
    # constants broadcast to the points' shape
    assert tuple(symbolic.lambdify_spatial("2.5", 2, "cpu")(pts).shape) == (7, 5)
