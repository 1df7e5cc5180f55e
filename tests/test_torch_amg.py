"""The port's SA-AMG (pdebench_tpu_torch/solvers/amg.py) and its float64
Krylov solvers against the JAX package's, on the CPU.

The host setup is a copy, so every hierarchy is array-equal: each level's
A and P, diag_inv and omega, and the coarsest level's pseudo-inverse, on a
constrained Poisson stiffness of a small distmesh circle and on the
block-2 rigid-body hierarchy of a small elasticity system. The V-cycle
(PyTorch, padded rows summed in a fixed order) is held to the reference's
`precond()` on the same seeded residual, 1e-12 relative in float64 and
1e-5 in float32; GMRES and BiCGStab to the reference's within 1e-10."""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pdebench_tpu.solvers import amg as ref_amg
from pdebench_tpu.solvers import krylov as ref_krylov
from pdebench_tpu_torch.fem.assemble import local_elasticity, local_stiffness
from pdebench_tpu_torch.oracle import scalar
from pdebench_tpu_torch.solvers import amg, krylov

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the coarsest level's size: below the default 300, so that these small
# systems coarsen twice
COARSE = {"coarse_size": 40}


def _case(case_id, resolution):
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = resolution
    return cfg


def _free_system(case_id, resolution, ncomp=1):
    """(A_ff, the mask, the space) of a dataset case's stiffness on its
    Dirichlet-free dofs, at a cut mesh resolution."""
    cfg = _case(case_id, resolution)
    ctx = scalar.setup_scalar(cfg, "cpu", ncomp=ncomp)
    if ncomp == 1:
        K, dofmap = local_stiffness(ctx.cb), ctx.space.dofmap_scalar
    else:
        K, dofmap = local_elasticity(ctx.cb, 1.0, 2.0), ctx.space.dofmap
    from pdebench_tpu_torch.fem.assemble import LocalOperator

    A = LocalOperator(torch.as_tensor(K), dofmap, ctx.space.ndof).to_scipy()
    mask = ctx.mask.numpy()
    free = np.nonzero(~mask)[0]
    return A, A.tocsr()[free][:, free], mask, ctx.space


def _canon(A):
    A = sps.csr_matrix(A, copy=True)
    A.sum_duplicates()
    A.sort_indices()
    return A


def _assert_same_csr(got, want):
    got, want = _canon(got), _canon(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def _ref_csr(coo):
    return sps.coo_matrix(
        (np.asarray(coo.vals), (np.asarray(coo.rows), np.asarray(coo.cols))), shape=coo.shape
    )


def _assert_same_hierarchy(port, ref):
    assert len(port.levels) == len(ref.levels) >= 2
    for lv, rlv in zip(port.levels, ref.levels):
        _assert_same_csr(lv.A.to_scipy(), _ref_csr(rlv.A))
        _assert_same_csr(lv.P.to_scipy(), _ref_csr(rlv.P))
        _assert_same_csr(lv.R.to_scipy(), _ref_csr(rlv.P).T)
        np.testing.assert_array_equal(lv.diag_inv.numpy(), np.asarray(rlv.diag_inv))
        assert lv.omega == rlv.omega
    np.testing.assert_array_equal(port.coarse_inv.numpy(), np.asarray(ref.coarse_inv))


@pytest.fixture(scope="module")
def poisson_circle():
    """poisson_circle_sinsin's P2 stiffness at resolution 16 (859 dofs)."""
    return _free_system("poisson_circle_sinsin", 16)


@pytest.fixture(scope="module")
def elasticity_circle_hole():
    """le_exp_multiconn_circle_hole's P2 stiffness (lambda 2, mu 1) at
    resolution 12 (1,204 dofs, 2 a node)."""
    return _free_system("le_exp_multiconn_circle_hole", 12, ncomp=-1)


def test_scalar_hierarchy_is_array_equal(poisson_circle):
    _, A_ff, _, _ = poisson_circle
    port, ref = amg.setup_amg(A_ff, **COARSE), ref_amg.setup_amg(A_ff, **COARSE)
    _assert_same_hierarchy(port, ref)
    # each row of a padded level reads zeros past its last entry
    lv = port.levels[0]
    assert lv.A.nnz == A_ff.nnz and lv.A.cols.shape[0] == A_ff.shape[0]


def test_rigid_body_block_hierarchy_is_array_equal(elasticity_circle_hole):
    _, A_ff, mask, V = elasticity_circle_hole
    B = amg.rigid_body_modes(V.dof_coords, V.ncomp)
    np.testing.assert_array_equal(B, ref_amg.rigid_body_modes(V.dof_coords, V.ncomp))
    B_f = B[~mask]
    port = amg.setup_amg(A_ff, B=B_f, block_size=2, **COARSE)
    ref = ref_amg.setup_amg(A_ff, B=B_f, block_size=2, **COARSE)
    _assert_same_hierarchy(port, ref)
    # the coarse levels carry the 3 rigid-body modes per aggregate
    assert port.levels[1].A.shape[0] % 3 == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("system", ["poisson_circle", "elasticity_circle_hole"])
def test_vcycle_matches_reference(system, dtype, request):
    """One V-cycle on a seeded residual: the port's on CPU tensors against
    the reference's `precond()`, each in the full-length masked form that
    its setup_amg_masked_pair builds."""
    A, _, mask, V = request.getfixturevalue(system)
    kw = dict(COARSE) if V.ncomp == 1 else dict(
        COARSE, B=amg.rigid_body_modes(V.dof_coords, V.ncomp), block_size=2
    )
    M64, M32, _ = amg.setup_amg_masked_pair(A, mask, **kw)
    # jitted: the reference's V-cycle op by op takes seconds to dispatch
    R64, R32 = map(jax.jit, ref_amg.setup_amg_masked_pair(A, mask, **kw))
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    if dtype == torch.float64:
        got, want = M64(torch.as_tensor(r)), R64(jnp.asarray(r))
    else:
        got, want = M32(torch.as_tensor(r).float()), R32(jnp.asarray(r, dtype=jnp.float32))
    assert got.dtype == dtype
    got, want = got.double().numpy(), np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


def test_masked_precond_is_the_identity_on_constrained_entries(poisson_circle):
    A, _, mask, _ = poisson_circle
    M64, M32, _ = amg.setup_amg_masked_pair(A, mask, **COARSE)
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(A.shape[0]))
    m = torch.as_tensor(mask)
    for M, rr in ((M64, r), (M32, r.float())):
        z = M(rr)
        assert z.dtype == rr.dtype and torch.equal(z[m], rr[m])
        assert not torch.equal(z[~m], rr[~m])
        # a fixed summation order: the same bits on a second call
        assert torch.equal(M(rr), z)


def _nonsymmetric_system(n=80):
    """A diagonally dominant nonsymmetric system (a 1-D convection-
    diffusion stencil plus a random perturbation) and its Jacobi inverse."""
    rng = np.random.default_rng(11)
    A = 4.0 * np.eye(n) - 1.6 * np.eye(n, k=1) - 0.4 * np.eye(n, k=-1)
    A += 0.05 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    return A, b, 1.0 / np.diag(A)


@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
def test_f64_krylov_matches_reference(method):
    A, b, dinv = _nonsymmetric_system()
    kw = dict(rtol=1e-12, atol=1e-14, maxiter=400)
    if method == "gmres":
        kw["restart"] = 20
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)
    x, info = getattr(krylov, method)(lambda v: At @ v, torch.as_tensor(b), M=lambda r: dt * r, **kw)
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    xr, rinfo = getattr(ref_krylov, method)(lambda v: Aj @ v, jnp.asarray(b), M=lambda r: dj * r, **kw)
    assert info.converged and bool(rinfo.converged)
    assert info.iterations == int(rinfo.iterations)
    xr = np.asarray(xr)
    assert np.abs(x.numpy() - xr).max() <= 1e-10 * np.abs(xr).max()
    np.testing.assert_allclose(A @ x.numpy(), b, rtol=0, atol=1e-10 * np.abs(b).max())
