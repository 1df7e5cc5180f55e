"""The linear elasticity slice on the CPU, against the JAX reference:
blocked assembly, the block lattice operator, the block GMG hierarchy and
its V-cycle, dispatch's route and LU fallback, and OracleSolver on dataset
cases.

The port's CPU route runs the fused block inner solve's plain version (an
extra probed coarse level with block-Jacobi sweeps); the reference's CPU
route runs the XLA block V-cycle with a dense coarse inverse. Both refine
to rtol 1e-10 on an SPD operator, so the grids agree far below the 1e-8
held here (the gaps measured on the CPU: 3.5e-15 on the reduced case,
4.4e-12 on linear_elasticity_nu010)."""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem.mesh import unit_square_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.solvers import gmg as ref_gmg
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu_torch.fem import assemble
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.oracle import linear_elasticity as port_le
from pdebench_tpu_torch.solvers import dispatch, gmg, gmg_fused, stencil, stencil_kernel
from pdebench_tpu_torch.solvers.stencil import Lattice

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
GRID_TOL = 1e-8  # relative L2 between the two packages' grids
ERR_TOL = 1e-6  # relative difference of baseline_error
TOL_PRECOND = 1e-5  # f32 sums in another order through one V-cycle
MU, LAM = 1.0 / 2.6, 0.3 / (1.3 * 0.4)  # plane strain, E = 1, nu = 0.3

# case -> (recorded baseline_error, results/oracle_sweep_progress.jsonl;
# the port's CPU inner)
FULL_SIZE = {
    # 121 x 121 P2 nodes, hierarchy 121/61/31: the fused block route
    "linear_elasticity_nu010": (1.5773824748707618e-06, "fused-block-cg-torch"),
    # 101 x 101 nodes, 101 -> 51 -> 26: identity-padded, the PyTorch V-cycle
    "linear_elasticity_near_incompressible_nu049": (2.891007007109636e-06, "stencil-cg"),
}


def _case(case_id):
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] == case_id:
                return c["oracle_config"]
    raise KeyError(case_id)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _space(n, degree, cell_type="triangle"):
    mesh = unit_square_mesh(n, cell_type)
    space = FunctionSpace(mesh, degree, ncomp=2)
    return mesh, space, ref_assemble.cell_batch(mesh, degree), assemble.cell_batch(mesh, degree)


# -- assembly -----------------------------------------------------------------


@pytest.mark.parametrize(
    "n,degree,cell_type,field",
    [
        (6, 1, "triangle", False),  # affine cells, constant Lame: the GEMM path
        (5, 2, "triangle", False),
        (5, 2, "triangle", True),  # per-quadrature-point mu: the einsum path
        (5, 1, "quadrilateral", False),  # non-affine cells: the einsum path
    ],
)
def test_local_elasticity_and_load_match_reference(n, degree, cell_type, field):
    mesh, space, cb_ref, cb = _space(n, degree, cell_type)
    if field:
        q = np.asarray(cb.qpts)
        mu = MU * (1.0 + 0.5 * np.sin(3.0 * q[..., 0]) * q[..., 1])
    else:
        mu = MU
    K = assemble.local_elasticity(cb, mu, LAM)
    K_ref = np.asarray(ref_assemble.local_elasticity(cb_ref, mu, LAM))
    assert K.shape == K_ref.shape == (mesh.n_cells, space.dofmap.shape[1], space.dofmap.shape[1])
    np.testing.assert_allclose(K, K_ref, rtol=1e-12, atol=1e-12 * np.abs(K_ref).max())
    f_q = np.stack([np.cos(cb.qpts[..., 0]), cb.qpts[..., 0] * cb.qpts[..., 1]], axis=-1)
    b = assemble.local_vector_load(cb, f_q)
    b_ref = np.asarray(ref_assemble.local_vector_load(cb_ref, f_q))
    np.testing.assert_allclose(b, b_ref, rtol=1e-12, atol=1e-12 * np.abs(b_ref).max())


# -- the block lattice operator and its hierarchy ------------------------------


def _operators(n, degree, mu=MU, lam=LAM):
    """The reference's f32 block lattice operator with its GMG attached,
    the port's operator from the same cell matrices, and the mask."""
    mesh, space, cb_ref, _ = _space(n, degree)
    K = np.asarray(ref_assemble.local_elasticity(cb_ref, mu, lam))
    ref = ref_stencil.block_lattice_operator_from_local(
        K, space.dofmap, space.ndof, space.dof_coords, 2, dtype=jnp.float32
    )
    port = stencil.block_lattice_operator_from_local(
        K, space.dofmap, space.ndof, space.dof_coords, 2, "cpu", dtype=torch.float32
    )
    mask = np.zeros(space.ndof, bool)
    bs = space.boundary_scalar_dofs
    mask[(bs[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)] = True
    return space, K, ref, port, mask


@pytest.mark.parametrize("n,degree", [(8, 1), (6, 2)])
def test_block_lattice_operator_matches_reference(n, degree):
    space, K, ref, port, _ = _operators(n, degree)
    assert port.offsets == ref.offsets and port.pad == ref.pad
    assert port.grid_shape == ref.grid_shape == ref.shape + (2,)
    np.testing.assert_array_equal(port.W_f64.numpy(), np.asarray(ref.W_f64))
    np.testing.assert_array_equal(port.W.numpy(), np.asarray(ref.W))
    np.testing.assert_array_equal(port.embedding.perm, ref.embedding.perm)
    np.testing.assert_array_equal(port.embedding.inv, ref.embedding.inv)
    u = np.random.default_rng(0).standard_normal(space.ndof)
    y = port(torch.as_tensor(u)).numpy()
    y_ref = np.asarray(ref(jnp.asarray(u)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5 * np.abs(y_ref).max())
    # the f64 outer apply through the stencil kernel's plain version
    u_lat = port.embedding.embed(torch.as_tensor(u), 0.0).reshape(port.grid_shape)
    y64 = port.apply_grid_w(port.W_f64, u_lat).numpy()
    y64_ref = np.asarray(ref.apply_grid_w(ref.W_f64, jnp.asarray(u_lat.numpy())))
    np.testing.assert_allclose(y64, y64_ref, rtol=1e-13, atol=1e-13 * np.abs(y64_ref).max())
    # and the assembled matrix itself
    A = assemble.LocalOperator(torch.as_tensor(K), space.dofmap, space.ndof)
    np.testing.assert_allclose(port.apply_grid_w(port.W_f64, u_lat).reshape(-1)[port.inv_j].numpy(),
                               A(torch.as_tensor(u)).numpy(), rtol=1e-12, atol=1e-12 * np.abs(y64).max())


@pytest.mark.parametrize("weights", ["W", "W_f64"])
@pytest.mark.parametrize("n,degree", [(8, 1), (6, 2)])
def test_block_operator_planes_are_its_weights(n, degree, weights):
    """apply_grid_w with each weight set, one block apply on the
    interleaved field (no per-plane copies of W), is the numpy block apply
    of the same weights, and the block plain version with the same
    parameters; the f32 set also matches the reference's apply."""
    space, _, ref, port, _ = _operators(n, degree)
    W = getattr(port, weights)
    assert port.plan.w_shape == tuple(W.shape) and port.plan.u_shape == port.grid_shape
    u = np.random.default_rng(3).standard_normal(port.grid_shape)
    u_t = torch.as_tensor(u, dtype=W.dtype)
    y = port.apply_grid_w(W, u_t)
    assert y.dtype == W.dtype and tuple(y.shape) == port.grid_shape
    assert torch.equal(y, stencil_kernel.block_stencil_plain(u_t, W, port.offsets, port.pad))
    y_np = gmg._apply_block_np(W.double().numpy(), port.offsets, u)
    tol = 1e-13 if weights == "W_f64" else 1e-5
    np.testing.assert_allclose(y.numpy(), y_np, rtol=tol, atol=tol * np.abs(y_np).max())
    if weights == "W":
        y_ref = np.asarray(ref.apply_grid_w(ref.W, jnp.asarray(u_t.numpy())))
        assert np.abs(y.numpy() - y_ref).max() <= tol * np.abs(y_ref).max()


def test_block_stencil_counts_kernel_launches_only_on_cuda():
    space, K, ref, port, _ = _operators(8, 1)
    before = stencil_kernel.LAUNCHES
    port(torch.zeros(space.ndof, dtype=torch.float32))
    assert stencil_kernel.LAUNCHES == before  # CPU tensors: the plain version


def test_constrain_block_weights_matches_reference():
    space, K, ref, port, mask = _operators(8, 2)
    node_mask = mask.reshape(-1, 2).any(axis=1)
    mask_lat = ref.lattice.embed_np(node_mask, True).reshape(ref.shape)
    W = np.asarray(ref.W, np.float64)
    got = stencil.constrain_stencil_weights(W, port.offsets, mask_lat, d=2)
    want = ref_stencil.constrain_stencil_weights(W, ref.offsets, mask_lat, d=2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "n,degree,padded",
    [
        (24, 2, False),  # 49 -> 25 -> 13
        (50, 1, True),  # 51 -> 26: an even axis, identity-padded
    ],
)
def test_setup_block_gmg_equals_reference(n, degree, padded):
    """The port builds the block hierarchy from its own operator with the
    copied numpy code: the reference's arrays exactly."""
    space, K, ref, port, mask = _operators(n, degree)
    ref_gmg.attach_lattice_gmg(ref, mask)
    gmg.attach_lattice_gmg(port, mask)
    a, b = port.gmg, ref.gmg
    assert isinstance(a, gmg.BlockLatticeGMG) and a.d == b.d == 2
    assert a.padded == b.padded == padded and not a.surrogate
    assert a.coarse_shape == b.coarse_shape and len(a.levels) == len(b.levels)
    for l, lr in zip(a.levels, b.levels):
        assert (l.shape, l.offsets, l.pad, l.pad_to) == (lr.shape, lr.offsets, lr.pad, lr.pad_to)
        assert l.omega == lr.omega
        np.testing.assert_array_equal(l.W.numpy(), np.asarray(lr.W))
        np.testing.assert_array_equal(l.diag_inv.numpy(), np.asarray(lr.diag_inv))
    np.testing.assert_array_equal(a.coarse_inv.numpy(), np.asarray(b.coarse_inv))


@pytest.mark.parametrize("n,degree", [(24, 2), (50, 1)])
def test_block_precond_matches_reference(n, degree):
    """BlockLatticeGMG.precond on the reference's own hierarchy, handed
    over with block_lattice_gmg_from_numpy (the padded one included)."""
    space, K, ref, _, mask = _operators(n, degree)
    ref_gmg.attach_lattice_gmg(ref, mask)
    b = ref.gmg
    port = gmg.block_lattice_gmg_from_numpy(
        [
            dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
                 diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
            for l in b.levels
        ],
        np.asarray(b.coarse_inv), b.coarse_shape, 2, "cpu", padded=b.padded,
    )
    r = np.random.default_rng(1).standard_normal(space.ndof)
    r[mask] = 0.0
    r_lat = ref.embedding.embed_np(r.astype(np.float32), 0.0).reshape(ref.grid_shape)
    z = port.precond()(torch.as_tensor(r_lat)).numpy()
    z_ref = np.asarray(b.precond()(jnp.asarray(r_lat)))
    assert z.dtype == np.float32 and z.shape == r_lat.shape
    np.testing.assert_allclose(z, z_ref, rtol=TOL_PRECOND, atol=TOL_PRECOND * np.abs(z_ref).max())


# -- dispatch ------------------------------------------------------------------


def test_fused_block_gate():
    space, K, ref, port, mask = _operators(24, 2)
    assert not dispatch.fused_block_gate(port)  # no hierarchy yet
    gmg.attach_lattice_gmg(port, mask)
    assert dispatch.fused_block_gate(port) and not dispatch.fused_gate(port)
    _, _, _, padded, mask_p = _operators(50, 1)
    gmg.attach_lattice_gmg(padded, mask_p)
    assert padded.gmg.padded and not dispatch.fused_block_gate(padded)


def test_rerouted_direct_request_takes_host_lu_after_stalled_ir(monkeypatch):
    """preonly/lu on a lattice is rerouted through the IR; when the IR
    stalls on CPU tensors, the host LU answers and the record keeps both
    facts (on CUDA tensors the solve raises)."""
    cfg = _reduced()
    cfg["oracle_solver"] = dict(cfg["oracle_solver"], ksp_type="preonly", pc_type="lu")
    want = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    assert want.solver_info["inner"] == "fused-block-cg-torch"
    assert want.solver_info["direct_rerouted"] == "stencil-ir"

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 40 * 25, 1.0, False, "fused-block-cg-torch"

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    res = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    info = res.solver_info
    assert info["inner"] == "host-lu" and info["method"] == "lu"
    assert info["direct_rerouted"] == "stencil-ir"
    assert info["iterative_failed"]["inner"] == "fused-block-cg-torch"
    assert _rel_l2(res.reference, want.reference) < GRID_TOL


# -- the oracle ----------------------------------------------------------------


def _reduced(res_=32):
    """linear_elasticity_nu030 cut to res 32: P2, 65 x 65 nodes, 8,450
    dofs (above the GMG gate), hierarchy 65/33/17 unpadded, nu = 0.3."""
    cfg = copy.deepcopy(_case("linear_elasticity_nu030"))
    cfg["mesh"]["resolution"] = res_
    return cfg


def _compare(config):
    ref = RefOracle().solve(copy.deepcopy(config))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert res.reference.shape == ref.reference.shape
    assert np.isfinite(res.reference).all()
    assert _rel_l2(res.reference, ref.reference) < GRID_TOL
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.num_dofs == ref.num_dofs
    assert res.solver_info["pde"] == "linear_elasticity"
    assert res.solver_info["lame_lambda"] == ref.solver_info["lame_lambda"]
    assert res.solver_info["lame_mu"] == ref.solver_info["lame_mu"]
    return res, ref


def test_reduced_case_matches_reference():
    before = (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES_BLOCK)
    res, ref = _compare(_reduced())
    info = res.solver_info
    assert res.num_dofs == 8450
    assert info["inner"] == "fused-block-cg-torch"
    assert info["method"] == ref.solver_info["method"] == "cg"
    assert info["pc_used"] == ref.solver_info["pc_used"] == "gmg+stencil-ir32"
    assert "iterative_failed" not in info
    # CPU tensors never launch a kernel
    assert (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES_BLOCK) == before


@pytest.mark.parametrize("case_id", sorted(FULL_SIZE))
def test_full_size_case_matches_reference(case_id):
    recorded, inner = FULL_SIZE[case_id]
    res, ref = _compare(_case(case_id))
    assert res.solver_info["inner"] == inner
    assert res.solver_info["pc_used"] == ref.solver_info["pc_used"] == "gmg+stencil-ir32"
    assert abs(res.baseline_error - recorded) <= ERR_TOL * recorded


@pytest.mark.parametrize(
    "res_,inner,pc",
    [
        # below 5,000 dofs: no hierarchy, Jacobi-preconditioned CG
        (16, "stencil-cg", "jacobi+stencil-ir32"),
        # 51 x 51 nodes: 51 -> 26 lands on an even axis, padded hierarchy
        (25, "stencil-cg", "gmg+stencil-ir32"),
    ],
)
def test_small_case_routes_match_reference(res_, inner, pc):
    res, ref = _compare(_reduced(res_))
    assert res.solver_info["inner"] == inner
    assert res.solver_info["pc_used"] == ref.solver_info["pc_used"] == pc


def test_reference_config_resolve_matches_reference():
    """A case without a manufactured solution: baseline_error against a
    finer re-solve (cut here to res 24 P1 against res 32 P2)."""
    cfg = copy.deepcopy(_case("linear_elasticity_no_exact_body_force"))
    assert "manufactured_solution" not in cfg["pde"]
    cfg["mesh"]["resolution"] = 24
    cfg["reference_config"]["mesh"]["resolution"] = 32
    res, _ = _compare(cfg)
    assert 0.0 < res.baseline_error < 1.0


def test_lame_and_source_match_reference():
    from pdebench_tpu.oracle import linear_elasticity as ref_le

    for params in ({"E": 2.0, "nu": 0.3}, {"lambda": 1.5, "mu": 0.7}, {}):
        assert port_le.lame_from_params(params) == ref_le.lame_from_params(params)
    u = ["sin(pi*x)*y", "x*x*cos(y)"]
    got = port_le.elasticity_source(u, 1.2, 0.4, 2)
    want = ref_le.elasticity_source(u, 1.2, 0.4, 2)
    assert [str(g) for g in got] == [str(w) for w in want]


def test_block_lattice_is_lattice_of_nodes():
    """The block embedding is the node lattice with the component minor:
    lattice dof index = site * 2 + component."""
    space, K, ref, port, mask = _operators(4, 1)
    lat = port.lattice
    assert isinstance(port.embedding, Lattice)
    n = space.ndof
    np.testing.assert_array_equal(port.embedding.inv, lat.inv[np.arange(n) // 2] * 2 + np.arange(n) % 2)


def test_near_incompressible_case_agrees_at_tight_rtol():
    """linear_elasticity_nu499 (nu = 0.499): at the case's rtol 1e-10 the
    two packages' preconditioners stop at solutions whose errors differ
    by ~4e-5 relative (the operator's conditioning); refined to rtol
    1e-13 they agree to 1e-6."""
    cfg = copy.deepcopy(_case("linear_elasticity_nu499"))
    cfg["oracle_solver"] = dict(cfg["oracle_solver"], rtol=1e-13, atol=1e-16)
    res, ref = _compare(cfg)
    assert res.solver_info["inner"] == "fused-block-cg-torch"
