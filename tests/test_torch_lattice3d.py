"""3-D lattices (unit_cube) in the port against the JAX reference.

(a) the 3-D lattice operator, its apply and its constrained weights;
(b) the 3-D GMG hierarchy, and the fused kernels' level data against the
    reference's slab-packed `_Level3` planes once their padding is cropped;
(c) the plain versions of kernels #2, #3 and #6 in 3-D against the Pallas
    kernels in interpret mode, on unit_cube n = 10 P1 (the shapes of
    tests/test_gmg_fused.py) and on a P2 hierarchy whose fine level has 65
    taps;
(d) OracleSolver(device="cpu") against the reference on dataset cases at
    cut mesh resolutions, the reference pinned to its lattice route
    (PDEBENCH_TPU_FORCE_STENCIL=1: its own CPU branch takes 3-D cases to
    AMG, which the port does not have), and the reference's error of the
    configuration chip_smoke.py holds the card's kernel #3 route to;
(e) the dispatch gates.

The CUDA kernels are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import copy
import json
import types
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from pdebench_tpu.fem.assemble import cell_batch, local_advection, local_mass, local_stiffness
from pdebench_tpu.fem.mesh import unit_cube_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.solvers import gmg_fused as ref_fused
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu.solvers.gmg import attach_lattice_gmg as ref_attach
from pdebench_tpu_torch.oracle import OracleSolver, scalar
from pdebench_tpu_torch.solvers import dispatch, gmg, gmg_fused, stencil, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data" / "benchmark_v2.jsonl"
# f32 sums in another order through one V-cycle or one Arnoldi step
TOL_VCYCLE = 1e-5
# f32 sums in another order through the PCG recurrence (tests/test_gmg_fused.py)
TOL_CG = 2e-4
# linearity of the Richardson chain (tests/test_gmg_fused.py)
TOL_LINEAR = 2e-4
# end to end: relative L2 between the two packages' grids, and the
# relative difference of baseline_error
GRID_TOL = 1e-8
ERR_TOL = 1e-6
K2 = 25.0  # the surrogate K + k^2 M of a k = 5 Helmholtz operator


def _space(n, degree):
    mesh = unit_cube_mesh(n)
    return FunctionSpace(mesh, degree), cell_batch(mesh, degree)


def _mask(V):
    mask = np.zeros(V.ndof, bool)
    mask[V.boundary_scalar_dofs] = True
    return mask


def _csr(A_local, V):
    dm = np.asarray(V.dofmap_scalar, dtype=np.int64)
    nl = dm.shape[1]
    rows = np.repeat(dm, nl, axis=1).reshape(-1)
    cols = np.tile(dm, (1, nl)).reshape(-1)
    return sps.coo_matrix(
        (np.asarray(A_local).reshape(-1), (rows, cols)), shape=(V.ndof, V.ndof)
    ).tocsr()


def _port_copy(ref):
    """The port's copy of a reference LatticeGMG."""
    return gmg.lattice_gmg_from_numpy(
        [
            dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
                 diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
            for l in ref.levels
        ],
        np.asarray(ref.coarse_inv), ref.coarse_shape, "cpu",
        padded=ref.padded, surrogate=ref.surrogate,
    )


def _setup(n, degree=1, advect=False):
    """Reference lattice of K + 0.5 M (or K + an advection term) with its
    GMG on unit_cube n, and the port's copy of the same hierarchy."""
    V, cb = _space(n, degree)
    A = local_stiffness(cb) + 0.5 * local_mass(cb)
    if advect:
        ones = jnp.ones_like(cb.qpts[..., 0])
        A = local_stiffness(cb) + local_advection(cb, jnp.stack([ones, 0.5 * ones, 0.25 * ones], axis=-1))
    lat = ref_stencil.lattice_operator_from_local(
        np.asarray(A), V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32
    )
    mask = _mask(V)
    ref_attach(lat, mask)
    assert len(lat.shape) == 3 and not lat.gmg.padded
    return V, lat, mask, lat.gmg, _port_copy(lat.gmg)


@pytest.fixture(scope="module")
def p1_10():
    return _setup(10)


@pytest.fixture(scope="module")
def p2_6():
    return _setup(6, degree=2)


@pytest.fixture(scope="module")
def advected():
    return _setup(10, advect=True)


# the Pallas Arnoldi cycle at m = 12 on the advected operator, built once:
# its first step is the m = 1 reference, its whole cycle the m = 12 one
ARNOLDI_M = 12


@pytest.fixture(scope="module")
def pallas_arnoldi(advected):
    return ref_fused.build_fused_inner_gmres(advected[3], ARNOLDI_M, vmem_budget=10**10, interpret=True)


def _rhs(V, lat, mask, seed):
    r = np.random.default_rng(seed).standard_normal(V.ndof)
    r[mask] = 0.0
    return lat.embedding.embed_np(r.astype(np.float32), 0.0)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _residual(W, offsets, r_lat, z, shape):
    """||r - W z|| / ||r|| of a 3-D stencil with the lattice's taps."""
    pad = max(abs(o) for off in offsets for o in off)
    u = torch.as_tensor(np.asarray(z)).reshape(shape)
    Az = stencil_kernel.stencil_plain(u, torch.as_tensor(np.asarray(W)), offsets, pad).reshape(-1)
    r = torch.as_tensor(r_lat)
    return float(torch.linalg.norm(r - Az) / torch.linalg.norm(r))


# -- (a) the 3-D lattice operator ------------------------------------------


@pytest.mark.parametrize("degree", [1, 2])
def test_lattice_operator_3d_equals_reference(degree):
    V, cb = _space(4, degree)
    A = np.asarray(local_stiffness(cb) + K2 * local_mass(cb))
    ref = ref_stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float64)
    op = stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu")
    assert op.shape == ref.shape == (4 * degree + 1,) * 3
    assert op.offsets == [tuple(o) for o in ref.offsets] and op.pad == ref.pad
    assert len(op.offsets) == {1: 15, 2: 65}[degree]
    np.testing.assert_array_equal(op.W_f64.numpy(), np.asarray(ref.W_f64))
    u = np.random.default_rng(0).standard_normal(op.shape)
    got = op.apply_grid_w(op.W_f64, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply_grid_w(ref.W_f64, jnp.asarray(u))), rtol=1e-13, atol=1e-13)
    # the flat-dof apply goes through the lattice permutation
    x = np.random.default_rng(1).standard_normal(V.ndof)
    np.testing.assert_allclose(op(torch.as_tensor(x)).numpy(), _csr(A, V) @ x, rtol=1e-12, atol=1e-12)


def test_stencil_apply_3d_wrapper():
    """The stencil kernel's plan on a 3-D lattice: CPU tensors take the
    plain version (no launch counted), which is the reference's XLA apply;
    malformed arguments raise before any launch."""
    V, cb = _space(3, 2)
    A = np.asarray(local_stiffness(cb) + K2 * local_mass(cb))
    ref = ref_stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float64)
    W, offs, pad = torch.as_tensor(np.asarray(ref.W_f64)), [tuple(o) for o in ref.offsets], ref.pad
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(ref.shape))
    plan = stencil_kernel.StencilPlan(ref.shape, offs, pad)
    before = stencil_kernel.LAUNCHES
    y = plan(W, u)
    assert stencil_kernel.LAUNCHES == before
    np.testing.assert_allclose(y.numpy(), np.asarray(ref.apply_grid_w(ref.W_f64, jnp.asarray(u.numpy()))), rtol=1e-13, atol=1e-13)
    bad_plans = {
        "tap_beyond_pad": (ref.shape, offs[:-1] + [(pad + 1, 0, 0)], pad),
        "two_d_taps": (ref.shape, [o[1:] for o in offs], pad),
    }
    for args in bad_plans.values():
        with pytest.raises(ValueError):
            stencil_kernel.StencilPlan(*args)
    bad_calls = {
        "u_shape": (W, u[:-1]),
        "tap_count": (W[:-1], u),
        "dtype": (W, u.float()),
    }
    for args in bad_calls.values():
        with pytest.raises(ValueError):
            plan(*args)


@pytest.mark.parametrize("degree", [1, 2])
def test_constrained_weights_3d_equal_reference(degree):
    V, cb = _space(4, degree)
    A = np.asarray(local_stiffness(cb) + K2 * local_mass(cb))
    ref = ref_stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float64)
    mask_lat = ref.embedding.embed_np(_mask(V), True).reshape(ref.shape)
    W = np.asarray(ref.W_f64)
    np.testing.assert_array_equal(
        stencil.constrain_stencil_weights(W, ref.offsets, mask_lat),
        ref_stencil.constrain_stencil_weights(W, ref.offsets, mask_lat),
    )
    keep = (1.0 - mask_lat).astype(np.float64)
    got = stencil.constrain_step_weights(torch.as_tensor(W), ref.offsets, torch.as_tensor(keep))
    want = ref_stencil.constrain_step_weights(jnp.asarray(W), ref.offsets, jnp.asarray(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- (b) the 3-D hierarchy -------------------------------------------------


@pytest.mark.parametrize("surrogate", [False, True])
def test_hierarchy_3d_build_matches_reference(surrogate):
    """attach_lattice_gmg on the port's own 3-D P2 operator (13^3, 65 taps),
    with and without a surrogate (A_override): same shapes, offsets,
    damping, weights up to f32 rounding."""
    V, cb = _space(6, 2)
    K, M = np.asarray(local_stiffness(cb)), np.asarray(local_mass(cb))
    A = K - K2 * M if surrogate else K + 0.5 * M
    override = _csr(K + K2 * M, V) if surrogate else None
    mask = _mask(V)
    op = stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, "cpu", dtype=torch.float32)
    gmg.attach_lattice_gmg(op, mask, A_override=override)
    lat = ref_stencil.lattice_operator_from_local(A, V.dofmap_scalar, V.ndof, V.dof_coords, dtype=jnp.float32)
    ref_attach(lat, mask, A_override=override)
    mine, ref = op.gmg, lat.gmg
    assert mine.surrogate == ref.surrogate == surrogate
    assert not mine.padded and mine.coarse_shape == ref.coarse_shape == (7, 7, 7)
    assert len(mine.levels) == len(ref.levels) == 1
    for l, lr in zip(mine.levels, ref.levels):
        assert l.shape == lr.shape == (13, 13, 13)
        assert l.offsets == tuple(tuple(o) for o in lr.offsets) and len(l.offsets) == 65
        assert abs(l.omega - lr.omega) <= 1e-12 * abs(lr.omega)
        np.testing.assert_allclose(l.W.numpy(), np.asarray(lr.W), rtol=1e-6, atol=1e-6 * float(np.abs(lr.W).max()))
        np.testing.assert_allclose(l.diag_inv.numpy(), np.asarray(lr.diag_inv), rtol=1e-6)
    np.testing.assert_allclose(
        mine.coarse_inv.numpy(), np.asarray(ref.coarse_inv), rtol=1e-5,
        atol=1e-5 * float(np.abs(ref.coarse_inv).max()),
    )
    # the V-cycle of the hierarchy
    r = np.random.default_rng(2).standard_normal(mine.levels[0].shape).astype(np.float32)
    z_ref = np.asarray(ref.precond()(jnp.asarray(r)))
    _close(mine.precond()(torch.as_tensor(r)).numpy(), z_ref, TOL_VCYCLE)


@pytest.mark.parametrize("shape, reach", [((17, 17), 1), ((13, 21), 2), ((9, 9, 9), 1), ((11, 9, 13), 2)])
def test_coarsen_stencil_equals_reference(shape, reach):
    """The Galerkin coarse stencil R A P of a random stencil, 2-D and 3-D,
    reach 1 and 2: bit for bit the reference's (the port picks each coarse
    weight out of the comb responses in one indexed gather a tap)."""
    import itertools

    from pdebench_tpu.solvers.gmg import _coarsen_stencil as ref_coarsen

    offs = list(itertools.product(range(-reach, reach + 1), repeat=len(shape)))
    W = np.random.default_rng(3).standard_normal((len(offs),) + shape)
    Wc, offs_c, shape_c = gmg._coarsen_stencil(W, offs, shape)
    rWc, roffs_c, rshape_c = ref_coarsen(W, offs, shape)
    assert offs_c == roffs_c and shape_c == rshape_c
    np.testing.assert_array_equal(Wc, rWc)


def _rows(lr):
    """The slab-packed rows of a reference _Level3 that hold lattice sites."""
    nz, ny, _ = lr.shape3
    return (np.arange(nz)[:, None] * lr.nyp_s + np.arange(ny)[None, :]).reshape(-1)


def _crop3(a, lr):
    """A reference _Level3 plane (nyp, nxp), or planes (K, nyp, nxp),
    back to (nz, ny, nx) by dropping its inter-slab and tile padding."""
    return a[..., _rows(lr), : lr.shape3[2]].reshape(a.shape[:-2] + lr.shape3)


@pytest.mark.parametrize("setup", ["p1_10", "p2_6"])
def test_scalar_hierarchy_3d_equals_reference(setup, request):
    V, lat, mask, ref, port = request.getfixturevalue(setup)
    got = gmg_fused._scalar_hierarchy(port)
    lv, (Bry, Brx, Bpy, Bpx, Brz, Bpz) = got[0], got[1:]
    lv_ref, By_ref, Bx_ref, Py_ref, Px_ref = ref_fused._scalar_hierarchy(ref)[:5]
    assert [l.shape for l in lv] == [l.shape3 for l in lv_ref]
    assert len(lv) == len(ref.levels) + 1  # the probed coarsest level
    for l, lr in zip(lv, lv_ref):
        assert l.nz == lr.shape3[0] and l.pad == lr.pad
        # the reference flattens (dz, dy, dx) into slab rows dz * nyp_s + dy
        assert [(dz * lr.nyp_s + dy, dx) for dz, dy, dx in l.offsets] == lr.offsets
        np.testing.assert_array_equal(l.W, _crop3(lr.W, lr))
        np.testing.assert_array_equal(l.dinv, _crop3(lr.dinv, lr))
        # the padding the port drops is zero
        pad = np.ones(lr.dinv.shape, bool)
        pad[np.ix_(_rows(lr), np.arange(lr.shape3[2]))] = False
        assert not lr.W[:, pad].any() and not lr.dinv[pad].any()
    for i, (f, c) in enumerate(zip(lv_ref[:-1], lv_ref[1:])):
        # kron(Bz, By) at slab rows, Bx on columns
        rc = (np.arange(c.shape3[0])[:, None] * c.nyp_s + np.arange(c.shape3[1])[None, :]).reshape(-1)
        rf = (np.arange(f.shape3[0])[:, None] * f.nyp_s + np.arange(f.shape3[1])[None, :]).reshape(-1)
        np.testing.assert_array_equal(np.kron(Brz[i], Bry[i]), By_ref[i][np.ix_(rc, rf)])
        np.testing.assert_array_equal(np.kron(Bpz[i], Bpy[i]), Py_ref[i][np.ix_(rf, rc)])
        np.testing.assert_array_equal(Brx[i], Bx_ref[i][: Brx[i].shape[0], : Brx[i].shape[1]])
        np.testing.assert_array_equal(Bpx[i], Px_ref[i][: Bpx[i].shape[0], : Bpx[i].shape[1]])


# -- (c) the kernels' plain versions against Pallas in interpret mode ------


def _pallas_cg(ref, iters, mode="cg"):
    # no VMEM budget: the port has none, and the 65-tap level exceeds 10 MB
    return ref_fused.build_fused_inner_cg(ref, iters, vmem_budget=10**10, interpret=True, mode=mode)


@pytest.mark.parametrize("setup", ["p1_10", "p2_6"])
def test_plain_fused_cg_3d_one_step_matches_pallas_interpret(setup, request):
    """One PCG step, z = alpha V(r): the 3-D V-cycle at its own tolerance."""
    V, lat, mask, ref, port = request.getfixturevalue(setup)
    inner = gmg_fused.build_fused_inner_cg(port, 1, "cpu")
    r = _rhs(V, lat, mask, 3)
    before = gmg_fused.LAUNCHES
    z = inner(torch.as_tensor(r)).numpy()
    assert gmg_fused.LAUNCHES == before  # CPU tensors: plain version
    _close(z, np.asarray(_pallas_cg(ref, 1)(jnp.asarray(r))), TOL_VCYCLE)


@pytest.mark.parametrize("setup", ["p1_10", "p2_6"])
def test_plain_fused_cg_3d_matches_pallas_interpret(setup, request):
    """12 PCG steps: the whole inner solve, and its residual on level 0."""
    V, lat, mask, ref, port = request.getfixturevalue(setup)
    inner = gmg_fused.build_fused_inner_cg(port, 12, "cpu")
    r = _rhs(V, lat, mask, 4)
    z = inner(torch.as_tensor(r)).numpy()
    _close(z, np.asarray(_pallas_cg(ref, 12)(jnp.asarray(r))), TOL_CG)
    lv0 = port.levels[0]
    assert _residual(lv0.W, lv0.offsets, r, z, lv0.shape) < 1e-3


@pytest.mark.parametrize("cycles", [1, 2])
def test_plain_richardson_3d_matches_pallas_interpret(p1_10, cycles):
    V, lat, mask, ref, port = p1_10
    rich = gmg_fused.build_fused_richardson(port, cycles, "cpu")
    pallas = _pallas_cg(ref, cycles, mode="richardson")
    r1, r2 = _rhs(V, lat, mask, 5), _rhs(V, lat, mask, 6)
    z1 = rich(torch.as_tensor(r1)).numpy()
    _close(z1, np.asarray(pallas(jnp.asarray(r1))), TOL_VCYCLE)
    z2 = rich(torch.as_tensor(r2)).numpy()
    z12 = rich(torch.as_tensor(r1 + 2.0 * r2)).numpy()
    np.testing.assert_allclose(z12, z1 + 2.0 * z2, rtol=TOL_LINEAR, atol=TOL_LINEAR * np.abs(z1).max())


def _pack(lr, a):
    """(…, nz, ny, nx) -> the reference's slab-packed (…, nz * nyp_s, nx)
    rows, which its debug_raw pads on to the full tile."""
    nz, ny, nx = lr.shape3
    out = np.zeros(a.shape[:-3] + (nz, lr.nyp_s, nx), np.float32)
    out[..., :ny, :] = a
    return out.reshape(a.shape[:-3] + (nz * lr.nyp_s, nx))


def test_plain_arnoldi_3d_step_matches_pallas_interpret(advected, pallas_arnoldi):
    """m = 1: the basis, the Hessenberg column and beta per element,
    against the first step of the Pallas cycle (its builder takes m >= 4).
    The operator is the hierarchy's level 0 with its own taps, as the
    reference's kernel without step_offsets uses it."""
    V, lat, mask, ref, port = advected
    r = _rhs(V, lat, mask, 7)
    lv0 = port.levels[0]
    fg = gmg_fused.build_fused_inner_gmres(port, 1, "cpu", lv0.offsets)
    Vb, H, beta = fg.raw(torch.as_tensor(r), lv0.W)
    m = ARNOLDI_M
    lr = ref_fused._scalar_hierarchy(ref)[0][0]
    Vp, Hout, S = pallas_arnoldi.debug_raw(jnp.asarray(_pack(lr, r.reshape(lv0.shape)).reshape(-1)))
    V_ref = _crop3(np.asarray(Vp), lr).reshape(m + 1, -1)
    H_ref = np.asarray(Hout)[:, 0, : m + 1].T
    _close(Vb.numpy(), V_ref[:2], TOL_VCYCLE)
    _close(H.numpy(), H_ref[:2, :1], TOL_VCYCLE)
    assert abs(float(beta) - float(np.asarray(S)[0, 0])) <= TOL_VCYCLE * abs(float(np.asarray(S)[0, 0]))


def test_plain_arnoldi_3d_cycle_matches_pallas_interpret(advected, pallas_arnoldi):
    """m = 12 on the advected operator (tests/test_gmg_fused.py): float MGS
    in another order parts the recurrences, so the correction is held by
    its true-operator residual, and z at the whole-solve tolerance."""
    V, lat, mask, ref, port = advected
    r = _rhs(V, lat, mask, 8)
    lv0 = port.levels[0]
    z = gmg_fused.build_fused_inner_gmres(port, ARNOLDI_M, "cpu", lv0.offsets)(torch.as_tensor(r), lv0.W).numpy()
    z_ref = np.asarray(pallas_arnoldi(jnp.asarray(r)))
    _close(z, z_ref, TOL_CG)
    rel = _residual(lv0.W, lv0.offsets, r, z, lv0.shape)
    rel_ref = _residual(lv0.W, lv0.offsets, r, z_ref, lv0.shape)
    assert rel < 1e-2 and rel <= 1.5 * rel_ref, (rel, rel_ref)


def test_fused_builders_take_65_taps(p2_6):
    """A 3-D P2 fine level has 65 taps, above the 2-D kernels' old limit
    of 64: every builder takes it, and the kernels' level arrays carry
    three ints per tap."""
    port = p2_6[4]
    assert len(port.levels[0].offsets) == 65
    for f in (
        gmg_fused.build_fused_inner_cg(port, 25, "cpu"),
        gmg_fused.build_fused_richardson(port, 2, "cpu"),
        gmg_fused.build_fused_inner_gmres(port, 30, "cpu", port.levels[0].offsets),
    ):
        assert f.shape == (13, 13, 13) and f.sites == 13**3
        work, ptrs, dims, offs = f._level_arrays()
        assert dims.tolist() == [[13, 13, 13, 65], [7, 7, 7, 27]]
        assert offs.reshape(-1, 3).tolist() == [list(o) for l in f.offsets for o in l]
        assert [w.shape for w in work] == [(3, 13**3), (3, 7**3)]


# -- (d) end to end --------------------------------------------------------


def _case(case_id, resolution=None):
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] == case_id:
                cfg = c["oracle_config"]
                if resolution is not None:
                    cfg["mesh"]["resolution"] = resolution
                return cfg
    raise KeyError(case_id)


def _compare(config, monkeypatch):
    monkeypatch.setenv("PDEBENCH_TPU_FORCE_STENCIL", "1")
    ref = RefOracle().solve(copy.deepcopy(config))
    res = OracleSolver(device="cpu").solve(copy.deepcopy(config))
    assert res.reference.shape == ref.reference.shape == (25, 25, 25)
    assert np.isfinite(res.reference).all()
    gap = np.linalg.norm(res.reference - ref.reference) / np.linalg.norm(ref.reference)
    assert gap < GRID_TOL, gap
    assert abs(res.baseline_error - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert res.num_dofs == ref.num_dofs
    assert ref.solver_info["pc_used"] == "gmg+stencil-ir32"  # the reference's lattice route
    return res, ref


@pytest.mark.parametrize(
    "case_id,resolution,inner",
    [
        # mesh resolution 10 of 14 (21^3, 9,261 dofs: the smallest that
        # halves at every level above the 5,000 of the GMG hierarchy)
        ("poisson_3d_kappa_expr", 10, "fused-cg-torch"),
        # mesh resolution 14 of 16 (29^3, 24,389 dofs: still above the
        # 20,000 of the whole fused Arnoldi cycle)
        ("helmholtz_3d_k1_trig", 14, "fused-gmres-torch"),
    ],
)
def test_3d_case_matches_reference(case_id, resolution, inner, monkeypatch):
    res, ref = _compare(_case(case_id, resolution), monkeypatch)
    assert res.solver_info["inner"] == inner and "iterative_failed" not in res.solver_info


def test_chip_smoke_resolution_12_error_is_the_references(monkeypatch):
    """chip_smoke.py holds the card's solve of helmholtz_3d_k1_trig at mesh
    resolution 12 (the kernel #3 route, which no dataset case takes) to
    the reference's baseline_error of that configuration on its lattice
    route."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = chip_smoke.LATTICE_3D["helmholtz_3d_k1_trig@12"][0]
    monkeypatch.setenv("PDEBENCH_TPU_FORCE_STENCIL", "1")
    ref = RefOracle().solve(_case("helmholtz_3d_k1_trig", 12))
    assert ref.solver_info["pc_used"] == "gmg+stencil-ir32" and ref.num_dofs == 15625
    assert abs(ref.baseline_error - want) <= 1e-9 * want, (ref.baseline_error, want)


def test_padded_3d_case_matches_reference(monkeypatch):
    """P2 19^3: the halving chain hits an even axis (10), so the hierarchy
    is identity-padded and out of the kernels' scope."""
    res, _ = _compare(_case("helmholtz_3d_k3_trig", 9), monkeypatch)
    assert res.solver_info["inner"] == "gmres+vcycle"


# -- (e) dispatch ----------------------------------------------------------


def test_fused_gate_takes_3d_scalar_hierarchies(p2_6):
    V, lat, mask, ref, port = p2_6
    op = types.SimpleNamespace(shape=port.levels[0].shape, gmg=port)
    assert dispatch.fused_gate(op) and not dispatch.fused_block_gate(op)
    padded = types.SimpleNamespace(shape=op.shape, gmg=gmg.LatticeGMG(port.levels, port.coarse_inv, port.coarse_shape, padded=True))
    assert not dispatch.fused_gate(padded)
    assert gmg_fused.build_fused_inner_cg(padded.gmg, 25, "cpu") is None
    block = types.SimpleNamespace(
        shape=op.shape,
        gmg=gmg.BlockLatticeGMG(levels=[], coarse_inv=port.coarse_inv, coarse_shape=port.coarse_shape, d=3),
    )
    assert not dispatch.fused_gate(block) and not dispatch.fused_block_gate(block)


def test_3d_block_lattice_gate_takes_cuda_and_stays_off_on_cpu(monkeypatch):
    """A 3-D vector operator takes its block lattice on the devices of
    scalar.BLOCK_LATTICE_3D_DEVICES (CUDA: the d = 3 block stencil and the
    block V-cycle, the reference's TPU route); the CPU keeps the
    reference's CPU branch, no lattice (SA-AMG), until a test patches the
    gate."""
    mesh = unit_cube_mesh(2)
    V = FunctionSpace(mesh, 1, ncomp=3)
    A = np.ones((mesh.n_cells, 12, 12))
    ctx = types.SimpleNamespace(mesh=mesh, space=V, device=torch.device("cpu"))
    assert scalar.BLOCK_LATTICE_3D_DEVICES == ("cuda",)
    assert scalar.maybe_block_lattice32(ctx, A) is None
    monkeypatch.setattr(scalar, "BLOCK_LATTICE_3D_DEVICES", ("cpu",))
    lat = scalar.maybe_block_lattice32(ctx, A)
    assert lat.ncomp == 3 and lat.shape == (3, 3, 3) and lat.grid_shape == (3, 3, 3, 3)
    assert lat.W.dtype == torch.float32 and lat.plan.ncomp == 3
