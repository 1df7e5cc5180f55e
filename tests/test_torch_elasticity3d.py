"""3-D linear elasticity on unit_cube block lattices, on the CPU, against
the JAX reference.

On the card a 3-D vector operator takes its d = 3 block lattice: the
block hierarchy (copied numpy code), CG preconditioned by the PyTorch
block V-cycle, every level apply one launch of the stencil kernel's d = 3
block form. The CPU keeps the reference's CPU branch (no lattice: SA-AMG
on the six rigid-body modes); the tests reach the card's route on the CPU
by patching `scalar.BLOCK_LATTICE_3D_DEVICES`, and pin the reference to
its own lattice route with PDEBENCH_TPU_FORCE_STENCIL=1 (its CPU branch
otherwise takes AMG).

Sizes: unit_cube resolution 6, P2 (13^3 nodes, 6,591 dofs, above the GMG
gate of 5,000), the hierarchy 13^3 -> 7^3 -> 4^3 (192 coarse unknowns),
unpadded. Both packages solve to rtol 1e-10 on an SPD operator, so the
grids agree far below GRID_TOL."""

import copy
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem.mesh import unit_cube_mesh
from pdebench_tpu.fem.spaces import FunctionSpace
from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.solvers import gmg as ref_gmg
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu_torch.oracle import OracleSolver, scalar
from pdebench_tpu_torch.oracle import linear_elasticity as port_le
from pdebench_tpu_torch.solvers import gmg, stencil, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
RES = 6  # unit_cube resolution: P2 13^3 nodes
VCYCLE_TOL = 1e-6  # one f32 V-cycle, max |diff| over max |z|
GRID_TOL = 1e-8  # relative L2 between the two packages' grids
ERR_TOL = 1e-8  # relative difference of baseline_error


def _case(case_id="le_3d_basic", resolution=RES):
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = resolution
    return cfg


def _rel_l2(a, b):
    assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def hierarchies():
    """The reference's f32 d = 3 block lattice operator of unit_cube P2
    elasticity with its block GMG attached, the port's from the same cell
    matrices with its own, and the mask."""
    mesh = unit_cube_mesh(RES)
    space = FunctionSpace(mesh, 2, ncomp=3)
    lam, mu = port_le.lame_from_params({"E": 1.0, "nu": 0.3})
    K = np.asarray(ref_assemble.local_elasticity(ref_assemble.cell_batch(mesh, 2), mu, lam))
    ref = ref_stencil.block_lattice_operator_from_local(
        K, space.dofmap, space.ndof, space.dof_coords, 3, dtype=jnp.float32
    )
    port = stencil.block_lattice_operator_from_local(
        K, space.dofmap, space.ndof, space.dof_coords, 3, "cpu", dtype=torch.float32
    )
    mask = np.zeros(space.ndof, bool)
    bs = space.boundary_scalar_dofs
    mask[(bs[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)] = True
    ref_gmg.attach_lattice_gmg(ref, mask)
    gmg.attach_lattice_gmg(port, mask)
    return space, ref, port, mask


def test_block_hierarchy_3d_equals_reference(hierarchies):
    """The port's d = 3 hierarchy, built from its own operator with the
    copied numpy code (the pinv block inverse, the 3-D block coarsening),
    is the reference's array for array; it halves at every level (no
    padding) and every level fits the kernel's tap limit."""
    space, ref, port, _ = hierarchies
    assert port.offsets == ref.offsets and len(port.offsets) == 65
    np.testing.assert_array_equal(port.W_f64.numpy(), np.asarray(ref.W_f64))
    a, b = port.gmg, ref.gmg
    assert isinstance(a, gmg.BlockLatticeGMG) and a.d == b.d == 3
    assert not a.padded and not b.padded and not a.surrogate
    assert [l.shape for l in a.levels] == [(13, 13, 13), (7, 7, 7)]
    assert a.coarse_shape == b.coarse_shape == (4, 4, 4)
    assert len(a.levels) == len(b.levels)
    for l, lr in zip(a.levels, b.levels):
        assert (l.shape, l.offsets, l.pad, l.pad_to) == (lr.shape, lr.offsets, lr.pad, lr.pad_to)
        assert l.pad_to is None and len(l.offsets) <= stencil_kernel.MAX_TAPS
        assert l.plan.ncomp == 3 and l.plan.w_shape == tuple(l.W.shape)
        assert l.omega == lr.omega
        np.testing.assert_array_equal(l.W.numpy(), np.asarray(lr.W))
        np.testing.assert_array_equal(l.diag_inv.numpy(), np.asarray(lr.diag_inv))
    np.testing.assert_array_equal(a.coarse_inv.numpy(), np.asarray(b.coarse_inv))


def test_block_vcycle_3d_matches_reference(hierarchies):
    """One block V-cycle (BlockLatticeGMG.precond, its level applies the
    d = 3 block stencil's plain version here) on the reference's own
    hierarchy, carried across with block_lattice_gmg_from_numpy."""
    space, ref, _, mask = hierarchies
    b = ref.gmg
    port = gmg.block_lattice_gmg_from_numpy(
        [dict(W=np.asarray(l.W), offsets=l.offsets, shape=l.shape,
              diag_inv=np.asarray(l.diag_inv), omega=l.omega, pad_to=l.pad_to)
         for l in b.levels],
        np.asarray(b.coarse_inv), b.coarse_shape, 3, "cpu",
    )
    r = np.random.default_rng(1).standard_normal(space.ndof)
    r[mask] = 0.0
    r_lat = ref.embedding.embed_np(r.astype(np.float32), 0.0).reshape(ref.grid_shape)
    z = port.precond()(torch.as_tensor(r_lat)).numpy()
    z_ref = np.asarray(b.precond()(jnp.asarray(r_lat)))
    assert z.dtype == np.float32 and z.shape == r_lat.shape == (13, 13, 13, 3)
    assert np.abs(z - z_ref).max() <= VCYCLE_TOL * np.abs(z_ref).max()


def test_block_plan_refuses_more_taps_than_the_kernel_takes():
    """A level beyond the kernel's tap limit raises where its plan is
    built: no level is left to a plain version."""
    offs = [(0, 0, k) for k in range(-64, 65)]
    assert len(offs) == stencil_kernel.MAX_TAPS + 1
    with pytest.raises(ValueError, match="at most"):
        stencil_kernel.StencilPlan((3, 3, 3), offs, 64, ncomp=3)


@pytest.fixture(scope="module")
def lattice_route():
    """le_3d_basic at resolution 6 on the card's route (the gate patched)
    and the reference's lattice route (FORCE_STENCIL=1)."""
    cfg = _case()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scalar, "BLOCK_LATTICE_3D_DEVICES", ("cuda", "cpu"))
        got = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PDEBENCH_TPU_FORCE_STENCIL", "1")
        want = RefOracle().solve(copy.deepcopy(cfg))
    return got, want


def test_lattice_route_3d_matches_reference(lattice_route):
    got, want = lattice_route
    info = got.solver_info
    assert info["inner"] == "stencil-cg" and info["pc_used"] == "gmg+stencil-ir32"
    assert "iterative_failed" not in info and "gmg_failed" not in info
    assert want.solver_info["pc_used"] == "gmg+stencil-ir32"
    assert got.reference.shape == (16, 16, 16)
    assert _rel_l2(got.reference, want.reference) < GRID_TOL
    assert abs(got.baseline_error - want.baseline_error) <= ERR_TOL * want.baseline_error
    assert got.num_dofs == want.num_dofs == 6591


def test_cpu_default_takes_rigid_body_amg():
    """Without the patch the CPU takes the reference's CPU branch: no
    lattice, SA-AMG on the rigid-body modes (CG-IR), the same answer as
    the reference's default."""
    cfg = _case()
    got = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    want = RefOracle().solve(copy.deepcopy(cfg))
    assert got.solver_info["inner"] == "amg-cg-ir"
    assert _rel_l2(got.reference, want.reference) < GRID_TOL
    assert abs(got.baseline_error - want.baseline_error) <= ERR_TOL * want.baseline_error
