"""The per-step weight machinery of reaction-diffusion and Burgers on the
CPU: `stencil.BilinearLatticeWeightMap` of the port against the JAX
reference's (the host P stacks array-equal for the tile-direct and the
dense builds, P1 and P2, Burgers' advection tensor T_adv and the reaction
Jacobian's T_mass; the step weights bit for bit against the reference's
build as XLA compiles it, and within float32 rounding of the float64
weights of the assembled cell batch), and a `solve_constrained_ir` solve
with `step_weights` against the reference's."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pdebench_tpu.fem import assemble as ref_assemble
from pdebench_tpu.fem import mesh as ref_mesh
from pdebench_tpu.fem.spaces import FunctionSpace as RefSpace
from pdebench_tpu.oracle import base as ref_base
from pdebench_tpu.solvers import dispatch as ref_dispatch
from pdebench_tpu.solvers import gmg as ref_gmg
from pdebench_tpu.solvers import stencil as ref_stencil
from pdebench_tpu_torch.fem import assemble
from pdebench_tpu_torch.fem.mesh import Mesh, unit_square_mesh
from pdebench_tpu_torch.fem.spaces import FunctionSpace
from pdebench_tpu_torch.solvers import dispatch, gmg, gmg_fused, stencil, stencil_kernel

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)


def launches():
    return (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES, gmg_fused.LAUNCHES_RICHARDSON,
            gmg_fused.LAUNCHES_GMRES)


def cell_tensor(cb, which):
    """Burgers' T_adv (the lagged convection, every direction's gradient
    summed) or the reaction Jacobian's T_mass, (c, nl, nl, nl), from the
    reference's own formulas."""
    wdetJ, phi = np.asarray(cb.wdetJ), np.asarray(cb.phi)
    if which == "adv":
        g_sum = np.asarray(cb.grad_phys()).sum(-1)
        return np.einsum("cq,qi,qk,cqj->cijk", wdetJ, phi, phi, g_sum, optimize=True)
    return np.einsum("cq,qi,qj,qk->cijk", wdetJ, phi, phi, phi, optimize=True)


@functools.lru_cache(maxsize=None)
def meshes(kind, degree, res):
    """(port space, reference space, reference cell batch, both lattices,
    both weight maps) on the unit square or the reference's masked
    l_shape lattice."""
    if kind == "square":
        rmesh, pmesh = ref_mesh.unit_square_mesh(res), unit_square_mesh(res)
    else:
        rmesh = ref_base.build_mesh({"type": "l_shape"}, {"resolution": res})
        pmesh = Mesh(cell_type=rmesh.cell_type, coords=np.asarray(rmesh.coords),
                     cells=np.asarray(rmesh.cells))
    rspace, space = RefSpace(rmesh, degree), FunctionSpace(pmesh, degree)
    rcb = ref_assemble.cell_batch(rmesh, degree)
    rlat, lat = ref_stencil.detect_lattice(rspace.dof_coords), stencil.detect_lattice(space.dof_coords)
    rwm = ref_stencil.lattice_weight_map(rlat, rspace.dofmap_scalar)
    wm = stencil.lattice_weight_map(lat, space.dofmap_scalar)
    assert wm.offsets == rwm.offsets and wm.pad == rwm.pad
    return space, rspace, rcb, lat, rlat, wm, rwm


def both_maps(kind, degree, res, which):
    """Both packages' maps of one tensor, each choosing its build."""
    space, rspace, rcb, lat, rlat, wm, rwm = meshes(kind, degree, res)
    T = cell_tensor(rcb, which)
    ref = ref_stencil.BilinearLatticeWeightMap(rwm, rlat, rspace.dofmap_scalar, T)
    got = stencil.BilinearLatticeWeightMap(wm, lat, space.dofmap_scalar, T)
    return got, ref, T


# (build, degree) -> resolution. The tile-direct build wants more than
# 2 (pad + 7) + 6 sites a side: 41 x 41 lattices take it; 21 x 21 (P1)
# and 23 x 23 (P2) lattices are too small for it and take the dense build
RES = {("tile", 1): 40, ("tile", 2): 20, ("dense", 1): 20, ("dense", 2): 11}


@pytest.mark.parametrize("build", ["tile", "dense"])
@pytest.mark.parametrize("which", ["adv", "mass"])
@pytest.mark.parametrize("degree", [1, 2], ids=["P1", "P2"])
def test_p_stack_matches_reference(degree, which, build):
    got, ref, _ = both_maps("square", degree, RES[build, degree], which)
    assert got.pairs == ref.pairs and got.K == ref.K
    # each package picks the build from the lattice; the tile-direct one
    # skips the dense stack
    assert (got.P_np is None) == (ref.P_np is None) == (build == "tile")
    np.testing.assert_array_equal(got.dense_np(), ref.dense_np())
    assert got._periods == ref._periods
    for a, b in zip(got._compressed, ref._compressed):
        np.testing.assert_array_equal(a, b)


def test_masked_lattice_takes_the_dense_build():
    """A masked lattice (the reference's l_shape) never takes the
    tile-direct build, whose sampled check cannot see interior mask
    sites."""
    got, ref, _ = both_maps("l_shape", 1, 12, "adv")
    assert got.P_np is not None and ref.P_np is not None
    assert got.pairs == ref.pairs
    np.testing.assert_array_equal(got.dense_np(), ref.dense_np())


@pytest.mark.parametrize("kind, degree, res, which", [
    ("square", 1, 40, "adv"), ("square", 2, 20, "adv"), ("square", 2, 20, "mass"),
    ("square", 1, 40, "mass"), ("l_shape", 1, 12, "adv"),
], ids=["P1-adv", "P2-adv", "P2-mass", "P1-mass", "l_shape-P1-adv"])
def test_weights_w_matches_reference_and_cell_batch(kind, degree, res, which):
    """The step weights of a random nodal field: bit for bit the
    reference's build under jit (its fused multiply-adds), and within
    float32 rounding of the float64 weights of the assembled cell batch
    N[c, i, j] = sum_k T[c, i, j, k] u[dofmap[c, k]]."""
    got, ref, T = both_maps(kind, degree, res, which)
    space, _, _, lat, rlat, wm, _ = meshes(kind, degree, res)
    u = np.random.default_rng(degree).standard_normal(space.ndof)
    u_lat = lat.embed_np(u.astype(np.float32), 0.0).reshape(wm.shape)
    P = got.device_stack("cpu")
    G = max(sum(1 for a, _ in got.pairs if a == k) for k in range(got.K))
    assert P.P.shape == (G, got.K, int(np.prod(wm.shape))) and P.P.dtype == torch.float32
    before = launches()
    W = got.weights_w(P, torch.as_tensor(u_lat)).numpy()
    assert launches() == before
    assert W.dtype == np.float32 and W.shape == (got.K,) + wm.shape
    want = np.asarray(jax.jit(ref.weights_w)(ref.P_dense(ref.P_parts), jnp.asarray(u_lat)))
    np.testing.assert_array_equal(W, want)
    N = np.einsum("cijk,ck->cij", T, u[space.dofmap_scalar])
    W64 = wm.weights_np(N)
    scale = np.abs(W64).max()
    np.testing.assert_allclose(W, W64, atol=2e-6 * scale)
    # the same weights on a second call: a fixed order
    np.testing.assert_array_equal(got.weights_w(P, torch.as_tensor(u_lat)).numpy(), W)


def test_step_weights_solve_matches_reference():
    """solve_constrained_ir with step_weights=(wmap, W32), a Burgers step
    on 73 x 73 P1 nodes (above the hierarchy's size gate): the f64 outer
    on W32 cast to f64, GMRES(20) preconditioned by the V-cycle of the
    constant part's hierarchy, against the reference's; both converge to
    the operator of the same float32 weights."""
    space, rspace, rcb, lat, rlat, wm, rwm = meshes("square", 1, 72)
    dt, nu = 0.01, 0.01
    cb = assemble.cell_batch(unit_square_mesh(72), 1)
    M, K = assemble.local_mass(cb), assemble.local_stiffness(cb)
    A_const = (1.0 / dt) * M + nu * K
    T = cell_tensor(rcb, "adv")
    bwm = stencil.BilinearLatticeWeightMap(wm, lat, space.dofmap_scalar, T)
    rbwm = ref_stencil.BilinearLatticeWeightMap(rwm, rlat, rspace.dofmap_scalar, T)

    args = (A_const, space.dofmap_scalar, space.ndof, space.dof_coords)
    lat32 = stencil.lattice_operator_from_local(*args, device="cpu", dtype=torch.float32)
    rlat32 = ref_stencil.lattice_operator_from_local(*args, dtype=jnp.float32)
    bdofs = space.boundary_dofs_on("all")
    mask_np = np.zeros(space.ndof, dtype=bool)
    mask_np[bdofs] = True
    gmg.attach_lattice_gmg(lat32, mask_np)
    ref_gmg.attach_lattice_gmg(rlat32, mask_np)

    rng = np.random.default_rng(3)
    x, y = space.dof_coords[:, 0], space.dof_coords[:, 1]
    u = np.sin(np.pi * x) * np.sin(np.pi * y)
    b = rng.standard_normal(space.ndof)
    g = np.where(mask_np, np.cos(x + y), 0.0)
    u_lat = lat.embed_np(u.astype(np.float32), 0.0).reshape(wm.shape)
    W_c32 = wm.weights_np(A_const).astype(np.float32)
    W32 = torch.as_tensor(W_c32) + bwm.weights_w(bwm.device_stack("cpu"), torch.as_tensor(u_lat))
    rW32 = jax.jit(lambda W0, P, v: W0 + rbwm.weights_w(P, v))(
        jnp.asarray(W_c32), rbwm.P_dense(rbwm.P_parts), jnp.asarray(u_lat))
    np.testing.assert_array_equal(W32.numpy(), np.asarray(rW32))

    mask = torch.as_tensor(mask_np)
    before = launches()
    xs, its, res, conv, name = dispatch.solve_constrained_ir(
        None, torch.as_tensor(b), mask, torch.as_tensor(g), lat32, 1e-8, 1e-10,
        inner="gmres", inner_iters=20, max_outer=60, step_weights=(wm, W32),
    )
    assert launches() == before
    assert conv and name == "gmres+vcycle" and its % 20 == 0
    rx, rits, rres, rconv = jax.jit(lambda bb, mm, gg, ww: ref_dispatch.solve_constrained_ir(
        None, None, jnp.asarray(space.dofmap_scalar), bb, mm, gg, space.ndof, 1e-8, 1e-10,
        inner_iters=20, lattice32=rlat32, inner="gmres", step_weights=(rwm, ww),
    ))(jnp.asarray(b), jnp.asarray(mask_np), jnp.asarray(g), rW32)
    assert bool(rconv) and int(rits) == its
    rx = np.asarray(rx)
    gap = np.linalg.norm(xs.numpy() - rx) / np.linalg.norm(rx)
    assert gap < 1e-10, gap
    # the solution of the float32 weights' operator, Dirichlet rows g
    np.testing.assert_allclose(xs.numpy()[mask_np], g[mask_np], rtol=0, atol=1e-12)
    W64 = W32.to(torch.float64)
    Ax = wm.apply_grid(W64, torch.as_tensor(lat.embed_np(np.where(mask_np, 0.0, xs.numpy()), 0.0))
                       .reshape(wm.shape)).reshape(-1)[torch.as_tensor(lat.inv)]
    Ag = wm.apply_grid(W64, torch.as_tensor(lat.embed_np(g, 0.0)).reshape(wm.shape)).reshape(-1)[
        torch.as_tensor(lat.inv)]
    r = (b - Ag.numpy() - Ax.numpy())[~mask_np]
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(np.where(mask_np, g, b - Ag.numpy()))

    # a per-step operator takes a GMRES inner
    with pytest.raises(ValueError):
        dispatch.solve_constrained_ir(
            None, torch.as_tensor(b), mask, torch.as_tensor(g), lat32, 1e-8, 1e-10,
            inner="cg", inner_iters=20, max_outer=60, step_weights=(wm, W32),
        )
