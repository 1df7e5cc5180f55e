"""The port's dynamic-weight block hierarchies (solvers/gmg_dyn.py) and
kernel #5's plain version against the JAX reference.

The numpy spec builders are copies (equal to 1e-12); the per-step torch
functions hold the reference's to 1e-12 in float64 (the port's levels are
planar, (K, d, d, *shape), compared after a transpose). Kernel #5's plain
version (the V-cycle chain of gmg_dyn, what a CPU tensor runs) is held to
the Pallas kernel in interpret mode on the same levels within 2e-5, the
tolerance tests/test_gmg_dyn.py holds the Pallas kernel to against the
XLA V-cycle: on the random unsymmetric 17 x 17 three-level hierarchy and
on the 25/13 hierarchy of a resolution-12 Navier-Stokes convected
Jacobian, at 1 and 2 cycles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdebench_tpu.solvers import gmg_dyn as ref_dyn
from pdebench_tpu.solvers.gmg_fused import build_fused_dyn_block_vcycle as ref_fused_dyn
from pdebench_tpu.solvers.stencil import constrain_stencil_weights
from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem
from pdebench_tpu_torch.solvers import gmg_dyn, gmg_fused
from test_gmg_dyn import _random_block_stencil
from test_torch_navier_stokes import mms_config

# one intra-op thread: the suite runs several test processes on a few cores,
# where PyTorch's default (a thread per core in each) waits on preempted peers
torch.set_num_threads(1)

TOL = 1e-12
TOL_KERNEL = 2e-5


def planar(W):
    """Reference layout (K, *shape, d, d) -> the port's (K, d, d, *shape)."""
    return np.moveaxis(np.asarray(W), (-2, -1), (1, 2))


def ref_layout(W):
    """The port's planar levels -> the reference's layout."""
    W = np.asarray(W)
    return np.moveaxis(W, (1, 2), (-2, -1)) if W.ndim == 5 else np.moveaxis(W, (0, 1), (-2, -1))


def clamped(shape, d, pad, seed, coarse_size):
    """A random unsymmetric block stencil, every boundary node clamped,
    and both packages' specs probed on it."""
    W, offs = _random_block_stencil(shape, d, pad=pad, seed=seed)
    mask = np.zeros(shape, dtype=bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    Wc = constrain_stencil_weights(W, offs, mask, d=d)
    spec_r = ref_dyn.build_dyn_block_spec(offs, shape, d, probe_W=Wc, coarse_size=coarse_size)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gmg_dyn, "COARSE_SIZE", coarse_size)
        spec_p = gmg_dyn.build_dyn_block_spec(offs, shape, d, probe_W=Wc)
    return W, Wc, offs, mask, spec_r, spec_p


# (17, 17) pad 2: 17/9/5, pure halving; (11, 11) pad 1: 11 -> 6 is even,
# so level 1 is identity-padded to 7
CASES = {"halving": ((17, 17), 2, 21, 100), "padded": ((11, 11), 1, 9, 50)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_builders_equal_reference(case):
    shape, pad, seed, coarse = CASES[case]
    W, Wc, offs, _, spec_r, spec_p = clamped(shape, 2, pad, seed, coarse)
    offs_c_r, C_r = ref_dyn.galerkin_coeffs(offs, 2)
    offs_c_p, C_p = gmg_dyn.galerkin_coeffs(offs, 2)
    assert offs_c_p == offs_c_r
    np.testing.assert_allclose(C_p, C_r, rtol=0, atol=TOL)
    shape_c = tuple((s - 1) // 2 + 1 for s in shape)
    valid = gmg_dyn._valid_planes(offs_c_p, shape_c)
    np.testing.assert_array_equal(valid, ref_dyn._valid_planes(offs_c_r, shape_c))
    Wn_p, sc_p = gmg_dyn.coarsen_block_np(W, offs, shape, offs_c_p, C_p, valid)
    Wn_r, sc_r = ref_dyn.coarsen_block_np(W, offs, shape, offs_c_r, C_r, valid)
    assert sc_p == sc_r
    np.testing.assert_allclose(Wn_p, Wn_r, rtol=TOL, atol=TOL)
    assert len(spec_p.levels) == len(spec_r.levels) and spec_p.d == spec_r.d
    assert (case == "padded") == any(sp.pad_to is not None for sp in spec_p.levels)
    for a, b in zip(spec_p.levels, spec_r.levels):
        assert (a.offsets, a.shape, a.pad, a.diag_k, a.pad_to) == (
            b.offsets, b.shape, b.pad, b.diag_k, b.pad_to
        )
        assert abs(a.omega - b.omega) <= TOL * abs(b.omega)
        assert a.offs_c == b.offs_c
        for x, y in ((a.C, b.C), (a.valid, b.valid), (a.eye_pad, b.eye_pad)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


def test_traced_coarsening_and_constraining_match_reference():
    shape, d = (9, 13), 2
    W, offs = _random_block_stencil(shape, d, pad=2, seed=3)
    offs_c, C = ref_dyn.galerkin_coeffs(offs, 2)
    shape_c = tuple((s - 1) // 2 + 1 for s in shape)
    valid = ref_dyn._valid_planes(offs_c, shape_c)
    Wc_r = np.asarray(ref_dyn.coarsen_block_traced(jnp.asarray(W), offs_c, C, valid, shape_c))
    Wc_p = gmg_dyn.coarsen_block_traced(torch.as_tensor(planar(W)), offs_c, C, valid, shape_c)
    assert Wc_p.dtype == torch.float64
    np.testing.assert_allclose(ref_layout(Wc_p), Wc_r, rtol=TOL, atol=TOL)

    mask = np.random.default_rng(11).random(shape) < 0.25
    keep = 1.0 - mask.astype(np.float64)
    Wk_r = np.asarray(
        ref_dyn.constrain_block_weights_traced(jnp.asarray(W), offs, jnp.asarray(keep), jnp.eye(d))
    )
    Wk_p = gmg_dyn.constrain_block_weights_traced(
        torch.as_tensor(W), offs, torch.as_tensor(keep), torch.eye(d, dtype=torch.float64)
    )
    np.testing.assert_allclose(Wk_p.numpy(), Wk_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(Wk_r, constrain_stencil_weights(W, offs, mask, d=d), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_levels_and_vcycle_match_reference(case):
    """build_levels (f64) and one V-cycle and a 2-cycle chain against the
    reference's XLA V-cycle, padded levels included."""
    shape, pad, seed, coarse = CASES[case]
    _, Wc, _, _, spec_r, spec_p = clamped(shape, 2, pad, seed, coarse)
    lv_r = spec_r.build_levels(jnp.asarray(Wc))
    lv_p = spec_p.build_levels(torch.as_tensor(Wc))
    assert len(lv_p) == len(lv_r)
    for (Wr, Dr), (Wp, Dp) in zip(lv_r, lv_p):
        assert Wp.is_contiguous() and Dp.is_contiguous()
        np.testing.assert_allclose(ref_layout(Wp), np.asarray(Wr), rtol=TOL, atol=TOL * np.abs(Wr).max())
        np.testing.assert_allclose(ref_layout(Dp), np.asarray(Dr), rtol=TOL, atol=TOL * np.abs(Dr).max())
    r = np.random.default_rng(2).standard_normal(shape + (2,))
    z_r = np.asarray(spec_r.vcycle(lv_r, jnp.asarray(r)))
    res = jnp.asarray(r) - ref_dyn._apply_block_w(
        lv_r[0][0], spec_r.levels[0].offsets, spec_r.levels[0].pad, shape, jnp.asarray(z_r)
    )
    z2_r = z_r + np.asarray(spec_r.vcycle(lv_r, res))
    r_p = torch.as_tensor(r).permute(2, 0, 1)
    z_p = spec_p.vcycle(lv_p, r_p).permute(1, 2, 0).numpy()
    z2_p = spec_p.chain(lv_p, r_p, 2).permute(1, 2, 0).numpy()
    for got, want in ((z_p, z_r), (z2_p, z2_r)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def ns_hierarchy():
    """The port's spec of a resolution-12 Navier-Stokes case (25/13) and
    the f32 levels of its convected Jacobian at the Stokes solution."""
    prob = NavierStokesProblem(mms_config(12, 0.5), "cpu")
    x = prob.stokes_direct(prob.nu)
    WA32 = prob.sst.wmapA.weights(prob.jacobian(x, prob.nu)).to(torch.float32)
    return prob.spec, prob.levels(WA32), prob.keep_node32


def random_hierarchy():
    _, Wc, _, mask, _, spec = clamped((17, 17), 2, 2, 21, 100)
    keep = torch.as_tensor(1.0 - mask.astype(np.float32))
    return spec, spec.build_levels(torch.as_tensor(Wc, dtype=torch.float32)), keep


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("hierarchy", ["random17", "ns_res12"])
def test_fused_plain_matches_pallas_interpret(hierarchy, cycles):
    spec, lv, keep = {"random17": random_hierarchy, "ns_res12": ns_hierarchy}[hierarchy]()
    assert [sp.shape for sp in spec.levels] == (
        [(17, 17), (9, 9), (5, 5)] if hierarchy == "random17" else [(25, 25), (13, 13)]
    )
    W0 = lv[0][0]
    # the per-site tap blocks are not symmetric (a transposed read would show)
    assert float((W0 - W0.transpose(1, 2)).abs().max()) > 1e-3 * float(W0.abs().max())
    fused = gmg_fused.build_fused_dyn_block_vcycle(spec, cycles, "cpu")
    r = torch.as_tensor(
        np.random.default_rng(5).standard_normal(keep.shape + (2,)), dtype=torch.float32
    ) * keep[..., None]
    r = r.reshape(-1)
    before = gmg_fused.LAUNCHES_DYN_BLOCK
    z = fused(r, lv)  # a CPU tensor: the plain version, no launch
    assert gmg_fused.LAUNCHES_DYN_BLOCK == before
    # the Pallas kernel on the same levels (the port's spec serves as the
    # reference's: same fields)
    pallas = ref_fused_dyn(spec, n_cycles=cycles, interpret=True)
    z_ref = np.asarray(
        pallas(jnp.asarray(r.numpy()), [(jnp.asarray(ref_layout(W)), jnp.asarray(ref_layout(D)))
                                        for W, D in lv])
    )
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=TOL_KERNEL, atol=TOL_KERNEL)


def test_fused_builder_scope():
    """None only for specs out of the kernel's scope, decided from the
    spec; a CUDA launch on a CPU object raises, never falls back."""
    _, _, _, _, _, spec = clamped((11, 11), 2, 1, 9, 50)
    assert gmg_fused.build_fused_dyn_block_vcycle(spec, 1, "cpu") is None  # padded
    spec, lv, keep = random_hierarchy()
    fused = gmg_fused.build_fused_dyn_block_vcycle(spec, 1, "cpu")
    assert fused is not None
    spec.coarse_sweeps = 9
    with pytest.raises(ValueError):
        gmg_fused.build_fused_dyn_block_vcycle(spec, 1, "cpu")
    r = torch.zeros(2 * 17 * 17)
    with pytest.raises(ValueError):
        fused.launch(r, lv)
    with pytest.raises(ValueError):
        fused(torch.zeros(2 * 17 * 17, dtype=torch.float64), lv)
