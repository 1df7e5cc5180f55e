"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
neither jax nor the JAX package, so it also runs on a machine without jax
(there, skip tests/conftest.py, which sets jax up):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TOL_CG = 2e-4  # f32 PCG recurrence, sums in another order
TOL_VCYCLE = 1e-5  # one PCG step: f32 sums in another order through one V-cycle


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _offsets(p):
    """Stencil offsets of a P_p triangle lattice: 7 taps for P1, 37 for P3."""
    return [
        (dy, dx)
        for dy in range(-p, p + 1)
        for dx in range(-p, p + 1)
        if abs(dy - dx) <= p
    ]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,p", [(121, 1), (241, 3)])
def test_stencil_kernel_matches_plain(dev, n, p, dtype):
    """P1 121^2 (poisson_basic) and P3 241^2: one launch on the unpadded
    field, and the Pallas-signature wrapper on its padded copy."""
    offs = _offsets(p)
    assert len(offs) == {1: 7, 3: 37}[p]
    rng = np.random.default_rng(0)
    W = torch.as_tensor(rng.standard_normal((len(offs), n, n)), device=dev).to(dtype)
    u = torch.as_tensor(rng.standard_normal((n, n)), device=dev).to(dtype)
    plan = stencil_kernel.StencilPlan((n, n), offs, p)
    before = stencil_kernel.LAUNCHES
    y = plan(W, u)
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.stencil_plain(u, W, offs, p)
    assert y.dtype == dtype and y.device == W.device
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err
    assert torch.equal(stencil_kernel.stencil_apply_2d(F.pad(u, (p,) * 4), W, offs, p), y)


def _case_gmg(dev, case_id, resolution=None):
    """A Poisson case's f32 lattice operator with its GMG hierarchy and
    the lattice mask; the mesh at `resolution` if given."""
    from pdebench_tpu_torch.fem.assemble import local_stiffness
    from pdebench_tpu_torch.oracle import base, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = scalar.override_bc_with_mms(cfg, cfg["pde"]["manufactured_solution"]["u"])
    if resolution is not None:
        cfg["mesh"]["resolution"] = resolution
    ctx = scalar.setup_scalar(cfg, dev)
    kappa = base.coefficient_fn(cfg["pde"]["coefficients"]["kappa"], ctx.dim, dev)
    lat = scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb, kappa(ctx.qpts())))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask)
    return lat, mask


@pytest.mark.parametrize("case_id", ["poisson_basic", "poisson_p3_variable_kappa_mild"])
def test_fused_cg_kernel_matches_plain(dev, case_id):
    lat, mask = _case_gmg(dev, case_id)
    inner = gmg_fused.build_fused_inner_cg(lat.gmg, 25, dev)
    r = np.random.default_rng(1).standard_normal(lat.lattice.n_dof)
    r[mask] = 0.0
    r_lat = torch.as_tensor(lat.lattice.embed_np(r.astype(np.float32), 0.0), device=dev)
    before = gmg_fused.LAUNCHES
    z = inner(r_lat)
    assert gmg_fused.LAUNCHES == before + 1
    z_plain = inner.plain(r_lat)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=TOL_CG, atol=TOL_CG * scale)


@pytest.mark.parametrize("case_id", ["poisson_basic", "poisson_p3_variable_kappa_mild"])
def test_fused_vcycle_step_matches_plain(dev, case_id):
    """One PCG step, z = alpha V(r): the V-cycle's arithmetic, before 25
    steps of CG hide a fault in it."""
    lat, mask = _case_gmg(dev, case_id)
    step = gmg_fused.build_fused_inner_cg(lat.gmg, 1, dev)
    r = np.random.default_rng(2).standard_normal(lat.lattice.n_dof)
    r[mask] = 0.0
    r_lat = torch.as_tensor(lat.lattice.embed_np(r.astype(np.float32), 0.0), device=dev)
    z = step(r_lat)
    z_plain = step.plain(r_lat)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)


def test_oracle_runs_the_kernels(dev):
    from pdebench_tpu_torch.oracle import OracleSolver

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == "poisson_basic")
    stencil_kernel.LAUNCHES = gmg_fused.LAUNCHES = 0
    res = OracleSolver(device=dev).solve(cfg)
    assert res.solver_info["inner"] == "fused-cg-cuda"
    # three outer rounds, as the plain version takes on the card
    # (chip_smoke.POISSON)
    assert res.solver_info["iterations"] == 3 * 25
    assert stencil_kernel.LAUNCHES > 0 and gmg_fused.LAUNCHES > 0
    assert abs(res.baseline_error - 1.924806820736457e-4) <= 1e-6 * 1.924806820736457e-4


def test_unconverged_ir_on_cuda_raises(dev, monkeypatch):
    """On CUDA tensors an unconverged lattice solve raises; it never moves
    to the host LU."""
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.solvers import dispatch

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 40 * 25, 1.0, False, "fused-cg-cuda"

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == "poisson_basic")
    with pytest.raises(RuntimeError, match="did not converge"):
        OracleSolver(device=dev).solve(cfg)


HELMHOLTZ = {
    # case id -> (recorded baseline_error, inner on the card, outer rounds)
    "helmholtz_basic_k5": (6.517975839100497e-4, "gmres+fused-richardson-cuda", 4),
    "helmholtz_k12_exponential_mode": (3.1268822007046e-4, "fused-gmres-cuda", 3),
}
TOL_LINEAR = 2e-4  # linearity of the Richardson chain (tests/test_gmg_fused.py)


def _helmholtz(dev, case_id, resolution=None):
    """The case's f32 lattice operator with its shifted-Laplacian
    hierarchy, the true constrained weights and the lattice mask; the
    mesh at `resolution` if given."""
    from pdebench_tpu_torch.fem.assemble import local_mass, local_stiffness
    from pdebench_tpu_torch.oracle import helmholtz, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg
    from pdebench_tpu_torch.solvers.stencil import constrain_step_weights

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = scalar.override_bc_with_mms(cfg, cfg["pde"]["manufactured_solution"]["u"])
    if resolution is not None:
        cfg["mesh"]["resolution"] = resolution
    k2 = float(cfg["pde"]["pde_params"]["k"]) ** 2
    ctx = scalar.setup_scalar(cfg, dev)
    lat = scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb) - k2 * local_mass(ctx.cb))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask, A_override=helmholtz.shifted_laplacian(ctx, k2))
    keep = torch.as_tensor(
        1.0 - lat.lattice.embed_np(mask, True).astype(np.float32), device=dev
    ).reshape(lat.shape)
    return lat, mask, constrain_step_weights(lat.W, lat.offsets, keep)


def _lattice_rhs(lat, mask, seed, dev):
    r = np.random.default_rng(seed).standard_normal(lat.lattice.n_dof)
    r[mask] = 0.0
    return torch.as_tensor(lat.lattice.embed_np(r.astype(np.float32), 0.0), device=dev)


def _true_residual(lat, W32c, r_lat, z):
    """||r - A z|| / ||r|| with A the stencil W32c on a 2-D or 3-D lattice."""
    Az = stencil_kernel.stencil_plain(z.reshape(lat.shape), W32c, lat.offsets, lat.pad).reshape(-1)
    return float(torch.linalg.norm(r_lat - Az) / torch.linalg.norm(r_lat))


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("case_id", sorted(HELMHOLTZ))
def test_fused_richardson_kernel_matches_plain(dev, case_id, cycles):
    lat, mask, _ = _helmholtz(dev, case_id)
    assert lat.gmg.surrogate and not lat.gmg.padded
    rich = gmg_fused.build_fused_richardson(lat.gmg, cycles, dev)
    r1, r2 = _lattice_rhs(lat, mask, 3, dev), _lattice_rhs(lat, mask, 4, dev)
    before = gmg_fused.LAUNCHES_RICHARDSON
    z1 = rich(r1)
    assert gmg_fused.LAUNCHES_RICHARDSON == before + 1
    z_plain = rich.plain(r1)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z1, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    # linear in r: the property the GMRES inner needs from its preconditioner
    z12 = rich(r1 + 2.0 * r2)
    torch.testing.assert_close(z12, z1 + 2.0 * rich(r2), rtol=TOL_LINEAR, atol=TOL_LINEAR * scale)


@pytest.mark.parametrize("case_id", sorted(HELMHOLTZ))
def test_fused_gmres_kernel_one_step_matches_plain(dev, case_id):
    """m = 1: the basis, the Hessenberg column and beta per element."""
    lat, mask, W32c = _helmholtz(dev, case_id)
    fg = gmg_fused.build_fused_inner_gmres(lat.gmg, 1, dev, lat.offsets)
    r = _lattice_rhs(lat, mask, 5, dev)
    before = gmg_fused.LAUNCHES_GMRES
    V, H, beta = fg.raw(r, W32c)
    assert gmg_fused.LAUNCHES_GMRES == before + 1
    Vp, Hp, bp = fg.plain_raw(r, W32c)
    for got, want in ((V, Vp), (H, Hp), (beta, bp)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)


@pytest.mark.parametrize("case_id", sorted(HELMHOLTZ))
def test_fused_gmres_kernel_cycle_reduces_true_residual(dev, case_id):
    """m = 30: float MGS sums in another order part the two recurrences
    after a few steps, so the whole cycle is held by its residual against
    the TRUE operator: no worse than twice the plain version's, below 0.1."""
    lat, mask, W32c = _helmholtz(dev, case_id)
    fg = gmg_fused.build_fused_inner_gmres(lat.gmg, 30, dev, lat.offsets)
    r = _lattice_rhs(lat, mask, 6, dev)
    rel = _true_residual(lat, W32c, r, fg(r, W32c))
    rel_plain = _true_residual(lat, W32c, r, fg.plain(r, W32c))
    assert rel < 0.1 and rel <= 2.0 * rel_plain, (rel, rel_plain)


def test_helmholtz_oracle_runs_the_kernels(dev):
    from pdebench_tpu_torch.oracle import OracleSolver

    for case_id, (ref_err, inner, outer) in HELMHOLTZ.items():
        with open(DATA) as fh:
            cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
        gmg_fused.LAUNCHES_RICHARDSON = gmg_fused.LAUNCHES_GMRES = 0
        res = OracleSolver(device=dev).solve(cfg)
        assert res.solver_info["inner"] == inner
        assert res.solver_info["iterations"] == outer * 30
        launched = gmg_fused.LAUNCHES_RICHARDSON if "richardson" in inner else gmg_fused.LAUNCHES_GMRES
        assert launched > 0
        assert abs(res.baseline_error - ref_err) <= 1e-6 * ref_err


def test_unconverged_nonsymmetric_ir_on_cuda_raises(dev, monkeypatch):
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.solvers import dispatch

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 40 * 30, 1.0, False, "fused-gmres-cuda"

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh
                   if json.loads(l)["id"] == "helmholtz_k12_exponential_mode")
    with pytest.raises(RuntimeError, match="did not converge"):
        OracleSolver(device=dev).solve(cfg)


ELASTICITY = {
    # case id -> (recorded baseline_error, outer rounds of 25 block PCG steps)
    "linear_elasticity_nu010": (1.5773824748707618e-06, 2),
    "linear_elasticity_nu030": (3.2893239815322345e-06, 3),
}


def _elasticity(dev, case_id, rough=False, resolution=None):
    """The case's f32 block lattice operator with its block GMG hierarchy
    and the dof mask, at the case's mesh resolution or `resolution`;
    `rough` scales the shear modulus cell by cell (a factor between 1/2
    and 2), which makes the per-site tap blocks non-symmetric."""
    from pdebench_tpu_torch.fem.assemble import local_elasticity
    from pdebench_tpu_torch.oracle import linear_elasticity, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    if resolution is not None:
        cfg["mesh"]["resolution"] = resolution
    cfg = scalar.override_bc_with_mms(cfg, list(cfg["pde"]["manufactured_solution"]["u"]))
    lam, mu = linear_elasticity.lame_from_params(cfg["pde"]["pde_params"])
    ctx = scalar.setup_scalar(cfg, dev, ncomp=-1)
    if rough:
        mu = mu * np.exp(np.random.default_rng(1).uniform(np.log(0.5), np.log(2.0), ctx.mesh.n_cells))
    lat = scalar.maybe_block_lattice32(ctx, local_elasticity(ctx.cb, mu, lam))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask)
    return lat, mask


def _block_rhs(lat, mask, seed, dev):
    r = np.random.default_rng(seed).standard_normal(lat.embedding.n_dof)
    r[mask] = 0.0
    return torch.as_tensor(lat.embedding.embed_np(r.astype(np.float32), 0.0), device=dev)


@pytest.mark.parametrize("iters,tol", [(1, TOL_VCYCLE), (25, TOL_CG)])
@pytest.mark.parametrize("case_id", sorted(ELASTICITY))
def test_fused_block_cg_kernel_matches_plain(dev, case_id, iters, tol):
    """1 PCG step (the block V-cycle per element) and the main path's 25."""
    lat, mask = _elasticity(dev, case_id)
    assert not lat.gmg.padded
    inner = gmg_fused.build_fused_block_inner_cg(lat.gmg, iters, dev)
    r = _block_rhs(lat, mask, 7, dev)
    before = gmg_fused.LAUNCHES_BLOCK
    z = inner(r)
    assert gmg_fused.LAUNCHES_BLOCK == before + 1
    z_plain = inner.plain(r)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * scale)
    if iters == 25:
        r_pl = inner._to_planes(r)
        rel = float(torch.linalg.norm(r_pl - inner._apply(0, inner._to_planes(z))) / torch.linalg.norm(r_pl))
        assert rel < 1e-3, rel


def test_fused_block_cg_kernel_reads_blocks_untransposed(dev):
    """Constant Lame parameters give symmetric per-site tap blocks; on a
    rough shear modulus they are not, and one PCG step tells W[k, a, b]
    from W[k, b, a]. The smoother blocks of a symmetric operator are
    symmetric whatever the coefficients: skewed on every level, they tell
    D[a, b] from D[b, a]."""
    lat, mask = _elasticity(dev, "linear_elasticity_nu010", rough=True)
    W = lat.gmg.levels[0].W
    assert float((W - W.transpose(-1, -2)).abs().max()) > 1e-2 * float(W.abs().max())
    step = gmg_fused.build_fused_block_inner_cg(lat.gmg, 1, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for D in step.D:
        s = D.abs().max() * 0.2 * torch.rand(D.shape[-2:], generator=gen, device=dev)
        D[0, 1] += s
        D[1, 0] -= s
    r = _block_rhs(lat, mask, 10, dev)
    z, z_plain = step(r), step.plain(r)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("case_id", sorted(ELASTICITY))
def test_fused_block_richardson_kernel_matches_plain(dev, case_id, cycles):
    lat, mask = _elasticity(dev, case_id)
    rich = gmg_fused.build_fused_block_inner_cg(lat.gmg, cycles, dev, mode="richardson")
    r1, r2 = _block_rhs(lat, mask, 8, dev), _block_rhs(lat, mask, 9, dev)
    before = gmg_fused.LAUNCHES_BLOCK_RICHARDSON
    z1 = rich(r1)
    assert gmg_fused.LAUNCHES_BLOCK_RICHARDSON == before + 1
    z_plain = rich.plain(r1)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z1, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    torch.testing.assert_close(rich(r1 + 2.0 * r2), z1 + 2.0 * rich(r2), rtol=TOL_LINEAR, atol=TOL_LINEAR * scale)


@pytest.mark.parametrize("mode,iters", [("cg", 1), ("cg", 25), ("richardson", 1), ("richardson", 2)])
@pytest.mark.parametrize("case_id,resolution", [("linear_elasticity_nu030", None),
                                                ("linear_elasticity_nu010", 40)])
def test_fused_block_cg_kernel_cta_levels_bitwise(dev, case_id, resolution, mode, iters):
    """Kernel #4's CTA 0 solving two coarse block levels in shared memory
    gives, bit for bit, what it gives with the finer of them as cluster
    stages and CTA 0 on the coarsest level alone (l* = L - 1): on nu030's
    hierarchy (21^2 and 11^2 in CTA 0) and on nu010's cut to 81^2 (its
    own 31^2 and 16^2 do not fit one CTA beside the windows)."""
    lat, mask = _elasticity(dev, case_id, resolution=resolution)
    built = [gmg_fused.build_fused_block_inner_cg(lat.gmg, iters, dev, mode=mode, cta_levels=m)
             for m in (2, 1)]
    r = _block_rhs(lat, mask, 19, dev)
    z, z_coarsest = (f(r) for f in built)
    nlev = len(built[0].W)
    assert built[0]._cuda["lstar"] == nlev - 2 and built[1]._cuda["lstar"] == nlev - 1
    assert torch.equal(z, z_coarsest)
    z_plain = built[0].plain(r)
    tol = TOL_CG if iters == 25 else TOL_VCYCLE
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * float(z_plain.abs().max()))


@pytest.mark.parametrize("iters,tol", [(1, TOL_VCYCLE), (25, TOL_CG)])
@pytest.mark.parametrize("resolution", [40, 48])
def test_fused_block_cg_kernel_uneven_bands(dev, resolution, iters, tol):
    """nu010's hierarchy cut to 81/41/21/11 and 97/49/25/13 rows (with
    the probed level), which a cluster of 16 or 8 CTAs does not divide,
    the coarse ones fewer rows than CTAs: 1 and 25 PCG steps, and a
    2-cycle Richardson chain."""
    lat, mask = _elasticity(dev, "linear_elasticity_nu010", resolution=resolution)
    assert not lat.gmg.padded and len(lat.gmg.levels) >= 3
    inner = gmg_fused.build_fused_block_inner_cg(lat.gmg, iters, dev)
    r = _block_rhs(lat, mask, 21, dev)
    z = inner(r)
    z_plain = inner.plain(r)
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * float(z_plain.abs().max()))
    rich = gmg_fused.build_fused_block_inner_cg(lat.gmg, 2, dev, mode="richardson")
    z, z_plain = rich(r), rich.plain(r)
    torch.testing.assert_close(z, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * float(z_plain.abs().max()))


def test_fused_block_cg_kernel_zero_residual(dev):
    """r = 0: every PCG denominator is 0 (guarded to 1), z stays 0."""
    lat, _ = _elasticity(dev, "linear_elasticity_nu010")
    inner = gmg_fused.build_fused_block_inner_cg(lat.gmg, 3, dev)
    z = inner(torch.zeros(2 * int(np.prod(lat.shape)), dtype=torch.float32, device=dev))
    assert torch.equal(z, torch.zeros_like(z))


def test_elasticity_oracle_runs_the_kernels(dev):
    from pdebench_tpu_torch.oracle import OracleSolver

    ref_err, outer = ELASTICITY["linear_elasticity_nu010"]
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh
                   if json.loads(l)["id"] == "linear_elasticity_nu010")
    stencil_kernel.LAUNCHES = gmg_fused.LAUNCHES_BLOCK = 0
    res = OracleSolver(device=dev).solve(cfg)
    assert res.solver_info["inner"] == "fused-block-cg-cuda"
    assert res.solver_info["iterations"] == outer * 25
    # one launch per f64 block apply: the lifted rhs, the first residual
    # and one a round, in the cold and the warm run (4 a block apply before
    # the block kernel)
    assert stencil_kernel.LAUNCHES == 2 * (outer + 2) and gmg_fused.LAUNCHES_BLOCK > 0
    assert abs(res.baseline_error - ref_err) <= 1e-6 * ref_err


def test_direct_request_at_k15_takes_the_host_lu_on_cuda(dev, monkeypatch):
    """helmholtz_no_exact_gaussian_source_k15: its reference re-solve asks
    for preonly/lu at k = 15, where the lattice IR stalls. The oracle
    sends that request to the host LU before any lattice or kernel is
    built (helmholtz.host_lu_route), as the reference answers it, and the
    case lands on its recorded error."""
    from pdebench_tpu_torch.oracle import OracleSolver, helmholtz

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh
                   if json.loads(l)["id"] == "helmholtz_no_exact_gaussian_source_k15")
    routes = []
    real = helmholtz.host_lu_route

    def spy(dim, k, opts):
        routes.append((opts["ksp_type"], real(dim, k, opts)))
        return routes[-1][1]

    monkeypatch.setattr(helmholtz, "host_lu_route", spy)
    res = OracleSolver(device=dev).solve(cfg)
    # the case's own solve on the lattice, its re-solve on the host LU
    assert routes == [("gmres", False), ("preonly", True)]
    assert res.solver_info["inner"] == "gmres+fused-richardson-cuda"
    ref_err = 0.016335751576818117  # results/oracle_sweep_progress.jsonl
    assert abs(res.baseline_error - ref_err) <= 1e-6 * ref_err


@pytest.mark.parametrize("ksp", ["preonly", "cg"])
def test_stalled_ir_on_cuda_raises_whatever_the_request(dev, monkeypatch, ksp):
    """poisson_high_contrast_no_exact with its lattice IR stalled: a
    preonly request and an iterative one both raise on the card."""
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.solvers import dispatch

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 40 * 25, 1.0, False, "fused-cg-cuda"

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh
                   if json.loads(l)["id"] == "poisson_high_contrast_no_exact")
    cfg["oracle_solver"] = dict(cfg["oracle_solver"], ksp_type=ksp)
    cfg.pop("reference_config")
    with pytest.raises(RuntimeError, match="did not converge"):
        OracleSolver(device=dev).solve(cfg)


# -- 3-D lattices (unit_cube P2: 65 fine taps) ------------------------------

RESID_FLOOR = 1e-5  # true-operator residual of a float32 Arnoldi cycle


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [33, 25])
def test_stencil_kernel_3d_matches_plain(dev, n, dtype):
    """The kernel on a 33^3 and a 25^3 lattice with the 65 taps of a P2
    stencil."""
    from pdebench_tpu_torch.fem.assemble import cell_batch, local_stiffness
    from pdebench_tpu_torch.fem.mesh import unit_cube_mesh
    from pdebench_tpu_torch.fem.spaces import FunctionSpace
    from pdebench_tpu_torch.solvers.stencil import lattice_operator_from_local

    V = FunctionSpace(unit_cube_mesh(2), 2)
    op = lattice_operator_from_local(
        local_stiffness(cell_batch(V.mesh, 2)), V.dofmap_scalar, V.ndof, V.dof_coords, "cpu"
    )
    offs, p = op.offsets, op.pad
    assert len(offs) == 65
    rng = np.random.default_rng(1)
    W = torch.as_tensor(rng.standard_normal((65, n, n, n)), device=dev).to(dtype)
    u = torch.as_tensor(rng.standard_normal((n, n, n)), device=dev).to(dtype)
    plan = stencil_kernel.StencilPlan((n, n, n), offs, p)
    before = stencil_kernel.LAUNCHES
    y = plan(W, u)
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.stencil_plain(u, W, offs, p)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err


def _p2_block_offsets():
    """The 19 (dy, dx) taps of a P2 vector lattice (elasticity, the
    Navier-Stokes velocity block)."""
    from pdebench_tpu_torch.fem.mesh import unit_square_mesh
    from pdebench_tpu_torch.fem.spaces import FunctionSpace
    from pdebench_tpu_torch.solvers.stencil import BlockLatticeWeightMap, detect_lattice

    V = FunctionSpace(unit_square_mesh(4), 2)
    wm = BlockLatticeWeightMap(detect_lattice(V.dof_coords), V.dofmap_scalar, 2)
    assert len(wm.offsets) == 19 and wm.pad == 2
    return wm.offsets, wm.pad


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [121, 161, 97])
def test_block_stencil_kernel_matches_plain(dev, n, dtype):
    """The d = 2 block kernel at nu010's and nu030's level-0 shapes (121^2,
    161^2) and navier_stokes_basic's velocity lattice (97^2), on random
    weights that are not symmetric per site: one launch per apply, within
    TOL of the block plain version; a CPU tensor launches nothing."""
    offs, p = _p2_block_offsets()
    rng = np.random.default_rng(2)
    W = torch.as_tensor(rng.standard_normal((19, n, n, 2, 2)), device=dev).to(dtype)
    u = torch.as_tensor(rng.standard_normal((n, n, 2)), device=dev).to(dtype)
    plan = stencil_kernel.StencilPlan((n, n), offs, p, ncomp=2)
    before = stencil_kernel.LAUNCHES
    y = plan(W, u)
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.block_stencil_plain(u, W, offs, p)
    assert y.dtype == dtype and y.shape == u.shape
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err
    y_cpu = plan(W.cpu(), u.cpu())
    assert stencil_kernel.LAUNCHES == before + 1
    assert float((y_cpu - y.cpu()).abs().max() / y_cpu.abs().max()) <= TOL[dtype]


def test_stencil_kernel_refuses_what_it_does_not_take(dev):
    """A d = 4 block stencil raises on CUDA tensors before any launch (its
    plain version takes it)."""
    plan = stencil_kernel.StencilPlan((5, 6), [(0, 0)], 0, ncomp=4)
    W, u = torch.zeros((1, 5, 6, 4, 4), device=dev), torch.zeros((5, 6, 4), device=dev)
    before = stencil_kernel.LAUNCHES
    with pytest.raises(ValueError):
        plan(W, u)
    assert stencil_kernel.LAUNCHES == before
    plan(W.cpu(), u.cpu())


def _p2_tet_block_map(n):
    """The d = 3 block weight map of a unit_cube P2 vector lattice of
    resolution n ((2 n + 1)^3 sites, 65 taps: the 3-D Stokes velocity
    block)."""
    from pdebench_tpu_torch.fem.mesh import unit_cube_mesh
    from pdebench_tpu_torch.fem.spaces import FunctionSpace
    from pdebench_tpu_torch.solvers.stencil import BlockLatticeWeightMap, detect_lattice

    V = FunctionSpace(unit_cube_mesh(n), 2, ncomp=3)
    wm = BlockLatticeWeightMap(detect_lattice(V.dof_coords), V.dofmap_scalar, 3)
    assert len(wm.offsets) == 65 and wm.pad == 2
    return wm


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [8, 3])
def test_block3_stencil_kernel_matches_plain(dev, n, dtype):
    """The d = 3 block kernel on stokes_3d_basic's 17^3 velocity lattice and
    a 7^3 one (every site within reach of an edge), random 3 x 3 weights
    not symmetric per site: one launch per apply, within TOL of the block
    plain version (which sums in the kernel's order); a CPU tensor
    launches nothing."""
    wm = _p2_tet_block_map(n)
    rng = np.random.default_rng(8)
    W = torch.as_tensor(rng.standard_normal((65,) + wm.shape + (3, 3)), device=dev).to(dtype)
    u = torch.as_tensor(rng.standard_normal(wm.shape + (3,)), device=dev).to(dtype)
    before = stencil_kernel.LAUNCHES
    y = wm.apply_grid(W, u)
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.block_stencil_plain(u, W, wm.offsets, wm.pad)
    assert y.dtype == dtype and y.shape == u.shape
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err
    # u one element off a 16-byte boundary: the d = 3 kernel takes it
    u_off = torch.cat([u.new_zeros(1), u.reshape(-1)])[1:].reshape(u.shape)
    assert torch.equal(wm.apply_grid(W, u_off), y)
    y_cpu = wm.apply_grid(W.cpu(), u.cpu())
    assert stencil_kernel.LAUNCHES == before + 2
    assert float((y_cpu - y.cpu()).abs().max() / y_cpu.abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_kernel_3d_beyond_the_tile_matches_plain(dev, dtype):
    """A 3-D stencil reaching 3 sites, beyond the tiled kernel's reach, on
    a 33^3 lattice: the flat kernel takes it, one launch, within TOL of
    the plain version."""
    offs = [(0, 0, 0)] + [
        tuple(v if a == i else 0 for a in range(3)) for i in range(3) for v in (-3, -2, -1, 1, 2, 3)
    ]
    n, K = 33, len(offs)
    rng = np.random.default_rng(4)
    W = torch.as_tensor(rng.standard_normal((K, n, n, n)), device=dev).to(dtype)
    u = torch.as_tensor(rng.standard_normal((n, n, n)), device=dev).to(dtype)
    plan = stencil_kernel.StencilPlan((n, n, n), offs, 3)
    before = stencil_kernel.LAUNCHES
    y = plan(W, u)
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.stencil_plain(u, W, offs, 3)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err


def test_block_operator_apply_is_one_launch(dev):
    """An elasticity operator's f64 and f32 applies: one launch each, no
    per-plane weight copies on the operator."""
    lat, _ = _elasticity(dev, "linear_elasticity_nu010")
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(lat.grid_shape), device=dev)
    for W in (lat.W_f64, lat.W):
        before = stencil_kernel.LAUNCHES
        y = lat.apply_grid_w(W, u.to(W.dtype))
        assert stencil_kernel.LAUNCHES == before + 1
        y_plain = stencil_kernel.block_stencil_plain(u.to(W.dtype), W, lat.offsets, lat.pad)
        assert float((y - y_plain).abs().max() / y_plain.abs().max()) <= TOL[W.dtype]
    assert not hasattr(lat, "planes") and not hasattr(lat.gmg.levels[0], "planes")
POISSON_3D = {
    # case id -> (recorded baseline_error, outer rounds of 25 fused PCG steps)
    "poisson_3d_kappa_expr": (3.7355568479364103e-4, 2),
    "poisson_3d_smooth_trig": (2.4147996840258627e-4, 2),
}


@pytest.mark.parametrize("iters,tol", [(1, TOL_VCYCLE), (25, TOL_CG)])
@pytest.mark.parametrize("case_id", sorted(POISSON_3D))
def test_fused_cg_kernel_3d_matches_plain(dev, case_id, iters, tol):
    """Kernel #2 on a 3-D hierarchy whose fine level has 65 taps: one PCG
    step (the 3-D V-cycle per element) and the main path's 25."""
    lat, mask = _case_gmg(dev, case_id)
    assert len(lat.shape) == 3 and len(lat.offsets) == 65 and not lat.gmg.padded
    inner = gmg_fused.build_fused_inner_cg(lat.gmg, iters, dev)
    r = _lattice_rhs(lat, mask, 12, dev)
    before = gmg_fused.LAUNCHES
    z = inner(r)
    assert gmg_fused.LAUNCHES == before + 1
    z_plain = inner.plain(r)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * scale)
    if iters == 25:
        lv0 = lat.gmg.levels[0]
        assert _true_residual(lat, lv0.W, r, z) < 1e-3


@pytest.mark.parametrize("cycles", [1, 2])
def test_fused_richardson_kernel_3d_matches_plain(dev, cycles):
    lat, mask, _ = _helmholtz(dev, "helmholtz_3d_k1_trig")
    assert len(lat.shape) == 3 and lat.gmg.surrogate and not lat.gmg.padded
    rich = gmg_fused.build_fused_richardson(lat.gmg, cycles, dev)
    r1, r2 = _lattice_rhs(lat, mask, 13, dev), _lattice_rhs(lat, mask, 14, dev)
    before = gmg_fused.LAUNCHES_RICHARDSON
    z1 = rich(r1)
    assert gmg_fused.LAUNCHES_RICHARDSON == before + 1
    z_plain = rich.plain(r1)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z1, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    torch.testing.assert_close(rich(r1 + 2.0 * r2), z1 + 2.0 * rich(r2), rtol=TOL_LINEAR, atol=TOL_LINEAR * scale)


def test_fused_gmres_kernel_3d_matches_plain(dev):
    """m = 1 per element on V, H and beta; m = 30 by its true-operator
    residual (65 operator taps, the TRUE constrained weights)."""
    lat, mask, W32c = _helmholtz(dev, "helmholtz_3d_k1_trig")
    assert W32c.shape == (65,) + lat.shape
    r = _lattice_rhs(lat, mask, 15, dev)
    one = gmg_fused.build_fused_inner_gmres(lat.gmg, 1, dev, lat.offsets)
    before = gmg_fused.LAUNCHES_GMRES
    got = one.raw(r, W32c)
    assert gmg_fused.LAUNCHES_GMRES == before + 1
    for g, w in zip(got, one.plain_raw(r, W32c)):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    # at k = 1 both cycles reach ~1e-6, where float32 Gram-Schmidt sets
    # the residual and no ratio holds: below RESID_FLOOR they pass
    fg = gmg_fused.build_fused_inner_gmres(lat.gmg, 30, dev, lat.offsets)
    rel = _true_residual(lat, W32c, r, fg(r, W32c))
    rel_plain = _true_residual(lat, W32c, r, fg.plain(r, W32c))
    assert rel < 0.1 and rel <= 2.0 * max(rel_plain, RESID_FLOOR), (rel, rel_plain)


def test_3d_oracle_runs_the_kernels(dev):
    """The 3-D main path: kernel #2 for Poisson, kernel #6 for Helmholtz
    (35,937 dofs, above the 20,000 of the whole fused Arnoldi cycle)."""
    from pdebench_tpu_torch.oracle import OracleSolver

    # the load vector sums in a fixed order: one round count per case
    want = {
        "poisson_3d_kappa_expr": (POISSON_3D["poisson_3d_kappa_expr"][0], "fused-cg-cuda", (2 * 25,)),
        "helmholtz_3d_k1_trig": (2.416098792334167e-4, "fused-gmres-cuda", (2 * 30,)),
    }
    for case_id, (ref_err, inner, iterations) in want.items():
        with open(DATA) as fh:
            cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
        gmg_fused.LAUNCHES = gmg_fused.LAUNCHES_GMRES = stencil_kernel.LAUNCHES = 0
        res = OracleSolver(device=dev).solve(cfg)
        assert res.solver_info["inner"] == inner
        assert res.solver_info["iterations"] in iterations
        assert (gmg_fused.LAUNCHES if "cg" in inner else gmg_fused.LAUNCHES_GMRES) > 0
        assert stencil_kernel.LAUNCHES > 0  # the f64 outer residual
        assert res.reference.shape == (25, 25, 25)
        assert abs(res.baseline_error - ref_err) <= 1e-6 * ref_err


# -- kernels #2 and #3 on one thread-block cluster ---------------------------


@pytest.mark.parametrize("iters,tol", [(1, TOL_VCYCLE), (25, TOL_CG)])
@pytest.mark.parametrize("resolution", [40, 48])
def test_fused_cg_kernel_uneven_bands(dev, resolution, iters, tol):
    """poisson_basic's hierarchy cut to 41/21/11/6 and 49/25/13/7 rows
    (with its probed level), which a cluster of 16 or 8 CTAs does not
    divide, the coarse ones fewer rows than CTAs: 1 and 25 PCG steps."""
    lat, mask = _case_gmg(dev, "poisson_basic", resolution)
    inner = gmg_fused.build_fused_inner_cg(lat.gmg, iters, dev)
    r = _lattice_rhs(lat, mask, 16, dev)
    z = inner(r)
    z_plain = inner.plain(r)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("resolution", [40, 48])
def test_fused_richardson_kernel_uneven_bands(dev, resolution, cycles):
    lat, mask, _ = _helmholtz(dev, "helmholtz_basic_k5", resolution)
    rich = gmg_fused.build_fused_richardson(lat.gmg, cycles, dev)
    r1, r2 = _lattice_rhs(lat, mask, 17, dev), _lattice_rhs(lat, mask, 18, dev)
    z1 = rich(r1)
    z_plain = rich.plain(r1)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z1, z_plain, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    torch.testing.assert_close(rich(r1 + 2.0 * r2), z1 + 2.0 * rich(r2), rtol=TOL_LINEAR, atol=TOL_LINEAR * scale)


@pytest.mark.parametrize("mode,iters", [("cg", 1), ("cg", 25), ("richardson", 1), ("richardson", 2)])
@pytest.mark.parametrize("case_id", ["poisson_basic", "poisson_3d_smooth_trig"])
def test_fused_cg_kernel_cta_levels_bitwise(dev, case_id, mode, iters):
    """CTA 0 solving two coarse levels in shared memory gives, bit for
    bit, what the same kernel gives with the finer of them as cluster
    stages and CTA 0 on the coarsest level alone (l* = L - 1)."""
    lat, mask = _case_gmg(dev, case_id)
    built = [gmg_fused.build_fused_inner_cg(lat.gmg, iters, dev, mode=mode, cta_levels=m)
             for m in (2, 1)]
    r = _lattice_rhs(lat, mask, 19, dev)
    before = gmg_fused.LAUNCHES_RICHARDSON if mode == "richardson" else gmg_fused.LAUNCHES
    z, z_coarsest = (f(r) for f in built)
    after = gmg_fused.LAUNCHES_RICHARDSON if mode == "richardson" else gmg_fused.LAUNCHES
    assert after == before + 2
    nlev = len(built[0].W)
    assert built[0]._cuda["lstar"] == nlev - 2 and built[1]._cuda["lstar"] == nlev - 1
    assert torch.equal(z, z_coarsest)
    z_plain = built[0].plain(r)
    tol = TOL_CG if iters == 25 else TOL_VCYCLE
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * float(z_plain.abs().max()))


def test_fused_cg_kernel_zero_residual(dev):
    """r = 0: every PCG denominator is 0 (guarded to 1), z stays 0."""
    lat, mask = _case_gmg(dev, "poisson_basic")
    inner = gmg_fused.build_fused_inner_cg(lat.gmg, 3, dev)
    z = inner(torch.zeros(int(np.prod(lat.shape)), dtype=torch.float32, device=dev))
    assert torch.equal(z, torch.zeros_like(z))


# -- kernel #5: the dynamic-weight block V-cycle chain (Navier-Stokes) ------

NS_LOW_RE = 3.041429902434237e-06  # navier_stokes_low_re's recorded error


def _ns_mms(resolution, nu=0.5):
    """The resolution-n MMS Taylor-Green case of tests/test_mixed_pdes.py."""
    return {
        "pde": {
            "type": "navier_stokes", "pde_params": {"nu": nu},
            "manufactured_solution": {
                "u": ["pi*cos(pi*y)*sin(pi*x)", "-pi*cos(pi*x)*sin(pi*y)"], "p": "0",
            },
        },
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": resolution, "cell_type": "triangle"},
        "fem": {"degree_u": 2, "degree_p": 1},
        "bc": {"dirichlet": {"on": "all", "value": ["0", "0"]}},
        "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 32, "ny": 32}},
        "oracle_solver": {"rtol": 1e-9, "atol": 1e-11, "max_it": 30, "init": "stokes"},
    }


def _random_block(shape, pad, seed):
    """A random block stencil (K, *shape, 2, 2), not symmetric per site
    and skewed in its diagonal blocks, on the taps |offset| <= pad, every
    boundary node clamped (the 17 x 17 three-level hierarchy of
    tests/test_torch_gmg_dyn.py, made here without jax, with skewed
    diagonal blocks)."""
    import itertools

    from pdebench_tpu_torch.solvers.stencil import constrain_stencil_weights

    rng = np.random.default_rng(seed)
    offs = list(itertools.product(range(-pad, pad + 1), repeat=2))
    W = rng.standard_normal((len(offs),) + shape + (2, 2))
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    for k, off in enumerate(offs):
        ok = np.ones(shape, dtype=bool)
        for g, o, n in zip(grids, off, shape):
            ok &= (g + o >= 0) & (g + o < n)
        W[k][~ok] = 0.0
        if off == (0, 0):
            # dominant, and skewed: D[b, a] read for D[a, b] shows
            W[k] += 4 * len(offs) * np.eye(2) + 2 * len(offs) * np.array([[0.0, 1.0], [-1.0, 0.0]])
    mask = np.zeros(shape, dtype=bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    return constrain_stencil_weights(W, offs, mask, d=2), offs, mask


def _dyn_hierarchy(dev, which, seed=0):
    """(spec, [levels of two weight sets], keep) of a kernel #5 hierarchy:
    the random 17 x 17 one (three levels, or one), or a resolution-12
    Navier-Stokes case's convected Jacobian (25/13) at the Stokes solution
    and at twice it."""
    from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem
    from pdebench_tpu_torch.solvers import gmg_dyn

    if which in ("random17", "one_level17"):
        Wc, offs, mask = _random_block((17, 17), 2, 21 + seed)
        # 17 x 17 x 2 = 578 values: a coarse size of 1000 leaves one level,
        # which the kernel sweeps as its coarsest
        coarse = 100 if which == "random17" else 1000
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gmg_dyn, "COARSE_SIZE", coarse)
            spec = gmg_dyn.build_dyn_block_spec(offs, (17, 17), 2, probe_W=Wc)
        assert len(spec.levels) == (3 if which == "random17" else 1)
        W2, _, _ = _random_block((17, 17), 2, 22 + seed)
        sets = [torch.as_tensor(w, dtype=torch.float32, device=dev) for w in (Wc, W2)]
        keep = torch.as_tensor(1.0 - mask.astype(np.float32), device=dev)
        return spec, [spec.build_levels(w) for w in sets], keep
    prob = NavierStokesProblem(_ns_mms(12), dev)
    x = prob.stokes_direct(prob.nu)
    sets = [prob.sst.wmapA.weights(prob.jacobian(s * x, prob.nu)).float() for s in (1.0, 2.0)]
    return prob.spec, [prob.levels(w) for w in sets], prob.keep_node32


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("which", ["random17", "ns_res12", "one_level17"])
def test_fused_dyn_block_kernel_matches_plain(dev, which, cycles):
    spec, (lv, _), keep = _dyn_hierarchy(dev, which)
    fused = gmg_fused.build_fused_dyn_block_vcycle(spec, cycles, dev)
    r = (torch.as_tensor(np.random.default_rng(5).standard_normal(keep.shape + (2,)),
                         dtype=torch.float32, device=dev) * keep[..., None]).reshape(-1)
    before = gmg_fused.LAUNCHES_DYN_BLOCK
    z = fused(r, lv)
    torch.cuda.synchronize()
    assert gmg_fused.LAUNCHES_DYN_BLOCK == before + 1
    want = fused.plain(r, lv)
    torch.testing.assert_close(z, want, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * float(want.abs().max()))


@pytest.mark.parametrize("which", ["random17", "ns_res12"])
def test_fused_dyn_block_kernel_takes_each_weight_set(dev, which):
    """Two weight sets on one spec, called in turn (each call packs or
    finds its own descriptor): each result is its own set's."""
    spec, levels, keep = _dyn_hierarchy(dev, which)
    fused = gmg_fused.build_fused_dyn_block_vcycle(spec, 1, dev)
    r = (torch.as_tensor(np.random.default_rng(6).standard_normal(keep.shape + (2,)),
                         dtype=torch.float32, device=dev) * keep[..., None]).reshape(-1)
    wants = [fused.plain(r, lv) for lv in levels]
    apart = float((wants[0] - wants[1]).abs().max() / wants[0].abs().max())
    assert apart > 1e-2, apart
    for lv, want in list(zip(levels, wants)) * 2:
        z = fused(r, lv)
        torch.testing.assert_close(z, want, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * float(want.abs().max()))


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("n", [21, 41])
def test_fused_dyn_block_kernel_uneven_bands(dev, n, cycles):
    """Random block hierarchies whose level row counts (21/11/6, 41/21/11/6)
    a cluster of 16 or 8 CTAs does not divide, the coarser ones fewer rows
    than CTAs (empty bands)."""
    from pdebench_tpu_torch.solvers import gmg_dyn

    Wc, offs, mask = _random_block((n, n), 2, 31)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gmg_dyn, "COARSE_SIZE", 100)
        spec = gmg_dyn.build_dyn_block_spec(offs, (n, n), 2, probe_W=Wc)
    assert len(spec.levels) >= 3
    lv = spec.build_levels(torch.as_tensor(Wc, dtype=torch.float32, device=dev))
    keep = torch.as_tensor(1.0 - mask.astype(np.float32), device=dev)
    fused = gmg_fused.build_fused_dyn_block_vcycle(spec, cycles, dev)
    r = (torch.as_tensor(np.random.default_rng(7).standard_normal((n, n, 2)),
                         dtype=torch.float32, device=dev) * keep[..., None]).reshape(-1)
    z = fused(r, lv)
    want = fused.plain(r, lv)
    torch.testing.assert_close(z, want, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * float(want.abs().max()))


@pytest.mark.parametrize("resolution", [40, 48])
def test_fused_gmres_kernel_uneven_bands(dev, resolution):
    """helmholtz_k12's hierarchy cut to 41/21/11 and 49/25/13 rows (plus
    the probed level): one step per element, and a whole cycle's true
    residual within twice the plain version's."""
    lat, mask, W32c = _helmholtz(dev, "helmholtz_k12_exponential_mode", resolution)
    r = _lattice_rhs(lat, mask, 8, dev)
    one = gmg_fused.build_fused_inner_gmres(lat.gmg, 1, dev, lat.offsets)
    for got, want in zip(one.raw(r, W32c), one.plain_raw(r, W32c)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale)
    fg = gmg_fused.build_fused_inner_gmres(lat.gmg, 30, dev, lat.offsets)
    rel = _true_residual(lat, W32c, r, fg(r, W32c))
    rel_plain = _true_residual(lat, W32c, r, fg.plain(r, W32c))
    assert rel < 0.1 and rel <= 2.0 * rel_plain, (rel, rel_plain)


def test_dyn_coarsening_on_the_card_matches_numpy(dev):
    """The coarsening of a block stencil on the card equals its numpy twin
    in float64 and to f32 rounding in float32, with TF32 allowed for both
    convolutions and matrix products: it depends on neither flag."""
    from pdebench_tpu_torch.solvers import gmg_dyn

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Wc, offs, _ = _random_block((33, 33), 2, 4)
        offs_c, C = gmg_dyn.galerkin_coeffs(offs, 2)
        valid = gmg_dyn._valid_planes(offs_c, (17, 17))
        want, _ = gmg_dyn.coarsen_block_np(Wc, offs, (33, 33), offs_c, C, valid)
        want = np.moveaxis(want, (-2, -1), (1, 2))
        planar = np.moveaxis(Wc, (-2, -1), (1, 2))
        for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
            got = gmg_dyn.coarsen_block_traced(
                torch.as_tensor(planar, dtype=dtype, device=dev), offs_c, C, valid, (17, 17)
            )
            err = float(np.abs(got.double().cpu().numpy() - want).max() / np.abs(want).max())
            assert got.dtype == dtype and err < tol, (dtype, err)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_navier_stokes_oracle_runs_the_kernel(dev):
    from pdebench_tpu_torch.oracle import OracleSolver

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh
                   if json.loads(l)["id"] == "navier_stokes_low_re")
    gmg_fused.LAUNCHES_DYN_BLOCK = 0
    res = OracleSolver(device=dev).solve(cfg)
    assert res.solver_info["inner"] == "newton-fgmres+fused-dyn-vcycle-cuda"
    assert gmg_fused.LAUNCHES_DYN_BLOCK > 0
    assert res.reference.shape == (50, 50) and np.isfinite(res.reference).all()
    # 3.95e-10 relative on the card (chip_smoke.py's tolerance)
    assert abs(res.baseline_error - NS_LOW_RE) <= 1e-6 * NS_LOW_RE


def test_unconverged_ns_linear_solve_on_cuda_raises(dev, monkeypatch):
    """A device linear solve that cannot converge (GMRES(2), one round)
    raises on the card, with the Newton step; no host LU behind it."""
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.oracle import navier_stokes as ns

    monkeypatch.setattr(ns, "NS_INNER_ITERS", 2)
    monkeypatch.setattr(ns, "NS_MAX_OUTER", 1)
    with pytest.raises(RuntimeError, match="Newton step 0"):
        OracleSolver(device=dev).solve(_ns_mms(12))


# -- Stokes: kernel #3 in the saddle preconditioner, #1's block forms -----

# case id -> recorded baseline_error (results/oracle_sweep_progress.jsonl)
STOKES_3D_BASIC = 0.0012933509802431167


def test_stokes_oracle_runs_the_kernels(dev):
    """stokes_basic at resolution 32 (65^2 velocity nodes) on the lattice
    MINRES: kernel #3 in every preconditioner application, #1's d = 2 block
    form in every saddle apply; stokes_3d_basic on the diagonal MINRES,
    #1's d = 3 block form, at its recorded error."""
    from pdebench_tpu_torch.oracle import OracleSolver

    cfg = _config("stokes_basic")
    cfg["mesh"]["resolution"] = 32
    stencil_kernel.LAUNCHES = gmg_fused.LAUNCHES_RICHARDSON = 0
    res = OracleSolver(device=dev).solve(cfg)
    info = res.solver_info
    assert info["inner"] == "minres+fused-richardson-cuda" and info["saddle_layout"] == "lattice"
    assert stencil_kernel.LAUNCHES > info["iterations"] and gmg_fused.LAUNCHES_RICHARDSON > info["iterations"]
    assert np.isfinite(res.reference).all()
    stencil_kernel.LAUNCHES = 0
    res = OracleSolver(device=dev).solve(_config("stokes_3d_basic"))
    assert res.solver_info["inner"] == "minres+diag" and stencil_kernel.LAUNCHES > 0
    assert abs(res.baseline_error - STOKES_3D_BASIC) <= 1e-5 * STOKES_3D_BASIC


def test_unconverged_stokes_minres_on_cuda_raises(dev, monkeypatch):
    """MINRES capped at 5 iterations raises on the card, with its counts;
    no host LU behind it."""
    from pdebench_tpu_torch.oracle import OracleSolver, stokes

    monkeypatch.setattr(stokes, "MAXITER", 5)
    cfg = _config("stokes_basic")
    cfg["mesh"]["resolution"] = 16
    with pytest.raises(RuntimeError, match="MINRES did not converge"):
        OracleSolver(device=dev).solve(cfg)


# -- heat, biharmonic, convection-diffusion: kernel #2 at 12 PCG steps on
# -- A = M + dt K, the f64 mass apply, the step loops on the card ----------

# case id -> recorded baseline_error (results/oracle_sweep_progress.jsonl)
HEAT_LARGE_KAPPA = 4.25500140632074e-4
CONVDIFF_PARABOLIC = 7.050554387484011e-4
RD_LINEAR_BASIC = 0.0011817187220116857
# the JAX package's CPU run of the case today (chip_smoke.py's BURGERS: its
# record predates the package's float32-weight outer for per-step systems)
BURGERS_SQUARE_V1 = 0.0019299427200282846


def _config(case_id):
    with open(DATA) as fh:
        return next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)


def _heat_operator(dev, case_id):
    """A heat case's step operators as its oracle builds them: the f32
    lattice of A = M + dt K with its hierarchy, the mass apply, the lattice
    mask, and M and the context for the weight map."""
    from pdebench_tpu_torch.oracle import base, heat, scalar

    cfg = _config(case_id)
    pde = cfg["pde"]
    cfg = scalar.override_bc_with_mms(cfg, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(cfg, dev)
    A, M = heat.step_matrices(ctx, pde, base.time_params(pde)[2])
    lat, _, (mass_apply,), _, n_inner = heat.step_operators(ctx, A, (M,), "cg", heat.INNER_ITERS)
    assert n_inner == 12
    return lat, ctx.mask.cpu().numpy(), mass_apply, M, ctx


@pytest.mark.parametrize("iters,tol", [(1, TOL_VCYCLE), (12, TOL_CG)])
@pytest.mark.parametrize("case_id", ["heat_large_kappa_fast_diffusion", "heat_3d_basic_decay"])
def test_fused_cg_kernel_heat_hierarchy_matches_plain(dev, case_id, iters, tol):
    """Kernel #2 on the mass-dominated hierarchies of A = M + dt K (P1
    121^2, P2 29^3): one PCG step, then heat's 12."""
    lat, mask, *_ = _heat_operator(dev, case_id)
    inner = gmg_fused.build_fused_inner_cg(lat.gmg, iters, dev)
    r = np.random.default_rng(5).standard_normal(lat.lattice.n_dof)
    r[mask] = 0.0
    r_lat = torch.as_tensor(lat.lattice.embed_np(r.astype(np.float32), 0.0), device=dev)
    before = gmg_fused.LAUNCHES
    z = inner(r_lat)
    assert gmg_fused.LAUNCHES == before + 1
    z_plain = inner.plain(r_lat)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("case_id", ["heat_large_kappa_fast_diffusion", "heat_3d_basic_decay"])
def test_mass_apply_matches_plain(dev, case_id):
    """The f64 mass apply of a step loop: one stencil kernel launch on the
    card, within 1e-12 of the plain version of the same weights on the CPU."""
    from pdebench_tpu_torch.solvers.stencil import lattice_weight_map

    lat, _, mass_apply, M, ctx = _heat_operator(dev, case_id)
    wm = lattice_weight_map(lat.lattice, ctx.space.dofmap_scalar)
    v = np.random.default_rng(6).standard_normal(ctx.space.ndof)
    before = stencil_kernel.LAUNCHES
    got = mass_apply(torch.as_tensor(v, device=dev))
    assert stencil_kernel.LAUNCHES == before + 1
    v_lat = torch.as_tensor(lat.lattice.embed_np(v, 0.0)).reshape(wm.shape)
    want = stencil_kernel.stencil_plain(
        v_lat, torch.as_tensor(wm.weights_np(M)), wm.offsets, wm.pad
    ).reshape(-1)[lat.lattice.inv]
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= TOL[torch.float64], err


@pytest.mark.parametrize("case_id,ref_err,inner", [
    ("heat_large_kappa_fast_diffusion", HEAT_LARGE_KAPPA, "fused-cg-cuda"),
    ("convdiff_parabolic_basic_manufactured", CONVDIFF_PARABOLIC, "gmres+vcycle"),
    ("reaction_diffusion_linear_basic", RD_LINEAR_BASIC, "fused-cg-cuda"),
    ("burgers_square_v1", BURGERS_SQUARE_V1, "gmres+vcycle"),
])
def test_step_loop_oracles_run_on_the_card(dev, case_id, ref_err, inner):
    from pdebench_tpu_torch.oracle import OracleSolver

    cfg = _config(case_id)
    stencil_kernel.LAUNCHES = gmg_fused.LAUNCHES = 0
    res = OracleSolver(device=dev).solve(cfg)
    info = res.solver_info
    assert info["inner"] == inner and "iterative_failed" not in info
    assert len(info["outer_rounds"]) == info["num_steps"]
    assert stencil_kernel.LAUNCHES > 0  # the mass apply and the f64 outer residual
    assert (gmg_fused.LAUNCHES > 0) == (inner == "fused-cg-cuda")
    assert np.isfinite(res.reference).all()
    assert abs(res.baseline_error - ref_err) <= 1e-6 * ref_err


def test_unconverged_heat_step_on_cuda_raises(dev, monkeypatch):
    """A step IR that does not converge raises on the card, naming the
    step and its residual; no host LU behind it."""
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.solvers import dispatch

    def stalled(op, b, *args, **kwargs):
        return torch.zeros_like(b), 60 * 12, 0.5, False, "fused-cg-cuda"

    monkeypatch.setattr(dispatch, "solve_constrained_ir", stalled)
    cfg = _config("heat_longer")
    cfg["mesh"]["resolution"] = 32
    with pytest.raises(RuntimeError, match=r"step 1 of 10 did not converge.*'residual': 0\.5"):
        OracleSolver(device=dev).solve(cfg)


def test_step_weights_on_the_card_match_the_cpu_build(dev):
    """Burgers' per-step weights W_c + W(u) (P2, 73 x 73 nodes): the same
    float32 bits on the card as on the CPU (exact float64 products, one
    float32 rounding an add), on every call; then one stencil kernel
    launch with them, within tolerance of the plain version."""
    from pdebench_tpu_torch.oracle import base, burgers, scalar

    cfg = _config("burgers_square_v1")
    cfg["mesh"]["resolution"] = 36
    u_exact = cfg["pde"]["manufactured_solution"]["u"]
    ctx = scalar.setup_scalar(scalar.override_bc_with_mms(cfg, u_exact), dev)
    A_c, _ = burgers.step_matrices(ctx.cb, 0.01, 0.01)
    lat, wm, bwm = scalar.bilinear_step_lattice(ctx, A_c, lambda: burgers.advection_tensor(ctx.cb))
    u = base.interpolate_nodal(ctx.space, u_exact, t=0.0).astype(np.float32)
    u_lat = torch.as_tensor(lat.lattice.embed_np(u, 0.0).reshape(wm.shape))
    W_c = torch.as_tensor(wm.weights_np(A_c)).to(torch.float32)
    want = W_c + bwm.weights_w(bwm.device_stack("cpu"), u_lat)
    P = bwm.device_stack(dev)
    for _ in range(2):
        got = W_c.to(dev) + bwm.weights_w(P, u_lat.to(dev))
        assert torch.equal(got.cpu(), want)
    v = torch.as_tensor(np.random.default_rng(7).standard_normal(wm.shape), dtype=torch.float32)
    before = stencil_kernel.LAUNCHES
    y = wm.apply_grid(got, v.to(dev))
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.stencil_plain(v, want, wm.offsets, wm.pad)
    scale = float(y_plain.abs().max())
    torch.testing.assert_close(y.cpu(), y_plain, rtol=TOL[torch.float32], atol=TOL[torch.float32] * scale)


def test_unconverged_newton_step_on_cuda_raises(dev):
    """A Newton step that stops above its tolerance (max_it 0) raises on
    the card, naming the step."""
    from pdebench_tpu_torch.oracle import OracleSolver

    cfg = _config("reaction_diffusion_cubic_manufactured")
    cfg["mesh"]["resolution"] = 72
    cfg["oracle_solver"]["max_it"] = 0
    with pytest.raises(RuntimeError, match=r"Newton step 1 of 40 did not converge"):
        OracleSolver(device=dev).solve(cfg)


def test_cell_batch_jacobian_on_the_card(dev, monkeypatch):
    """Above the bilinear map's size gate (patched to 0 here) the Newton
    Jacobian's weights come from the cell batch on the card, summed in a
    fixed order (`LatticeWeightMap.weights`): reaction_diffusion_cubic_
    manufactured at P1 resolution 72, 40 steps, every Newton step
    converged, the same iteration counts on a second solve, and the grid
    and error within 1e-7 / 1e-6 relative of the case solved through the
    bilinear map."""
    from pdebench_tpu_torch.oracle import OracleSolver, scalar

    cfg = _config("reaction_diffusion_cubic_manufactured")
    cfg["mesh"]["resolution"] = 72
    bilinear = OracleSolver(device=dev).solve(copy.deepcopy(cfg))
    assert bilinear.solver_info["jacobian_weights"] == "bilinear"
    monkeypatch.setattr(scalar, "BILINEAR_MAX_ENTRIES", 0)
    cells = []
    for _ in range(2):
        before = stencil_kernel.LAUNCHES
        cells.append(OracleSolver(device=dev).solve(copy.deepcopy(cfg)))
        assert stencil_kernel.LAUNCHES > before
    for cell in cells:
        info = cell.solver_info
        assert info["jacobian_weights"] == "cell-batch" and info["inner"] == "gmres+vcycle"
        assert "iterative_failed" not in info
        assert info["linear_iterations"] == cells[0].solver_info["linear_iterations"]
        gap = np.linalg.norm(cell.reference - bilinear.reference) / np.linalg.norm(bilinear.reference)
        assert gap < 1e-7, gap
        assert abs(cell.baseline_error - bilinear.baseline_error) <= 1e-6 * bilinear.baseline_error


# wave_tjunc_cos2's recorded error (P2, masked non-square 105 x 161 lattice)
WAVE_TJUNC_COS2 = 0.0017096777485136867


def _wave_operator(dev, case_id):
    """A wave case's step operators as its oracle builds them: the f32
    lattice of A = M / dt^2 + c^2 K / 4 on its masked lattice with the GMG
    hierarchy, the mask, the f64 mass and stiffness applies, M, K and the
    context."""
    from pdebench_tpu_torch.fem.assemble import local_mass, local_stiffness
    from pdebench_tpu_torch.oracle import base, heat, scalar, wave

    cfg = _config(case_id)
    pde = cfg["pde"]
    cfg = scalar.override_bc_with_mms(cfg, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(cfg, dev)
    dt = base.time_params(pde)[2]
    M, K = local_mass(ctx.cb), local_stiffness(ctx.cb)
    A = M / dt**2 + wave.THETA * float(pde["pde_params"].get("c", 1.0)) ** 2 * K
    lat, _, appliers, _, n_inner = heat.step_operators(ctx, A, (M, K), "cg", heat.INNER_ITERS)
    assert n_inner == 12 and lat.lattice.masked
    return lat, ctx.mask.cpu().numpy(), appliers, (M, K), ctx


def test_wave_applies_on_masked_nonsquare_lattice_match_plain(dev):
    """wave_tjunc_cos2's f64 mass and stiffness applies on its masked
    105 x 161 lattice: one stencil kernel launch each, within 1e-12 of the
    plain version of the same weights on the CPU."""
    from pdebench_tpu_torch.solvers.stencil import lattice_weight_map

    lat, _, appliers, locals_, ctx = _wave_operator(dev, "wave_tjunc_cos2")
    assert lat.shape == (105, 161)
    wm = lattice_weight_map(lat.lattice, ctx.space.dofmap_scalar)
    v = np.random.default_rng(8).standard_normal(ctx.space.ndof)
    v_lat = torch.as_tensor(lat.lattice.embed_np(v, 0.0)).reshape(wm.shape)
    for apply64, A_local in zip(appliers, locals_):
        before = stencil_kernel.LAUNCHES
        got = apply64(torch.as_tensor(v, device=dev))
        assert stencil_kernel.LAUNCHES == before + 1
        want = stencil_kernel.stencil_plain(
            v_lat, torch.as_tensor(wm.weights_np(A_local)), wm.offsets, wm.pad
        ).reshape(-1)[lat.lattice.inv]
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= TOL[torch.float64], err


@pytest.mark.parametrize("iters,tol", [(1, TOL_VCYCLE), (12, TOL_CG)])
def test_fused_cg_kernel_masked_nonsquare_hierarchy_matches_plain(dev, iters, tol):
    """Kernel #2 on wave_tjunc_cos2's masked 105 x 161 / 53 x 81 / 27 x 41
    hierarchy: one PCG step, then wave's 12."""
    lat, mask, *_ = _wave_operator(dev, "wave_tjunc_cos2")
    inner = gmg_fused.build_fused_inner_cg(lat.gmg, iters, dev)
    assert inner.dims[0] == (1, 105, 161)
    r = np.random.default_rng(9).standard_normal(lat.lattice.n_dof)
    r[mask] = 0.0
    r_lat = torch.as_tensor(lat.lattice.embed_np(r.astype(np.float32), 0.0), device=dev)
    before = gmg_fused.LAUNCHES
    z = inner(r_lat)
    assert gmg_fused.LAUNCHES == before + 1
    z_plain = inner.plain(r_lat)
    scale = float(z_plain.abs().max())
    torch.testing.assert_close(z, z_plain, rtol=tol, atol=tol * scale)


def test_wave_oracle_runs_on_the_card(dev):
    """wave_tjunc_cos2 through OracleSolver on the card: kernel #2 in every
    round, kernel #1 in every step, the recorded error, NaN exactly outside
    the t_junction."""
    from pdebench_tpu_torch.oracle import OracleSolver

    stencil_kernel.LAUNCHES = gmg_fused.LAUNCHES = 0
    res = OracleSolver(device=dev).solve(_config("wave_tjunc_cos2"))
    info = res.solver_info
    assert info["inner"] == "fused-cg-cuda" and "iterative_failed" not in info
    assert len(info["outer_rounds"]) == info["num_steps"] == 40
    assert stencil_kernel.LAUNCHES >= 3 * 40 and gmg_fused.LAUNCHES >= 40
    inside = ~np.isnan(res.reference)
    assert inside.any() and not inside.all() and np.isfinite(res.reference[inside]).all()
    assert abs(res.baseline_error - WAVE_TJUNC_COS2) <= 1e-6 * WAVE_TJUNC_COS2


def test_amg_vcycle_on_the_card_matches_its_cpu_twin(dev):
    """SA-AMG off the lattice: the hierarchy of a distmesh circle's
    constrained P2 stiffness (poisson_circle_sinsin at resolution 40),
    its levels on the card and on the CPU; one V-cycle of each on the same
    residual within TOL, and the same bits on a second call on the card."""
    from pdebench_tpu_torch.fem.assemble import LocalOperator, local_stiffness
    from pdebench_tpu_torch.oracle import scalar
    from pdebench_tpu_torch.solvers import amg

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == "poisson_circle_sinsin")
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = 40
    ctx = scalar.setup_scalar(cfg, "cpu")
    K = torch.as_tensor(local_stiffness(ctx.cb))
    A = LocalOperator(K, ctx.space.dofmap_scalar, ctx.space.ndof).to_scipy()
    mask = ctx.mask.numpy()
    M64, M32, hier = amg.setup_amg_masked_pair(A, mask, device=dev)
    C64, C32, _ = amg.setup_amg_masked_pair(A, mask)
    assert len(hier.levels) >= 2 and hier.coarse_inv.device.type == "cuda"
    r = np.random.default_rng(5).standard_normal(A.shape[0])
    for dtype, M, C in ((torch.float64, M64, C64), (torch.float32, M32, C32)):
        rd = torch.as_tensor(r, device=dev).to(dtype)
        z = M(rd)
        assert torch.equal(M(rd), z)
        zc = C(torch.as_tensor(r).to(dtype))
        err = float((z.cpu() - zc).abs().max() / zc.abs().max())
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("case_id,resolution,inner", [
    ("burgers_circle_v1", 40, "jacobi-gmres-ir"),
    ("rd_circle_allencahn", 40, "jacobi-gmres-ir"),
])
def test_cell_local_step_loop_on_the_card(dev, case_id, resolution, inner):
    """A step loop off the lattice on the card (a distmesh circle, 3
    steps): each step's cell batch assembled on the device, the
    cell-local refinement with Jacobi; two solves give the same bits and
    the same per-step counts, and the grid is the CPU route's to 1e-9 of
    its largest magnitude. No kernel of the table runs there."""
    from pdebench_tpu_torch.oracle import OracleSolver

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = copy.deepcopy(cfg)
    cfg["mesh"]["resolution"] = resolution
    if "time" in cfg["pde"]:
        tc = cfg["pde"]["time"]
        tc["t_end"] = tc.get("t0", 0.0) + 3 * tc["dt"]
    else:
        cfg["pde"]["t_final"] = 3 * cfg["pde"].get("dt", 0.01)
    before = stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES
    runs = [OracleSolver(device="cuda").solve(copy.deepcopy(cfg)) for _ in range(2)]
    assert (stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES) == before
    cpu = OracleSolver(device="cpu").solve(copy.deepcopy(cfg))
    counts = [(r.solver_info.get("outer_rounds"), r.solver_info.get("linear_iterations")) for r in runs]
    for r in runs:
        assert r.solver_info["inner"] == inner and "iterative_failed" not in r.solver_info
    assert counts[0] == counts[1]
    a, b = runs[0].reference, runs[1].reference
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])
    want = cpu.reference[~np.isnan(cpu.reference)]
    assert np.abs(a[~np.isnan(a)] - want).max() <= 1e-9 * np.abs(want).max()


def _le3d_operator(dev, case_id="le_3d_basic"):
    """A 3-D elasticity case's f32 d = 3 block lattice operator, built on
    the card as the oracle builds it, with its block hierarchy attached."""
    from pdebench_tpu_torch.fem.assemble import local_elasticity
    from pdebench_tpu_torch.oracle import linear_elasticity, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = scalar.override_bc_with_mms(cfg, list(cfg["pde"]["manufactured_solution"]["u"]))
    lam, mu = linear_elasticity.lame_from_params(cfg["pde"]["pde_params"])
    ctx = scalar.setup_scalar(cfg, dev, ncomp=-1)
    lat = scalar.maybe_block_lattice32(ctx, local_elasticity(ctx.cb, mu, lam))
    attach_lattice_gmg(lat, ctx.mask.cpu().numpy())
    return lat


def test_block3_apply_on_elasticity_levels_matches_plain(dev):
    """The d = 3 block form, f32, on every level of le_3d_basic's block
    hierarchy (21^3 with 65 taps, 11^3 with 27) and f64 with the fine
    level's weights (the refinement's residual): one launch each, the
    plain version's sums."""
    lat = _le3d_operator(dev)
    assert lat.gmg.d == 3 and not lat.gmg.padded
    assert [lv.shape for lv in lat.gmg.levels] == [(21, 21, 21), (11, 11, 11)]
    rng = np.random.default_rng(4)
    pairs = [(lv.plan, lv.W, lv.offsets, lv.pad) for lv in lat.gmg.levels]
    pairs.append((lat.plan, lat.W_f64, lat.offsets, lat.pad))
    for plan, W, offsets, pad in pairs:
        u = torch.as_tensor(rng.standard_normal(plan.u_shape), device=dev).to(W.dtype)
        before = stencil_kernel.LAUNCHES
        y = plan(W, u)
        assert stencil_kernel.LAUNCHES == before + 1
        y_plain = stencil_kernel.block_stencil_plain(u, W, offsets, pad)
        err = float((y - y_plain).abs().max() / y_plain.abs().max())
        assert err <= TOL[W.dtype], (plan.u_shape, err)


def test_block_hierarchy_on_the_card_equals_the_cpu_build(dev, monkeypatch):
    """The block coarsening's comb probes run on the lattice's device in
    separate float64 multiplies and adds: le_3d_basic's hierarchy built on
    the card is the CPU build's, array for array."""
    from pdebench_tpu_torch.oracle import scalar

    monkeypatch.setattr(scalar, "BLOCK_LATTICE_3D_DEVICES", ("cuda", "cpu"))
    a, b = _le3d_operator(dev).gmg, _le3d_operator(torch.device("cpu")).gmg
    assert len(a.levels) == len(b.levels) == 2
    for la, lb in zip(a.levels, b.levels):
        assert (la.shape, la.offsets, la.omega) == (lb.shape, lb.offsets, lb.omega)
        assert torch.equal(la.W.cpu(), lb.W) and torch.equal(la.diag_inv.cpu(), lb.diag_inv)
    assert torch.equal(a.coarse_inv.cpu(), b.coarse_inv)


def test_le_3d_solve_on_the_card(dev):
    """le_3d_basic on the card: the d = 3 block lattice, CG preconditioned
    by the PyTorch block V-cycle (stencil-cg, no fall-through), every level
    apply and the f64 residual on the stencil kernel; the recorded error
    (results/oracle_sweep_progress.jsonl) to 1e-6 relative."""
    from pdebench_tpu_torch.oracle import OracleSolver

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == "le_3d_basic")
    before = stencil_kernel.LAUNCHES
    res = OracleSolver(device="cuda").solve(copy.deepcopy(cfg))
    info = res.solver_info
    assert info["inner"] == "stencil-cg" and info["pc_used"] == "gmg+stencil-ir32"
    assert "iterative_failed" not in info and "gmg_failed" not in info
    assert stencil_kernel.LAUNCHES > before
    assert abs(res.baseline_error - 1.0009789573300774e-3) <= 1e-6 * 1.0009789573300774e-3
