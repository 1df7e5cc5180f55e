"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
neither jax nor the JAX package, so it also runs on a machine without jax
(there, skip tests/conftest.py, which sets jax up):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

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
    offs = _offsets(p)
    assert len(offs) == {1: 7, 3: 37}[p]
    rng = np.random.default_rng(0)
    W = torch.as_tensor(rng.standard_normal((len(offs), n, n)), device=dev).to(dtype)
    up = F.pad(torch.as_tensor(rng.standard_normal((n, n)), device=dev).to(dtype), (p,) * 4)
    before = stencil_kernel.LAUNCHES
    y = stencil_kernel.stencil_apply_2d(up, W, offs, p)
    assert stencil_kernel.LAUNCHES == before + 1
    y_plain = stencil_kernel.stencil_apply_2d_torch(up, W, offs, p)
    assert y.dtype == dtype and y.device == W.device
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err


def _case_gmg(dev, case_id):
    from pdebench_tpu_torch.fem.assemble import local_stiffness
    from pdebench_tpu_torch.oracle import base, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    with open(DATA) as fh:
        cfg = next(json.loads(l)["oracle_config"] for l in fh if json.loads(l)["id"] == case_id)
    cfg = scalar.override_bc_with_mms(cfg, cfg["pde"]["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(cfg, dev)
    kappa = base.coefficient_fn(cfg["pde"]["coefficients"]["kappa"], 2, dev)
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
    assert res.solver_info["iterations"] == 2 * 25  # two outer rounds
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
