"""Smoke run of pdebench_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes of the main path, then solves the two
dataset cases `poisson_basic` (P1, 121 x 121 lattice) and
`poisson_p3_variable_kappa_mild` (P3, 241 x 241 lattice, 37 taps) through
`OracleSolver(device="cuda")` and checks their errors against the
recorded values. One line per phase; any failure raises and exits
non-zero. The last two lines are a JSON object with per-kernel launches,
errors and times, and the contract line {"ok": true, "device": ...}.

Needs a CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and the
repository checkout around this file; imports neither jax nor
pdebench_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = {
    # case id -> (recorded baseline_error, relative tolerance, outer
    # rounds of 25 fused PCG steps the solve takes to reach rtol 1e-10)
    "poisson_basic": (1.924806820736457e-4, 1e-6, 2),
    "poisson_p3_variable_kappa_mild": (3.75760311692739e-9, 1e-5, 3),
}
SOLVES = 3  # whole-case solves per case on the main path
TOL_F64 = 1e-12  # stencil kernel vs plain, max |diff| / max |plain|
TOL_F32 = 1e-5
# fused inner CG vs plain: f32 sums in another order through 25 PCG
# steps (the tolerance tests/test_gmg_fused.py holds the Pallas kernel to)
TOL_CG = 2e-4
# one PCG step, z = alpha V(r): f32 sums in another order through one
# V-cycle, where a fault in the V-cycle shows at full size
TOL_VCYCLE = 1e-5


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """CUDA-event time per call: `calls` back-to-back calls between two
    events, median over `samples` such runs, after one warm-up call. For
    a launch-bound kernel this is the host's per-call cost."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def case_operator(config, device):
    """The case's f32 lattice operator with its GMG hierarchy attached,
    built through the port's setup path."""
    from pdebench_tpu_torch.fem.assemble import local_stiffness
    from pdebench_tpu_torch.oracle import base, scalar
    from pdebench_tpu_torch.solvers.gmg import attach_lattice_gmg

    pde = config["pde"]
    config = scalar.override_bc_with_mms(config, pde["manufactured_solution"]["u"])
    ctx = scalar.setup_scalar(config, device)
    kappa = base.coefficient_fn(pde["coefficients"]["kappa"], ctx.dim, device)
    lat = scalar.maybe_lattice32(ctx, local_stiffness(ctx.cb, kappa(ctx.qpts())))
    mask = ctx.mask.cpu().numpy()
    attach_lattice_gmg(lat, mask)
    return lat, mask


def main() -> int:
    # (0) the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch import _build
    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("0", f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # (1) build
    for name in ("stencil_apply", "gmg_fused_cg"):
        t0 = time.perf_counter()
        _build.load(name)
        usage = [ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        say("1", f"built {name} in {time.perf_counter() - t0:.2f} s; " + " | ".join(usage))

    cases = {}
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] in CASES:
                cases[c["id"]] = c["oracle_config"]
    ops = {cid: case_operator(cases[cid], dev) for cid in CASES}

    # (2) stencil kernel vs plain at the main path's shapes
    rng = np.random.default_rng(0)
    report = {}
    for cid, (lat, _) in ops.items():
        ny, nx = lat.shape
        for W, tol in ((lat.W_f64, TOL_F64), (lat.W, TOL_F32)):
            u = torch.as_tensor(rng.standard_normal(lat.shape), device=dev).to(W.dtype)
            up = torch.nn.functional.pad(u, (lat.pad,) * 4)
            args = (up, W, lat.offsets, lat.pad)
            yk = stencil_kernel.stencil_apply_2d(*args)  # CUDA tensors: the kernel
            yp = stencil_kernel.stencil_apply_2d_torch(*args)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max() / yp.abs().max())
            ms = median_ms(lambda: stencil_kernel.stencil_apply_2d(*args))
            plain_ms = median_ms(lambda: stencil_kernel.stencil_apply_2d_torch(*args))
            tag = f"{ny}x{nx} K={len(lat.offsets)} pad={lat.pad} {str(W.dtype)[6:]}"
            say("2", f"stencil_apply_2d {tag}: max rel diff {err:.3e} (tol {tol:g}); "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not err <= tol:
                raise AssertionError(f"stencil kernel disagrees at {tag}: {err}")
            if cid == "poisson_basic" and W.dtype == torch.float64:
                report["stencil_apply_2d"] = dict(
                    max_abs_err=float((yk - yp).abs().max()), ms=ms, plain_ms=plain_ms
                )

    # (3) fused inner CG vs plain on each case's own hierarchy: one PCG
    # step (the V-cycle's arithmetic, tightly), then the main path's 25
    for cid, (lat, mask) in ops.items():
        r = rng.standard_normal(lat.lattice.n_dof)
        r[mask] = 0.0
        r_lat = torch.as_tensor(
            lat.lattice.embed_np(r.astype(np.float32), 0.0), device=dev
        )
        step = gmg_fused.build_fused_inner_cg(lat.gmg, 1, dev)
        zk, zp = step(r_lat), step.plain(r_lat)
        torch.cuda.synchronize()
        diff = float((zk - zp).abs().max())
        scale = float(zp.abs().max())
        say("3", f"fused_inner_cg {cid} 1 PCG step: max abs diff {diff:.3e} "
                 f"(scale {scale:.3e}, rtol=atol/scale={TOL_VCYCLE:g})")
        if not torch.allclose(zk, zp, rtol=TOL_VCYCLE, atol=TOL_VCYCLE * scale):
            raise AssertionError(f"fused V-cycle step disagrees on {cid}: {diff}")

        fused = gmg_fused.build_fused_inner_cg(lat.gmg, 25, dev)
        zk = fused(r_lat)  # CUDA tensor: the kernel
        zp = fused.plain(r_lat)
        torch.cuda.synchronize()
        diff = float((zk - zp).abs().max())
        scale = float(zp.abs().max())
        ok = torch.allclose(zk, zp, rtol=TOL_CG, atol=TOL_CG * scale)
        # the correction must solve the constrained fine system
        W0 = lat.gmg.levels[0]
        Az = stencil_kernel.stencil_apply_2d_torch(
            torch.nn.functional.pad(zk.reshape(lat.shape), (W0.pad,) * 4),
            W0.W, W0.offsets, W0.pad,
        ).reshape(-1)
        rel = float(torch.linalg.norm(r_lat - Az) / torch.linalg.norm(r_lat))
        ms = median_ms(lambda: fused(r_lat), calls=5, samples=3)
        plain_ms = median_ms(lambda: fused.plain(r_lat), calls=1, samples=3)
        n_lv = len(fused.W)
        say("3", f"fused_inner_cg {cid} {n_lv} levels {[tuple(W.shape) for W in fused.W]}: "
                 f"max abs diff {diff:.3e} (scale {scale:.3e}, rtol=atol/scale={TOL_CG:g}) "
                 f"residual {rel:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not ok or not rel < 1e-3:
            raise AssertionError(f"fused inner CG disagrees on {cid}: {diff}, residual {rel}")
        if cid == "poisson_basic":
            report["gmg_fused_cg"] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms)

    # (4) the main path: OracleSolver on the card, SOLVES whole-case
    # solves per case, setup caches cleared before each
    from pdebench_tpu_torch.oracle import base

    stencil_kernel.LAUNCHES = 0
    gmg_fused.LAUNCHES = 0
    solver = OracleSolver(device="cuda")
    for cid, (ref_err, tol, outer_want) in CASES.items():
        warm, total = [], []
        for _ in range(SOLVES):
            base.clear_setup_caches()
            res = solver.solve(cases[cid])
            info = res.solver_info
            grid = np.asarray(res.reference)
            rel = abs(res.baseline_error - ref_err) / ref_err
            outer = info.get("iterations", 0) // 25
            say("4", f"{cid}: baseline_error {res.baseline_error!r} (recorded "
                     f"{ref_err!r}, rel {rel:.2e}, tol {tol:g}); baseline_time "
                     f"{res.baseline_time:.4f} s, t_setup {info['t_setup']:.4f} s, "
                     f"warm solve {info['t_warm']:.4f} s, cold {info['t_cold']:.4f} s; "
                     f"inner {info.get('inner')}, outer {outer}, residual "
                     f"{info.get('residual')}")
            if grid.shape != (50, 50) or not np.isfinite(grid).all():
                raise AssertionError(f"{cid}: bad grid {grid.shape}")
            if not rel <= tol:
                raise AssertionError(f"{cid}: baseline_error off by {rel:.2e}")
            if info.get("inner") != "fused-cg-cuda" or "iterative_failed" in info:
                raise AssertionError(f"{cid}: inner {info.get('inner')}, {info}")
            if outer != outer_want:
                raise AssertionError(f"{cid}: {outer} outer rounds, expected {outer_want}")
            warm.append(info["t_warm"])
            total.append(res.baseline_time)
        say("4", f"{cid} over {SOLVES} solves: warm solve median "
                 f"{statistics.median(warm):.4f} s ({min(warm):.4f}-{max(warm):.4f}), "
                 f"baseline_time median {statistics.median(total):.4f} s "
                 f"({min(total):.4f}-{max(total):.4f})")
    launches = {
        "stencil_apply_2d": stencil_kernel.LAUNCHES,
        "gmg_fused_cg": gmg_fused.LAUNCHES,
    }
    say("4", f"kernel launches on the main path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    meta = {
        "stencil_apply_2d": dict(
            source="pdebench_tpu_torch/csrc/stencil_apply.cu",
            replaces="pdebench_tpu/solvers/stencil_pallas.py:131",
        ),
        "gmg_fused_cg": dict(
            source="pdebench_tpu_torch/csrc/gmg_fused_cg.cu",
            replaces="pdebench_tpu/solvers/gmg_fused.py:434",
        ),
    }
    kernels = [
        dict(name=name, route="cuda", **meta[name], launches=launches[name], **report[name])
        for name in ("stencil_apply_2d", "gmg_fused_cg")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
