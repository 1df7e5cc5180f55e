"""CUDA-event times of the fused GMG kernels at the main paths' shapes.

    python3 scripts/torch_kernel_times.py [--root DIR] [--3d]
    python3 scripts/torch_kernel_times.py [--root DIR] --block-variants
    python3 scripts/torch_kernel_times.py [--root DIR] --stencil
    python3 scripts/torch_kernel_times.py [--root DIR] --weights

Builds the operators and hierarchies of chip_smoke.py's 2-D cases (with
--3d also its 3-D ones) through the `chip_smoke.py` of the checkout at DIR
(default: this script's own), imports `pdebench_tpu_torch` from there too,
and times each fused kernel on a random lattice residual: kernel #2 (25
PCG steps), #3 (a chain of 2 V-cycles), #6 (an m = 30 Arnoldi cycle) and
#4 (25 block PCG steps), each the median over 5 runs of back-to-back calls
between two CUDA events; and kernel #5 on
navier_stokes_basic's hierarchy (the Jacobian at the Stokes solution), 1
and 2 cycles, over runs of 20 calls. With --3d, #2 runs on every 3-D
Poisson case of the dataset whose hierarchy the fused kernels take (not
padded), #6 on every 3-D Helmholtz case of the dataset whose solve takes it (a hierarchy the fused
kernels take, at least dispatch.FUSED_ARNOLDI_MIN_DOFS sites), and #3 on
each of those and on helmholtz_3d_k1_trig at mesh resolution 12 (the
25^3 hierarchy of the main path's 3-D Richardson route). Two
checkouts run in one call, in turns (parent, change, change, parent),
compare two versions of the kernels on one card. With --stencil only the
lattice applies run, as their callers make them: apply_grid_w of each
scalar operator of chip_smoke.py's 2-D and 3-D cases and of each
elasticity operator, and the Navier-Stokes velocity block's
apply_grid (navier_stokes_basic, the weights of the Jacobian at the
Stokes solution), in float64 and float32 on a random field; each the
median over 5 runs of 20 back-to-back calls between two CUDA events
(host work included), and its device time per call: 20 calls under
torch.profiler, every device activity summed and divided by 20 (pads,
copies and adds of a caller included). With --block-variants only
kernel #4 runs, on both elasticity
hierarchies, as built by default and with CTA 0 on the coarsest level
alone (`cta_levels=1`), where the checkout's builder takes that
argument: the variants in turns, forward and then backward, each the
median of 5 runs. With --weights only the per-step weight build runs
(`BilinearLatticeWeightMap.weights_w`, PyTorch, no kernel of its own) on
the first step of burgers_square_v1 and reaction_diffusion_allen_cahn_p2,
as `chip_smoke.py` phase 3g sets them up: the median over 5 runs of 20
back-to-back builds between two CUDA events, the device time a build
(profiler) and the bytes of P on the card.
Prints the card's name and power limit, then one JSON line
{"root": DIR, "ms": {"<kernel> <case>": ms, ...}, "device_us": {...}}.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled_us(fn, calls: int = 20, tries: int = 3) -> float:
    """Device time per call of fn: the device kernels torch.profiler
    records over `calls` calls, after a warm-up call. A profile that
    records no device activity (seen after many profiles in one process)
    is taken again, up to `tries` profiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            return sum(spans) / calls
    raise RuntimeError(f"the profiler recorded no device activity in {tries} profiles")


def block_variants(cs, gmg_fused, cases, elasticity, dev, rng, ms) -> None:
    """Kernel #4 on each elasticity hierarchy in the variants the
    checkout's builder takes, in turns (forward, then backward)."""
    import inspect

    params = inspect.signature(gmg_fused.build_fused_block_inner_cg).parameters
    variants = {"default": {}}
    if "cta_levels" in params:
        variants["CTA 0 on the coarsest level"] = dict(cta_levels=1)
    for cid in elasticity:
        lat, mask = cs.elasticity_operator(cases[cid], dev)
        r = cs.lattice_rhs(lat, mask, rng, dev)
        built = {name: gmg_fused.build_fused_block_inner_cg(lat.gmg, 25, dev, **kw)
                 for name, kw in variants.items()}
        for name, fused in built.items():
            fused(r)
            c = fused._cuda
            print(f"{cid} {name}: {', '.join(f'{k} {c[k]}' for k in ('cluster', 'smem', 'lstar') if k in c)}",
                  flush=True)
        order = list(built) + list(built)[::-1]
        for turn, name in enumerate(order):
            fused = built[name]
            t = cs.median_ms(lambda: fused(r), calls=5, samples=5)
            key = f"gmg_fused_block_cg {cid} {name} #{1 if turn < len(built) else 2}"
            ms[key] = t
            print(f"{key}: {t:.4f} ms", flush=True)


STENCIL_CASES = (
    # chip_smoke.py's scalar lattices, 2-D and 3-D
    "poisson_basic", "poisson_p3_variable_kappa_mild", "helmholtz_basic_k5",
    "helmholtz_k12_exponential_mode", "poisson_3d_smooth_trig", "poisson_3d_kappa_expr",
    "helmholtz_3d_k1_trig", "helmholtz_3d_k1_trig@12",
)


def stencil_times(cs, cases, dev, rng, ms, device_us) -> None:
    """Every lattice apply of chip_smoke.py's paths as its caller makes it
    (module docstring), f64 then f32."""
    from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem

    cases = dict(cases, **cs.load_cases(set(STENCIL_CASES)))

    def time_apply(key, apply, W, u):
        ms[key] = cs.median_ms(lambda: apply(W, u), calls=20, samples=5)
        device_us[key] = profiled_us(lambda: apply(W, u))
        print(f"{key}: {ms[key]:.4f} ms a call (events), {device_us[key]:.3f} us device time",
              flush=True)

    for cid in STENCIL_CASES:
        make = cs.poisson_operator if cid.startswith("poisson") else cs.helmholtz_operator
        lat = make(cases[cid], dev)[0]
        shape = "x".join(map(str, lat.shape))
        for W in (lat.W_f64, lat.W):
            u = torch.as_tensor(rng.standard_normal(lat.shape), device=dev).to(W.dtype)
            time_apply(f"apply_grid_w {cid} {shape} K={len(lat.offsets)} {str(W.dtype)[6:]}",
                       lat.apply_grid_w, W, u)
    blocks = {cid: cs.elasticity_operator(cases[cid], dev)[0]
              for cid in ("linear_elasticity_nu010", "linear_elasticity_nu030")}
    for cid, lat in blocks.items():
        for W in (lat.W_f64, lat.W):
            u = torch.as_tensor(rng.standard_normal(lat.grid_shape), device=dev).to(W.dtype)
            time_apply(f"block apply_grid_w {cid} {'x'.join(map(str, lat.shape))} "
                       f"{str(W.dtype)[6:]}", lat.apply_grid_w, W, u)
    prob = NavierStokesProblem(cases["navier_stokes_basic"], dev)
    wm = prob.sst.wmapA
    W64 = wm.weights(prob.jacobian(prob.stokes_direct(prob.nu), prob.nu))
    for W in (W64, W64.float()):
        u = torch.as_tensor(rng.standard_normal(wm.shape + (2,)), device=dev).to(W.dtype)
        time_apply(f"weight map apply_grid navier_stokes_basic {'x'.join(map(str, wm.shape))} "
                   f"{str(W.dtype)[6:]}", wm.apply_grid, W, u)


WEIGHT_CASES = ("burgers_square_v1", "reaction_diffusion_allen_cahn_p2")


def weight_times(cs, dev, ms, device_us) -> None:
    """The per-step weight build at the main path's shapes (module
    docstring)."""
    cases = cs.load_cases(set(WEIGHT_CASES))
    for cid in WEIGHT_CASES:
        wm, bwm, P, _, u_lat = cs.step_weight_operator(cases[cid], dev)
        key = f"weights_w {cid} {'x'.join(map(str, wm.shape))}"
        ms[key] = cs.median_ms(lambda: bwm.weights_w(P, u_lat), calls=20, samples=5)
        device_us[key] = profiled_us(lambda: bwm.weights_w(P, u_lat))
        print(f"{key}: {ms[key]:.4f} ms a build (events), {device_us[key]:.2f} us device time, "
              f"P {P.P.numel() * P.P.element_size() / 1e6:.1f} MB {str(P.P.dtype)[6:]}", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose package and chip_smoke.py run")
    ap.add_argument("--3d", dest="three_d", action="store_true", help="time the 3-D cases too")
    ap.add_argument("--stencil", action="store_true",
                    help="time only the lattice applies (events and device time)")
    ap.add_argument("--weights", action="store_true",
                    help="time only the per-step weight build (events and device time)")
    ap.add_argument("--block-variants", action="store_true",
                    help="time only kernel #4, in its variants, in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem
    from pdebench_tpu_torch.solvers import dispatch, gmg_fused

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    poisson = ["poisson_basic", "poisson_p3_variable_kappa_mild"]
    helmholtz = ["helmholtz_basic_k5", "helmholtz_k12_exponential_mode"]
    elasticity = ["linear_elasticity_nu010", "linear_elasticity_nu030"]
    if args.three_d:
        with open(os.path.join(root, "data", "benchmark_v2.jsonl")) as fh:
            for line in fh:
                c = json.loads(line)
                oc = c["oracle_config"]
                if oc["domain"]["type"] == "unit_cube":
                    {"poisson": poisson, "helmholtz": helmholtz}.get(oc["pde"]["type"], []).append(c["id"])
        helmholtz.append("helmholtz_3d_k1_trig@12")
    cases = cs.load_cases(set(poisson + helmholtz + elasticity + ["navier_stokes_basic"]))
    rng = np.random.default_rng(0)
    ms, device_us = {}, {}
    if args.block_variants:
        block_variants(cs, gmg_fused, cases, elasticity, dev, rng, ms)
        print(json.dumps({"root": args.root, "ms": ms}), flush=True)
        return 0
    if args.weights:
        weight_times(cs, dev, ms, device_us)
        print(json.dumps({"root": args.root, "ms": ms, "device_us": device_us}), flush=True)
        return 0
    if args.stencil:
        stencil_times(cs, cases, dev, rng, ms, device_us)
        print(json.dumps({"root": args.root, "ms": ms, "device_us": device_us}), flush=True)
        return 0

    def time_it(key, fn, calls=5):
        ms[key] = cs.median_ms(fn, calls=calls, samples=5)
        print(f"{key}: {ms[key]:.4f} ms", flush=True)

    for cid in poisson:
        lat, mask = cs.poisson_operator(cases[cid], dev)
        r = cs.lattice_rhs(lat, mask, rng, dev)
        fused = gmg_fused.build_fused_inner_cg(lat.gmg, 25, dev)
        if fused is None:
            print(f"{cid}: {lat.shape} lattice, padded hierarchy: not kernel #2's route", flush=True)
            continue
        shape = "x".join(map(str, lat.shape))
        time_it(f"gmg_fused_cg {cid} {shape}", lambda: fused(r))
    for cid in helmholtz:
        lat, mask, W32c = cs.helmholtz_operator(cases[cid], dev)
        sites = int(np.prod(lat.shape))
        fg = gmg_fused.build_fused_inner_gmres(lat.gmg, 30, dev, lat.offsets)
        r = cs.lattice_rhs(lat, mask, rng, dev)
        if cid.endswith("@12"):
            rich = gmg_fused.build_fused_richardson(lat.gmg, 2, dev)
            time_it(f"gmg_fused_richardson {cid}", lambda: rich(r))
            continue
        if len(lat.shape) == 3 and (fg is None or sites < dispatch.FUSED_ARNOLDI_MIN_DOFS):
            print(f"{cid}: {lat.shape} lattice, not kernel #6's route", flush=True)
            continue
        rich = gmg_fused.build_fused_richardson(lat.gmg, 2, dev)
        time_it(f"gmg_fused_richardson {cid}", lambda: rich(r))
        shape = "x".join(map(str, lat.shape))
        time_it(f"gmg_fused_gmres {cid} {shape}", lambda: fg.raw(r, W32c))
    for cid in elasticity:
        lat, mask = cs.elasticity_operator(cases[cid], dev)
        r = cs.lattice_rhs(lat, mask, rng, dev)
        block = gmg_fused.build_fused_block_inner_cg(lat.gmg, 25, dev)
        time_it(f"gmg_fused_block_cg {cid}", lambda: block(r))
    prob = NavierStokesProblem(cases["navier_stokes_basic"], dev)
    x1 = prob.stokes_direct(prob.nu)
    lv = prob.levels(prob.sst.wmapA.weights(prob.jacobian(x1, prob.nu)).float())
    for cycles in (1, 2):
        dyn = gmg_fused.build_fused_dyn_block_vcycle(prob.spec, cycles, dev)
        r = torch.as_tensor(rng.standard_normal(2 * dyn.sites), dtype=torch.float32, device=dev)
        time_it(f"gmg_fused_dyn_block_vcycle navier_stokes_basic {cycles} cycle(s)",
                lambda: dyn(r, lv), calls=20)
    print(json.dumps({"root": args.root, "ms": ms, "device_us": device_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
