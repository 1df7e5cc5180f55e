"""Profile one warm solve of pdebench_tpu_torch on a CUDA card.

    python3 scripts/torch_profile_solve.py [--root DIR] [--solves N] [case_id ...]

A case id "<case>@<n>" is the dataset case at mesh resolution n
(chip_smoke.py's helmholtz_3d_k1_trig@12).

For each dataset case (default: the eleven dataset cases of chip_smoke.py's
main paths, Poisson, Helmholtz and elasticity in 2-D, Poisson and Helmholtz
in 3-D, Navier-Stokes): one OracleSolver(device="cuda") solve to
build the kernels and warm every cache, then a second solve whose warm
linear solve (the oracle's second `solve_linear` call, the one
`t_warm` times; for Navier-Stokes its second `NavierStokesProblem.run`,
the whole warm Newton solve; for heat, transient convection-diffusion,
linear reaction-diffusion, Burgers and wave the second `heat.step_loop`, the
warm run's whole step loop; for nonlinear reaction-diffusion the second
`reaction_diffusion.newton_steps`; for Stokes the second
`StokesProblem.run`, the warm MINRES-IR) runs under
torch.profiler. Prints per case the wall time of
that call, the device busy time (the union of the device activity
intervals the profiler recorded), the idle share 1 - busy / wall, and the
kernels by device time; first the card's name and power limit. Exits
non-zero when the profiler recorded no device activity.

--root DIR imports `pdebench_tpu_torch` from the checkout at DIR (default:
this script's own), so two checkouts run in one call, in turns (parent,
change, change, parent), compare on one card. --solves N (default 0)
first runs N whole-case solves, setup caches cleared before each, as
chip_smoke.py's phases 4-7 do, and prints each one's baseline_time,
t_setup, t_warm and t_cold, and the seconds of its cold run spent
building the fused kernels' objects (`gmg_fused.build_fused_*`) and in
their device setup (`_setup_cuda`: descriptor, cluster configuration),
then the medians.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = (
    "poisson_basic", "poisson_p3_variable_kappa_mild",
    "helmholtz_basic_k5", "helmholtz_k12_exponential_mode",
    "linear_elasticity_nu010", "linear_elasticity_nu030",
    "poisson_3d_smooth_trig", "poisson_3d_kappa_expr", "helmholtz_3d_k1_trig",
    "navier_stokes_low_re", "navier_stokes_basic",
)


def busy_seconds(prof) -> float:
    """Union of the device activity intervals in the trace, in seconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6  # the profiler's times are in microseconds


def profile_case(config, owner, attr):
    """(wall s, busy s, profiler) of the warm call of owner.attr (the
    oracle's linear solve, or the Navier-Stokes Newton run) in one solve."""
    from pdebench_tpu_torch.oracle import OracleSolver, base

    solver = OracleSolver(device="cuda")
    base.clear_setup_caches()
    solver.solve(config)  # builds the kernels, warms the caches
    inner = getattr(owner, attr)
    calls, out = [], {}

    def wrapped(*args, **kwargs):
        calls.append(1)
        if len(calls) != 2:  # the oracle's cold run
            return inner(*args, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = inner(*args, **kwargs)
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
        out["prof"] = prof
        out["info"] = result[1]
        return result

    setattr(owner, attr, wrapped)
    try:
        base.clear_setup_caches()
        solver.solve(config)
    finally:
        setattr(owner, attr, inner)
    return out


class SetupClock:
    """Seconds spent in gmg_fused's kernel builders and in its classes'
    `_setup_cuda` while active (nested calls counted once)."""

    def __init__(self, gmg_fused):
        self.seconds = {"build": 0.0, "setup_cuda": 0.0}
        self._depth = {"build": 0, "setup_cuda": 0}
        self._undo = []
        for name in dir(gmg_fused):
            obj = getattr(gmg_fused, name)
            if name.startswith("build_fused_") and callable(obj):
                self._wrap(gmg_fused, name, "build")
            elif isinstance(obj, type) and "_setup_cuda" in vars(obj):
                self._wrap(obj, "_setup_cuda", "setup_cuda")

    def _wrap(self, owner, attr, key):
        inner = getattr(owner, attr)

        def timed(*args, **kwargs):
            self._depth[key] += 1
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self._depth[key] -= 1
                if self._depth[key] == 0:
                    self.seconds[key] += time.perf_counter() - t0

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, inner))

    def close(self):
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)


def timed_solves(config, n: int, cid: str) -> None:
    """n whole-case solves, setup caches cleared before each: their
    baseline_time, t_setup, t_warm, t_cold and kernel-setup seconds."""
    from pdebench_tpu_torch.oracle import OracleSolver, base
    from pdebench_tpu_torch.solvers import gmg_fused

    solver = OracleSolver(device="cuda")
    rows = []
    for i in range(n):
        base.clear_setup_caches()
        clock = SetupClock(gmg_fused)
        try:
            res = solver.solve(config)
        finally:
            clock.close()
        info = res.solver_info
        row = dict(baseline_time=res.baseline_time, t_setup=info["t_setup"],
                   t_warm=info["t_warm"], t_cold=info["t_cold"], **clock.seconds)
        rows.append(row)
        print(f"{cid} solve {i + 1}: " + ", ".join(f"{k} {v:.4f} s" for k, v in row.items()),
              flush=True)
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(f"{cid} median of {n}: " + ", ".join(f"{k} {v:.4f} s" for k, v in med.items()),
          flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose package runs")
    ap.add_argument("--solves", type=int, default=0,
                    help="timed whole-case solves before the profiled one")
    ap.add_argument("cases", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_solve: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import importlib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"root {root}", flush=True)
    ids = args.cases or list(DEFAULT)
    configs = {}
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            for cid in ids:
                name, _, res = cid.partition("@")
                if c["id"] == name:
                    configs[cid] = json.loads(line)["oracle_config"]  # its own copy
                    if res:
                        configs[cid]["mesh"] = dict(configs[cid]["mesh"], resolution=int(res))
    ok = True
    for cid in ids:
        pde = configs[cid]["pde"]["type"]
        module = importlib.import_module(f"pdebench_tpu_torch.oracle.{pde}")
        if args.solves > 0:
            timed_solves(configs[cid], args.solves, cid)
        if pde == "navier_stokes":
            # the whole warm Newton solve (its method on the class: the
            # wrapper gets the problem as its first argument)
            out = profile_case(configs[cid], module.NavierStokesProblem, "run")
            what = "Newton run"
        elif pde == "stokes":
            # the whole warm solve: the MINRES-IR (or the host LU) and the
            # grid sampling
            out = profile_case(configs[cid], module.StokesProblem, "run")
            what = "Stokes run"
        elif pde == "reaction_diffusion" and module.reaction_expr(
                configs[cid]["pde"]["pde_params"].get("reaction", {}))[1]:
            # the whole warm Newton step loop
            out = profile_case(configs[cid], module, "newton_steps")
            what = "Newton step loop"
        elif pde in ("heat", "reaction_diffusion", "burgers", "wave") or (
                pde == "convection_diffusion" and configs[cid]["pde"].get("time")):
            heat = importlib.import_module("pdebench_tpu_torch.oracle.heat")
            out = profile_case(configs[cid], heat, "step_loop")
            what = "step loop"
        else:
            # the oracles that call dispatch.solve_linear through the
            # dispatch module (steady convection-diffusion) are profiled there
            owner = module if hasattr(module, "solve_linear") else importlib.import_module(
                "pdebench_tpu_torch.solvers.dispatch")
            out = profile_case(configs[cid], owner, "solve_linear")
            what = "solve_linear"
        busy = busy_seconds(out["prof"])
        info = out["info"]
        print(f"{cid}: profiled warm {what} {out['wall'] * 1e3:.3f} ms wall, device busy "
              f"{busy * 1e3:.3f} ms, idle share {1.0 - busy / out['wall']:.3f}; inner "
              f"{info.get('inner')}, iterations {info.get('iterations')}, Krylov iterations "
              f"{info.get('kry_its')}"
              + (f", restarts {info['restarts']}" if "restarts" in info else "")
              + (f", outer rounds per step {info['outer_rounds']}" if "outer_rounds" in info else "")
              + (f", Newton iterations per step {info['newton_iterations']}"
                 if "newton_iterations" in info else ""),
              flush=True)
        print(out["prof"].key_averages().table(sort_by="self_device_time_total", row_limit=12),
              flush=True)
        ok = ok and busy > 0.0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
