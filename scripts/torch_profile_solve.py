"""Profile one warm solve of pdebench_tpu_torch on a CUDA card.

    python3 scripts/torch_profile_solve.py [case_id ...]

For each dataset case (default: the eleven dataset cases of chip_smoke.py's
main paths, Poisson, Helmholtz and elasticity in 2-D, Poisson and Helmholtz
in 3-D, Navier-Stokes): one OracleSolver(device="cuda") solve to
build the kernels and warm every cache, then a second solve whose warm
linear solve (the oracle's second `solve_linear` call, the one
`t_warm` times; for Navier-Stokes its second `NavierStokesProblem.run`,
the whole warm Newton solve) runs under torch.profiler. Prints per case the wall time of
that call, the device busy time (the union of the device activity
intervals the profiler recorded), the idle share 1 - busy / wall, and the
kernels by device time; first the card's name and power limit. Exits
non-zero when the profiler recorded no device activity.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import json
import os
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_profile_solve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import importlib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ids = argv or list(DEFAULT)
    configs = {}
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] in ids:
                configs[c["id"]] = c["oracle_config"]
    ok = True
    for cid in ids:
        pde = configs[cid]["pde"]["type"]
        module = importlib.import_module(f"pdebench_tpu_torch.oracle.{pde}")
        if pde == "navier_stokes":
            # the whole warm Newton solve (its method on the class: the
            # wrapper gets the problem as its first argument)
            out = profile_case(configs[cid], module.NavierStokesProblem, "run")
        else:
            out = profile_case(configs[cid], module, "solve_linear")
        busy = busy_seconds(out["prof"])
        info = out["info"]
        what = "Newton run" if pde == "navier_stokes" else "solve_linear"
        print(f"{cid}: profiled warm {what} {out['wall'] * 1e3:.3f} ms wall, device busy "
              f"{busy * 1e3:.3f} ms, idle share {1.0 - busy / out['wall']:.3f}; inner "
              f"{info.get('inner')}, iterations {info.get('iterations')}, Krylov iterations "
              f"{info.get('kry_its')}", flush=True)
        print(out["prof"].key_averages().table(sort_by="self_device_time_total", row_limit=12),
              flush=True)
        ok = ok and busy > 0.0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
