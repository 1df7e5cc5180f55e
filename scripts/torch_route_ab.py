"""Warm linear solve of dataset cases on the fused-kernel route and on the
port's PyTorch V-cycle route, on a CUDA card.

    python3 scripts/torch_route_ab.py [case_id ...]

Default cases: poisson_3d_smooth_trig and helmholtz_3d_k1_trig. For each
case, one OracleSolver(device="cuda") solve whose linear solve is captured
(operator, right-hand side, mask, boundary values, the f32 lattice with its
hierarchy). `dispatch.solve_constrained_ir` then solves that system in
turns, fused route then PyTorch route, ROUNDS times each, after one
warm-up call per route. The PyTorch route is what dispatch gives a
hierarchy outside the fused kernels' scope (`LatticeGMG.precond` in
PyTorch ops: `stencil-cg` for SPD systems, `gmres+vcycle` otherwise); it
is reached by making `dispatch.fused_gate` fail for those calls, in this
process only. Each call is timed on the host clock around work that ends
in torch.cuda.synchronize(). Prints the card's name and power limit, then
per case and route the inner name, outer rounds, final residual, the
median and range of the times, and the largest difference between the two
routes' solutions relative to the solution's size.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ("poisson_3d_smooth_trig", "helmholtz_3d_k1_trig")
ROUNDS = 5


def capture_linear_solve(config):
    """The arguments of the oracle's linear solve of `config`."""
    from pdebench_tpu_torch.oracle import OracleSolver, base

    module = importlib.import_module(f"pdebench_tpu_torch.oracle.{config['pde']['type']}")
    inner = module.solve_linear
    seen = []

    def capturing(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    module.solve_linear = capturing
    try:
        base.clear_setup_caches()
        OracleSolver(device="cuda").solve(config)
    finally:
        module.solve_linear = inner
    return seen[-1]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_route_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch.solvers import dispatch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    ids = argv or list(DEFAULT)
    configs = {}
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] in ids:
                configs[c["id"]] = c["oracle_config"]
    fused_gate = dispatch.fused_gate
    for cid in ids:
        (op, b, mask, g, opts), kwargs = capture_linear_solve(configs[cid])
        lat = opts["_lattice32"]
        inner = "cg" if kwargs.get("symmetric", True) else "gmres"
        steps = 25 if inner == "cg" else 30

        def solve(route):
            dispatch.fused_gate = fused_gate if route == "fused" else (lambda lattice32: False)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, iters, res, conv, name = dispatch.solve_constrained_ir(
                    op, b, mask, g, lat, float(opts.get("rtol", 1e-10)),
                    float(opts.get("atol", 1e-14)), inner=inner, inner_iters=steps,
                    max_outer=dispatch.MAX_OUTER,
                )
                torch.cuda.synchronize()
                return time.perf_counter() - t0, x, iters, res, conv, name
            finally:
                dispatch.fused_gate = fused_gate

        times = {"fused": [], "pytorch": []}
        last = {}
        for route in times:  # warm-up: hierarchy kernels built, caches filled
            solve(route)
        for i in range(ROUNDS):
            for route in (("fused", "pytorch") if i % 2 == 0 else ("pytorch", "fused")):
                t, x, iters, res, conv, name = solve(route)
                times[route].append(t)
                last[route] = (x, iters, res, conv, name)
        xf, xp = last["fused"][0], last["pytorch"][0]
        gap = float((xf - xp).abs().max() / xf.abs().max())
        for route, ts in times.items():
            x, iters, res, conv, name = last[route]
            print(f"{cid} ({op.ndof} dofs) {route}: inner {name}, outer {iters // steps}, residual "
                  f"{res:.3e}, converged {conv}; warm solve median {statistics.median(ts) * 1e3:.3f} "
                  f"ms ({min(ts) * 1e3:.3f}-{max(ts) * 1e3:.3f}) over {len(ts)}", flush=True)
        print(f"{cid}: PyTorch route / fused route {statistics.median(times['pytorch']) / statistics.median(times['fused']):.2f}x; "
              f"solutions differ by {gap:.2e} of max |x|", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
