"""Navier-Stokes solves on the whole-device Newton route and on the host-LU
Newton route, in turns, on one CUDA card.

    python3 scripts/torch_ns_routes.py [case_id ...]

Default cases: navier_stokes_low_re and navier_stokes_basic. For each
case, ROUNDS solves per route in the order device, host-LU, host-LU,
device, ... (setup caches cleared before each), each through
`NavierStokesSolver(device="cuda")`: the device route is the default
(the device Newton, kernel #5 in its saddle preconditioner); the host-LU
route is the one a lattice without a saddle stencil takes (P3-P2, P4-P3),
reached here by replacing `navier_stokes.build_saddle_stencil` with one
that finds none: the reference's CPU default (residual and Jacobian on
the card, one host SuperLU factorisation per Newton step, frozen-Jacobian
steps).
Prints the card's name and power limit, then per solve the route, the
warm solve (`t_warm`, host clock around work that ends in
torch.cuda.synchronize()), `baseline_time`, the linear solves, the Krylov
iterations and `baseline_error`; per case and route the median and range
of the warm solves and the largest grid difference between the routes.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ("navier_stokes_low_re", "navier_stokes_basic")
ROUNDS = 3


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_ns_routes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch.oracle import base
    from pdebench_tpu_torch.oracle import navier_stokes as ns

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
    with_stencil = ns.build_saddle_stencil

    def no_stencil(*args, **kwargs):
        return None

    order = []
    for k in range(ROUNDS):
        order += ["device", "host-lu"] if k % 2 == 0 else ["host-lu", "device"]
    for cid in ids:
        warm, grids = {"device": [], "host-lu": []}, {}
        for route in order:
            base.clear_setup_caches()
            ns.build_saddle_stencil = with_stencil if route == "device" else no_stencil
            try:
                res = ns.NavierStokesSolver("cuda").solve(configs[cid])
            finally:
                ns.build_saddle_stencil = with_stencil
            info = res.solver_info
            if (info["inner"] == ns.ROUTE_HOST_LU) != (route == "host-lu"):
                raise RuntimeError(f"{cid}: route {info['inner']} on the {route} run")
            warm[route].append(info["t_warm"])
            grids[route] = res.reference
            print(f"{cid} {info['inner']}: warm solve {info['t_warm']:.4f} s, baseline_time "
                  f"{res.baseline_time:.4f} s, linear solves {info['iterations']}, Krylov "
                  f"iterations {info['kry_its']}, baseline_error {res.baseline_error!r}",
                  flush=True)
        for route, ts in warm.items():
            print(f"{cid} route {route}: warm solve median {statistics.median(ts):.4f} s "
                  f"({min(ts):.4f}-{max(ts):.4f}) over {len(ts)}", flush=True)
        diff = float(np.nanmax(np.abs(grids["device"] - grids["host-lu"])))
        print(f"{cid}: largest grid difference between the routes {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
