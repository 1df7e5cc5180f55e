"""Dataset cases through dispatch's halo route on n ranks, against the
single-device solve, on the GPU machine.

    python3 scripts/torch_halo_ranks.py [--ranks 2 4] [--device cuda] [--dryrun] [case ...]

For each case (default: poisson_p2, linear_elasticity_exponential_gradients
and poisson_3d_smooth_trig, the reference's halo dataset cases, at full
size) and each rank count: one OracleSolver solve on every rank with
PDEBENCH_TPU_HALO=1 (parallel/dryrun.oracle_solve under parallel.launch),
printed beside the single-device solve in this process: pc_used, the
backend, CG iterations, the grid's distance from the single-device grid,
baseline_error, t_warm and rank 0's seconds in reductions and row
exchanges, each rank's stencil kernel launches. With a card for every rank
the ranks take NCCL; ranks sharing a card take gloo with pinned host
staging. --dryrun also runs dryrun_multichip on the largest rank count.
Each result is held by parallel/dryrun.check_halo_route, the check of
chip_smoke.py's phase 20b; exits non-zero when one fails. Imports no jax.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("poisson_p2", "linear_elasticity_exponential_gradients", "poisson_3d_smooth_trig")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", default=list(CASES))
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from pdebench_tpu_torch.oracle import OracleSolver
    from pdebench_tpu_torch.parallel import launch
    from pdebench_tpu_torch.parallel.dryrun import (
        check_halo_route, dryrun_multichip, grid_rel, load_case, oracle_solve,
    )

    if args.device.startswith("cuda"):
        from pdebench_tpu_torch import _build

        _build.load("stencil_apply")  # once here, not in every rank
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        print(f"{torch.cuda.device_count()} card(s): " + "; ".join(smi.strip().splitlines()), flush=True)
    failed = []
    for cid in args.cases:
        cfg = load_case(cid)["oracle_config"]
        single = OracleSolver(device=args.device).solve(copy.deepcopy(cfg))
        print(f"{cid} on one device: inner {single.solver_info['inner']}, baseline_error "
              f"{single.baseline_error!r}, t_warm {single.solver_info['t_warm']:.4f} s", flush=True)
        for ranks in args.ranks:
            t0 = time.perf_counter()
            got = launch(oracle_solve, ranks, args.device, copy.deepcopy(cfg))
            info = got["solver_info"]
            rel = grid_rel(got["grid"], single.reference)
            print(f"{cid} on {ranks} ranks: {info['pc_used']} ({info['halo_backend']}), "
                  f"{info['iterations']} CG iterations, grid {rel:.3e} from the single-device grid, "
                  f"baseline_error {got['baseline_error']!r}, t_warm {info['t_warm']:.4f} s, of it "
                  f"reductions {info['halo_reduce_s']:.4f} s and exchanges {info['halo_exchange_s']:.4f} s "
                  f"(rank 0), launches per rank {got['launches']}; {time.perf_counter() - t0:.1f} s "
                  f"with the ranks' start", flush=True)
            try:
                check_halo_route(cid, got, single.reference, ranks)
            except RuntimeError as e:
                failed.append(str(e))
    if args.dryrun:
        t0 = time.perf_counter()
        print(f"dryrun_multichip({max(args.ranks)}, {args.device!r}): "
              f"{dryrun_multichip(max(args.ranks), args.device)}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    if failed:
        print("FAILED: " + "; ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
