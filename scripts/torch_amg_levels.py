"""The SA-AMG hierarchy that wave's step loop builds off the lattice, and
what its host setup spends.

    python3 scripts/torch_amg_levels.py wave_annulus_trig [case_id ...]

For each dataset wave case (off the lattice): its mesh, the step matrix A
= M / dt^2 + c^2 K / 4 that `wave.amg_step_preconditioner` coarsens, and
the hierarchy of its free dofs as `solvers/amg.py` builds it, timed: the
rows of every level, the rows of the coarsest (dense) level, the seconds
of the whole setup and of the coarsest level's pseudo-inverse within it.
Runs on the host (numpy / scipy; the levels are made on the CPU). The
signed-distance mesher follows the numpy / scipy versions, so run it on
the machine whose sweep it explains.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch.fem.assemble import LocalOperator, local_mass, local_stiffness
    from pdebench_tpu_torch.oracle import base, scalar, wave
    from pdebench_tpu_torch.solvers import amg

    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        configs = {c["id"]: c["oracle_config"] for c in map(json.loads, fh)}
    pinv = np.linalg.pinv
    spent = []

    def timed_pinv(a, *args, **kwargs):
        t0 = time.perf_counter()
        out = pinv(a, *args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out

    amg.np.linalg.pinv = timed_pinv
    try:
        for cid in args.cases:
            cfg = copy.deepcopy(configs[cid])
            pde = cfg["pde"]
            if pde["type"] != "wave":
                raise SystemExit(f"{cid}: not a wave case")
            mms_u = pde.get("manufactured_solution", {}).get("u")
            if mms_u is not None:
                cfg = scalar.override_bc_with_mms(cfg, mms_u)
            c = float(pde.get("pde_params", {}).get("c", 1.0))
            t0, _, dt, _ = base.time_params(pde)
            ctx = scalar.setup_scalar(cfg, "cpu", t0=t0)
            A = local_mass(ctx.cb) / (dt * dt) + wave.THETA * c * c * local_stiffness(ctx.cb)
            op = LocalOperator(torch.as_tensor(A), ctx.space.dofmap_scalar, ctx.space.ndof)
            spent.clear()
            t_start = time.perf_counter()
            hier, _ = amg._free_hierarchy(op.to_scipy(), ctx.mask.numpy(), None, 1, "cpu", {})
            total = time.perf_counter() - t_start
            print(f"{cid}: {ctx.space.ndof} dofs, c {c}, dt {dt}; levels (rows) "
                  f"{[lv.A.shape[0] for lv in hier.levels]}, coarsest {hier.coarse_inv.shape[0]} rows "
                  f"(dense); setup {total:.2f} s, of it the coarsest pseudo-inverse "
                  f"{sum(spent):.2f} s", flush=True)
    finally:
        amg.np.linalg.pinv = pinv
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
