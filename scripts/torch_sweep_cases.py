"""Solve dataset cases with pdebench_tpu_torch on a CUDA card and hold each
`baseline_error` against the recorded one.

    python3 scripts/torch_sweep_cases.py --pde helmholtz --domain unit_square
    python3 scripts/torch_sweep_cases.py --domain l_shape --domain t_junction
    python3 scripts/torch_sweep_cases.py --pde poisson --domain circle --domain periodic_square
    python3 scripts/torch_sweep_cases.py --case poisson_basic --case ...

For every case of `data/benchmark_v2.jsonl` whose pde type (any without
--pde) and domain (one of the --domain given) match (or every case named
with --case): one `OracleSolver(device="cuda")` solve
with the setup caches cleared, its `baseline_error` against the last
successful record of the case in `results/oracle_sweep_progress.jsonl`,
the inner route, the inner iterations (outer rounds times the route's
steps per round; for Navier-Stokes the Newton linear solves, and the
Krylov iterations beside them), the routes of all its linear solves (the
reference re-solve's included, with `rerouted` for a direct request sent
through the lattice IR, `fell through` for a lattice IR that did not
converge and whose solve the route off the lattice answered, and `failed`
for any other solve that did not converge; the
Navier-Stokes oracle has no `solve_linear`: its route is its solve's
`inner`), the warm solve and `baseline_time`. One line per case, then a summary: the
worst relative difference, the cases per inner route and their median warm
solve. A step loop off the lattice names its route by its inner
(`jacobi-cg-ir`, `amg-cg-ir`, `jacobi-gmres-ir`), a solve on the host LU
why it took it (`host LU: ...`: the CPU branch, or a no-exact wave case's
re-solve, whose route the case's line gives after `re-solve`). A case that raises, whose error is off by more than --tol, or any
of whose solves records an unconverged IR (`iterative_failed`) is counted
as failed, and the script then exits non-zero. A fall-through is counted
as failed too unless the case is one of EXPECTED_FALL_THROUGH, whose
lattice IR is known not to converge; the summary lists the cases that fell
through apart. A case that raises
NotImplementedError (a route that is not ported) is listed as raised, with
its reason and the kernel launches before the raise, and is not counted as
failed. First line: the card's name and power limit.

--rtol R solves every case at oracle_solver rtol R and atol 1e-16 instead
of its own (the record then is not the case's answer: a tight rtol shows
where a case's own stop leaves its error). --boundary-tol T sets the
point location's leniency for grid points just outside the mesh
(`fem.sampling._TOL_BOUNDARY`, 1e-6): 0 locates them as the records'
oracle did before the JAX package took that leniency, so that a record
written before it can be reproduced. --direct solves every case as a direct request (ksp preonly,
pc lu): the host LU off the lattice, the witness of what an iterative
route should converge to. --resolve-at-case-dt makes a transient no-exact
case's re-solve step at the case's own dt, its reference_config's `time`
dropped (the JAX package's re-solve before its commit 1101cb6, as
`transient_record_check.py`'s second solve; the record of a case written
before that commit then is the answer). --device cpu runs the plain
versions on the CPU instead of the card (no timing is meaningful there).
The route switches the oracle reads (PDEBENCH_TPU_FUSED=arnoldi,
PDEBENCH_TPU_STEP_RICH=1, PDEBENCH_TPU_STEP_OUTER=cell, ...) pass through
the environment, e.g.

    PDEBENCH_TPU_FUSED=arnoldi python3 scripts/torch_sweep_cases.py --pde convection_diffusion --domain unit_square

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cases whose lattice IR does not converge and whose solve the route
# off the lattice answers (the JAX package's fall-through): any other case
# that falls through is a failure, such as a kernel that stopped converging
EXPECTED_FALL_THROUGH = (
    "poisson_high_contrast_no_exact",
    "poisson_smooth_high_contrast_no_exact",
    "poisson_no_exact_low_background_kappa_constant_source",
    "linear_elasticity_no_exact_cantilever",
)


def recorded_errors():
    out = {}
    with open(os.path.join(ROOT, "results", "oracle_sweep_progress.jsonl")) as fh:
        for line in fh:
            r = json.loads(line)
            if r.get("ok") and r.get("baseline_error") is not None:
                out[r["case_id"]] = float(r["baseline_error"])
    return out


def record_routes(pde: str, seen: list) -> None:
    """Append the solver_info of every solve_linear call of the pde's
    oracle module to `seen`."""
    module = importlib.import_module(f"pdebench_tpu_torch.oracle.{pde}")
    if not hasattr(module, "solve_linear"):
        return
    inner = module.solve_linear

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out[1])
        return out

    module.solve_linear = recording


def fell_through(info) -> bool:
    """A lattice IR that did not converge, answered by the route off the
    lattice (SA-AMG or Jacobi Krylov) on the same device."""
    return "iterative_failed" in info and info.get("inner", "").startswith(("amg-", "jacobi-"))


def failed_solve(info) -> bool:
    return "iterative_failed" in info and not fell_through(info)


def route(info) -> str:
    flags = [f for f, on in (("rerouted", "direct_rerouted" in info),
                              ("fell through", fell_through(info)),
                              ("failed", failed_solve(info))) if on]
    return info.get("inner", "?") + (f" ({', '.join(flags)})" if flags else "")


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pde")
    ap.add_argument("--domain", action="append", default=[], help="a domain type (repeatable)")
    ap.add_argument("--case", action="append", default=[], help="a case id (repeatable)")
    ap.add_argument("--tol", type=float, default=1e-5, help="relative error tolerance")
    ap.add_argument("--rtol", type=float, help="solve at this rtol (atol 1e-16)")
    ap.add_argument("--boundary-tol", type=float, help="the point location's boundary leniency")
    ap.add_argument("--direct", action="store_true", help="solve as a direct request (host LU)")
    ap.add_argument("--resolve-at-case-dt", action="store_true",
                    help="a no-exact re-solve at the case's dt, reference_config's time dropped")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if not args.case and not args.domain:
        ap.error("give --domain (and --pde), or --case")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_sweep_cases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch.fem import sampling
    from pdebench_tpu_torch.oracle import OracleSolver, base
    from pdebench_tpu_torch.solvers import gmg_fused, stencil_kernel

    if args.boundary_tol is not None:
        sampling._TOL_BOUNDARY = args.boundary_tol
    if args.resolve_at_case_dt:
        from pdebench_tpu_torch.oracle import scalar

        merge = scalar.merge_reference_config
        scalar.merge_reference_config = lambda c, refine_dt=None: merge(c)

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0], flush=True)
    else:
        print("device cpu (the kernels' plain versions)", flush=True)
    recorded = recorded_errors()
    cases = []
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            oc = c["oracle_config"]
            if c["id"] in args.case or (
                args.pde in (None, oc["pde"]["type"]) and oc["domain"]["type"] in args.domain
            ):
                if args.rtol is not None:
                    oc["oracle_solver"] = dict(oc.get("oracle_solver", {}), rtol=args.rtol, atol=1e-16)
                if args.direct:
                    oc["oracle_solver"] = dict(oc.get("oracle_solver", {}), ksp_type="preonly",
                                               pc_type="lu")
                if args.resolve_at_case_dt:
                    oc.get("reference_config", {}).pop("time", None)
                cases.append((c["id"], oc))
    solver = OracleSolver(device=args.device)
    worst, failed, raised, fell = 0.0, [], [], []
    warm = defaultdict(list)
    seen, recording = [], set()
    for cid, oc in cases:
        if oc["pde"]["type"] not in recording:
            record_routes(oc["pde"]["type"], seen)
            recording.add(oc["pde"]["type"])
        seen.clear()
        base.clear_setup_caches()
        t0 = time.perf_counter()
        before = stencil_kernel.LAUNCHES, gmg_fused.LAUNCHES
        try:
            res = solver.solve(oc)
        except NotImplementedError as e:
            raised.append(cid)
            print(f"{cid}: RAISES NotImplementedError: {e}; kernel launches before it: #1 "
                  f"{stencil_kernel.LAUNCHES - before[0]}, #2 {gmg_fused.LAUNCHES - before[1]}; "
                  f"routes before it {[route(i) for i in seen]}", flush=True)
            continue
        except Exception as e:  # report every case, count the failure
            failed.append(cid)
            print(f"{cid}: FAILED {type(e).__name__}: {e}; routes before it "
                  f"{[route(i) for i in seen]}", flush=True)
            continue
        info = res.solver_info
        inner = info.get("inner")
        ref = recorded.get(cid)
        rel = abs(res.baseline_error - ref) / abs(ref) if ref else float("nan")
        if ref:
            worst = max(worst, rel)
        if any(fell_through(i) for i in seen + [info]):
            fell.append(cid)
        if ((ref and not rel <= args.tol) or any(failed_solve(i) for i in seen + [info])
                or (cid in fell and cid not in EXPECTED_FALL_THROUGH)):
            failed.append(cid)
        warm[inner].append(info["t_warm"])
        routes = []
        for r in map(route, seen):
            if r not in routes:
                routes.append(r)
        print(f"{cid}: dofs {res.num_dofs} baseline_error {res.baseline_error!r} recorded "
              f"{ref!r} rel {rel:.2e}; inner {inner} iterations {info.get('iterations')}"
              + (f" Krylov {info['kry_its']}" if "kry_its" in info else "")
              + (f" restarts {info['restarts']}" if "restarts" in info else "")
              + (f" host LU: {info['host_lu']}" if "host_lu" in info else "")
              + (f" AMG failed: {info['amg_failed']}" if "amg_failed" in info else "")
              + (f"; re-solve {info['reference_solve']}" if "reference_solve" in info else "")
              + "; "
              f"routes {routes}; warm "
              f"{info['t_warm']:.4f} s, baseline_time {res.baseline_time:.4f} s, whole call "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"{len(cases)} cases, worst relative error difference {worst:.3e} (tol "
          f"{args.tol:g}), {len(failed)} failed {failed}, {len(raised)} raised "
          f"NotImplementedError {raised}, {len(fell)} fell through {fell} (expected: "
          f"{[c for c in fell if c in EXPECTED_FALL_THROUGH]})", flush=True)
    for inner, ts in sorted(warm.items(), key=lambda kv: str(kv[0])):
        print(f"  {inner}: {len(ts)} cases, warm solve median {statistics.median(ts):.4f} s "
              f"({min(ts):.4f}-{max(ts):.4f})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
