"""Why a case's recorded baseline_error differs from today's oracle:
solve it with the JAX package on the CPU twice, as the package solves it
now and as it did when the record was written, beside the record in
results/oracle_sweep_progress.jsonl.

The default second solve is a transient no-exact case's with its
reference re-solve at the case's own dt (today's re-solve takes dt / 2, or
the `time` of reference_config: the package's commit 1101cb6; before it,
a reference_config's `time` was dropped). It serves every transient type
whose oracle re-solves through `scalar.merge_reference_config`: heat,
reaction-diffusion, convection-diffusion and wave.
--cell-outer makes it a solve whose per-step systems (Burgers) take the
package's exact cell-based f64 outer (PDEBENCH_TPU_STEP_OUTER=cell),
where today's outer applies the float32 step weights cast to f64.
--today skips the second solve: the package's answer today beside the
record, for any case (a steady one too). --rtol R solves at oracle_solver
rtol R and atol 1e-16 instead of the case's own. --resolution N solves
every case at mesh resolution N (a case cut to size, as chip_smoke.py's
"<case>@N" entries are; the record then belongs to another mesh).

    python3 scripts/transient_record_check.py heat_no_exact [case_id ...]
    python3 scripts/transient_record_check.py --pde reaction_diffusion --domain unit_square
    python3 scripts/transient_record_check.py --cell-outer --pde burgers --domain unit_square
    python3 scripts/transient_record_check.py --pde wave --domain l_shape
    python3 scripts/transient_record_check.py --today biharmonic_lshape_v2
    python3 scripts/transient_record_check.py --today --resolution 48 wave_multiconn_circ_trig

--pde and --domain take every case of that pde type and domain with no
manufactured solution and a reference_config (the 7 unit_square
reaction-diffusion ones, the 15 heat ones, ...), with --cell-outer every
case of them, after the ids given.

Runs the JAX package on the CPU only (it sets jax_platforms to cpu).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ids", nargs="*")
    ap.add_argument("--pde")
    ap.add_argument("--domain")
    ap.add_argument("--cell-outer", action="store_true",
                    help="the second solve with the exact cell-based f64 outer")
    ap.add_argument("--today", action="store_true", help="no second solve")
    ap.add_argument("--rtol", type=float, help="solve at this rtol (atol 1e-16)")
    ap.add_argument("--resolution", type=int, help="solve at this mesh resolution")
    args = ap.parse_args(argv)
    if bool(args.pde) != bool(args.domain) or not (args.ids or args.pde):
        ap.error("give case ids, or --pde and --domain")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pdebench_tpu.oracle.scalar as scalar
    from pdebench_tpu.oracle import OracleSolver

    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        cases = {c["id"]: c["oracle_config"] for c in map(json.loads, fh)}
    if args.rtol is not None:
        for oc in cases.values():
            oc["oracle_solver"] = dict(oc.get("oracle_solver", {}), rtol=args.rtol, atol=1e-16)
    if args.resolution is not None:
        for oc in cases.values():
            oc["mesh"] = dict(oc.get("mesh", {}), resolution=args.resolution)
    with open(os.path.join(ROOT, "results", "oracle_sweep_progress.jsonl")) as fh:
        records = {r["case_id"]: r.get("baseline_error") for r in map(json.loads, fh) if r.get("ok")}
    ids = list(args.ids)
    if args.pde:
        ids += [
            cid for cid, oc in cases.items()
            if oc["pde"]["type"] == args.pde and oc["domain"]["type"] == args.domain
            and (args.cell_outer or args.today or (
                not oc["pde"].get("manufactured_solution") and "reference_config" in oc))
            and cid not in ids
        ]
    merge = scalar.merge_reference_config
    for cid in ids:
        t0 = time.perf_counter()
        now = OracleSolver().solve(copy.deepcopy(cases[cid])).baseline_error
        cfg = copy.deepcopy(cases[cid])
        if args.today:
            print(f"{cid}: today {now!r}; recorded {records.get(cid)!r} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        if args.cell_outer:
            os.environ["PDEBENCH_TPU_STEP_OUTER"] = "cell"
            try:
                then = OracleSolver().solve(cfg).baseline_error
            finally:
                del os.environ["PDEBENCH_TPU_STEP_OUTER"]
            what = "today (the float32 step weights cast to f64 in the outer)", "cell-based f64 outer"
        else:
            cfg["reference_config"].pop("time", None)
            scalar.merge_reference_config = lambda c, refine_dt=None: merge(c)
            try:
                then = OracleSolver().solve(cfg).baseline_error
            finally:
                scalar.merge_reference_config = merge
            what = "re-solve at dt / 2 (today)", "re-solve at the case's dt"
        print(f"{cid}: {what[0]} {now!r}; {what[1]} {then!r}; recorded {records.get(cid)!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
