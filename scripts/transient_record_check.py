"""Why a transient no-exact case's recorded baseline_error differs from
today's oracle: solve it with the JAX package on the CPU twice, with the
reference re-solve as the package makes it now (dt / 2, or the `time` of
reference_config: commit 1101cb6) and with the re-solve at the case's
own dt (what the package did before that commit), beside the record in
results/oracle_sweep_progress.jsonl.

    python3 scripts/transient_record_check.py heat_no_exact [case_id ...]

Runs the JAX package on the CPU only (it sets jax_platforms to cpu).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(ids) -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pdebench_tpu.oracle.scalar as scalar
    from pdebench_tpu.oracle import OracleSolver

    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        cases = {c["id"]: c["oracle_config"] for c in map(json.loads, fh)}
    with open(os.path.join(ROOT, "results", "oracle_sweep_progress.jsonl")) as fh:
        records = {r["case_id"]: r.get("baseline_error") for r in map(json.loads, fh) if r.get("ok")}
    merge = scalar.merge_reference_config
    for cid in ids:
        t0 = time.perf_counter()
        now = OracleSolver().solve(copy.deepcopy(cases[cid])).baseline_error
        cfg = copy.deepcopy(cases[cid])
        cfg["reference_config"].pop("time", None)
        scalar.merge_reference_config = lambda c, refine_dt=None: merge(c)
        try:
            same_dt = OracleSolver().solve(cfg).baseline_error
        finally:
            scalar.merge_reference_config = merge
        print(f"{cid}: re-solve at dt / 2 (today) {now!r}; re-solve at the case's dt "
              f"{same_dt!r}; recorded {records.get(cid)!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
