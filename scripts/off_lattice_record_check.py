"""Why a case off the lattice differs from its record: what the JAX
package gives for it today, beside what pdebench_tpu_torch gives on the
CPU and, with --direct, the exact discrete solution.

    python3 scripts/off_lattice_record_check.py [--direct] case_id [case_id ...]

For each case, beside its record in results/oracle_sweep_progress.jsonl:
the JAX package's solve on the CPU on its own CPU route (one cold run),
pdebench_tpu_torch's solve on the CPU on its CPU route (the same gates),
each error's relative distance from the record, and the largest
difference of the two output grids over the grid's largest magnitude
(NaN outside the domain in both). With --direct, also pdebench_tpu_torch's
host SuperLU solve (ksp preonly, pc lu): the error of the exact discrete
solution, from which the distance of an iterative solve shows how far
its stop at rtol moves it. The card's error comes from
scripts/torch_sweep_cases.py.

Runs on the CPU only (it sets jax_platforms to cpu); imports both
packages. A case of a few hundred thousand dofs takes a minute or two
and a few GB.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    direct = "--direct" in argv
    argv = [a for a in argv if a != "--direct"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pdebench_tpu.oracle.base as ref_base
    from pdebench_tpu.oracle import OracleSolver as RefOracle
    from pdebench_tpu_torch.oracle import OracleSolver

    ref_base._COLD = True  # one run: the warm run repeats the same solve
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        cases = {c["id"]: c["oracle_config"] for c in map(json.loads, fh)}
    with open(os.path.join(ROOT, "results", "oracle_sweep_progress.jsonl")) as fh:
        records = {r["case_id"]: r.get("baseline_error") for r in map(json.loads, fh) if r.get("ok")}
    for cid in argv:
        rec = records[cid]
        off = lambda e: f"{abs(e - rec) / abs(rec):.2e}"
        t0 = time.perf_counter()
        ref = RefOracle().solve(copy.deepcopy(cases[cid]))
        t1 = time.perf_counter()
        port = OracleSolver(device="cpu").solve(copy.deepcopy(cases[cid]))
        t2 = time.perf_counter()
        a, b = np.asarray(ref.reference), np.asarray(port.reference)
        inside = np.isfinite(a) & np.isfinite(b)
        grid = float(np.abs(a[inside] - b[inside]).max() / np.abs(a[inside]).max())
        line = (f"{cid}: record {rec!r}; JAX package today {ref.baseline_error!r} ({off(ref.baseline_error)} "
                f"from the record; {ref.solver_info.get('method')}, pc "
                f"{ref.solver_info.get('pc_used')}, {t1 - t0:.1f} s); port {port.baseline_error!r} "
                f"({off(port.baseline_error)}; {port.solver_info.get('inner')}, {port.num_dofs} dofs, "
                f"{t2 - t1:.1f} s); grids {grid:.1e} apart, NaN alike "
                f"{bool((np.isnan(a) == np.isnan(b)).all())}")
        del ref, port, a, b
        gc.collect()
        if direct:
            cfg = copy.deepcopy(cases[cid])
            cfg["oracle_solver"] = dict(cfg.get("oracle_solver", {}), ksp_type="preonly", pc_type="lu")
            lu = OracleSolver(device="cpu").solve(cfg)
            line += f"; exact discrete (host LU) {lu.baseline_error!r} ({off(lu.baseline_error)})"
            del lu
            gc.collect()
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
