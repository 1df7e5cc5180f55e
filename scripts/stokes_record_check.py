"""Why a Stokes case's baseline_error differs from its record: where a
MINRES stopped at the case's rtol leaves it, against the exact discrete
solution.

    python3 scripts/stokes_record_check.py stokes_p3p2_taylor_hood [case_id ...]

For each case, beside its record in results/oracle_sweep_progress.jsonl:
the JAX package's solve on the CPU on its lattice-layout MINRES
(PDEBENCH_TPU_SADDLE_LAT=1, the route pdebench_tpu_torch takes on every
device; one cold run), and the error of the exact discrete solution,
from pdebench_tpu_torch on the CPU with its MINRES allowed no iteration
(stokes.MAXITER = 0), so that the solve takes the host SuperLU. Each
error's relative distance from the exact discrete one shows how far the
stop at rtol moves it; the card's error comes from
scripts/torch_sweep_cases.py.

Runs on the CPU only (it sets jax_platforms to cpu); imports both
packages.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.environ["PDEBENCH_TPU_SADDLE_LAT"] = "1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pdebench_tpu.oracle.base as ref_base
    from pdebench_tpu.oracle import OracleSolver as RefOracle
    from pdebench_tpu_torch.oracle import OracleSolver, stokes

    ref_base._COLD = True  # one run: the warm runs repeat the same solve
    stokes.MAXITER = 0
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        cases = {c["id"]: c["oracle_config"] for c in map(json.loads, fh)}
    with open(os.path.join(ROOT, "results", "oracle_sweep_progress.jsonl")) as fh:
        records = {r["case_id"]: r.get("baseline_error") for r in map(json.loads, fh) if r.get("ok")}
    for cid in argv:
        t0 = time.perf_counter()
        ref = RefOracle().solve(copy.deepcopy(cases[cid]))
        lu = OracleSolver(device="cpu").solve(copy.deepcopy(cases[cid]))
        if lu.solver_info["method"] != "lu":
            raise AssertionError(f"{cid}: expected the host LU, got {lu.solver_info}")
        exact, rec = lu.baseline_error, records.get(cid)
        off = lambda e: f"{abs(e - exact) / abs(exact):.1e}" if e is not None else "-"
        print(f"{cid}: reference today {ref.baseline_error!r} (method {ref.solver_info.get('method')}, "
              f"MINRES iterations {ref.solver_info.get('iterations')}, layout "
              f"{ref.solver_info.get('saddle_layout')}); exact discrete (host LU) {exact!r}; record "
              f"{rec!r}; relative to the exact discrete error: reference {off(ref.baseline_error)}, "
              f"record {off(rec)}; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
