#!/usr/bin/env python
"""Oracle validation sweep on pdebench_tpu_torch: run every case's oracle
and assert the reference grid is usable.

The twin of scripts/test_oracle_cases.py on the PyTorch port (imports no
jax): cases come from torch_run_benchmark's find_data_file /
load_benchmark_cases, and every oracle runs on --device ("cuda" unless
asked: "cpu", ...) with --solver-library "torch" (the default), "python"
(the same in-process port) or "cpp" (the native backend).

Behavioral parity (reference: scripts/test_oracle_cases.py:52-140): for
each selected case, the oracle must return a non-None, non-empty,
shape-correct grid with no +/-Inf, NaN allowed only as a domain mask
(at least one finite in-domain value required). This is the top-level
oracle regression harness; run it after solver changes.

Usage:
  python scripts/torch_test_oracle_cases.py --equation-types poisson --limit 5
  python scripts/torch_test_oracle_cases.py --cases heat_basic wave_lshape_v1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))
sys.path.insert(0, str(REPO_ROOT / "scripts"))

from pdebench_tpu_torch.oracle import OracleSolver  # noqa: E402
from torch_run_benchmark import (  # noqa: E402
    SOLVER_LIBRARIES,
    find_data_file,
    load_benchmark_cases,
)


def test_oracle_case(case, solver_library="torch", device="cuda"):
    """Returns (ok, message, elapsed, info)."""
    t0 = time.time()
    try:
        r = OracleSolver(device=device).solve(case["oracle_config"], solver_library)
    except Exception as e:
        return False, f"{type(e).__name__}: {e}", time.time() - t0, {}
    elapsed = time.time() - t0
    grid = np.asarray(r.reference) if r.reference is not None else None
    if grid is None or grid.size == 0:
        return False, "empty reference grid", elapsed, {}
    g = case["oracle_config"]["output"]["grid"]
    expected = (
        (int(g["nz"]), int(g["ny"]), int(g["nx"]))
        if g.get("nz")
        else (int(g["ny"]), int(g["nx"]))
    )
    if tuple(grid.shape) != expected:
        return False, f"shape {grid.shape} != {expected}", elapsed, {}
    if np.isinf(grid).any():
        return False, "Inf values in reference", elapsed, {}
    finite = np.isfinite(grid)
    if not finite.any():
        return False, "all-NaN reference", elapsed, {}
    info = {
        "baseline_error": r.baseline_error,
        "baseline_time": r.baseline_time,
        "num_dofs": r.num_dofs,
        "nan_fraction": float(1.0 - finite.mean()),
    }
    return True, "ok", elapsed, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--version", default="v2", choices=["v1", "v2"])
    ap.add_argument("--data", default=None)
    ap.add_argument("--cases", nargs="+", default=None)
    ap.add_argument("--equation-types", nargs="+", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--solver-library", default="torch", choices=SOLVER_LIBRARIES)
    ap.add_argument("--device", default="cuda", help="where the oracles run (cuda, cpu, ...)")
    ap.add_argument("--report", default=None, help="write JSON report here")
    ap.add_argument("--start", type=int, default=0, help="skip first N cases")
    ap.add_argument(
        "--order-file",
        default=None,
        help="file with one case_id per line; run cases in that order "
        "(ids not listed keep dataset order at the end) — used to put "
        "cheap cases first so a bounded sweep maximizes coverage",
    )
    ap.add_argument(
        "--resume-jsonl",
        default=None,
        help="append one JSON line per case here; cases already present "
        "(by case_id) are skipped, so a killed sweep resumes where it left",
    )
    args = ap.parse_args(argv)

    data_file = find_data_file(args.version, args.data)
    cases = load_benchmark_cases(data_file, args.cases, args.equation_types)
    cases = cases[args.start :]
    if args.limit:
        cases = cases[: args.limit]
    if args.order_file:
        order = [
            l.strip() for l in open(args.order_file) if l.strip()
        ]
        rank = {cid: i for i, cid in enumerate(order)}
        cases.sort(key=lambda c: rank.get(c["id"], len(rank)))

    done = set()
    if args.resume_jsonl and Path(args.resume_jsonl).exists():
        for line in open(args.resume_jsonl):
            try:
                done.add(json.loads(line)["case_id"])
            except (ValueError, KeyError):
                pass
        cases = [c for c in cases if c["id"] not in done]
        print(f"resume: {len(done)} cases already recorded")
    print(f"validating oracle on {len(cases)} cases")

    report = []
    n_ok = 0
    for i, case in enumerate(cases):
        ok, msg, elapsed, info = test_oracle_case(case, args.solver_library, args.device)
        n_ok += ok
        status = "OK " if ok else "FAIL"
        extra = (
            f"err={info.get('baseline_error'):.2e} t={info.get('baseline_time'):.2f}s"
            if ok
            else msg[:120]
        )
        print(
            f"[{i + 1}/{len(cases)}] {status} {case['id']:48s} "
            f"({elapsed:.1f}s) {extra}",
            flush=True,
        )
        rec = {"case_id": case["id"], "ok": ok, "message": msg,
               "elapsed": elapsed, **info}
        report.append(rec)
        if args.resume_jsonl:
            with open(args.resume_jsonl, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"\n{n_ok}/{len(cases)} oracles valid")
    if args.report:
        json.dump(report, open(args.report, "w"), indent=1)
    return 0 if n_ok == len(cases) else 1


if __name__ == "__main__":
    sys.exit(main())
