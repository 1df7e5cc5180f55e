#!/usr/bin/env python
"""PDEAgent benchmark driver on pdebench_tpu_torch: oracle -> prompt ->
agent -> sandbox -> gate -> aggregate.

The twin of scripts/run_benchmark.py (the JAX package's driver), on the
PyTorch port: it imports torch and pdebench_tpu_torch, never jax or
pdebench_tpu. The oracle runs on --device ("cuda" unless asked: "cpu",
"cuda:1", ...), and so does the agent's solver (the sandbox names the
device to it in PDEBENCH_TORCH_DEVICE). --solver-library is "torch" (the
port, the default), "python" (numpy/scipy agents; the oracle is the port)
or "cpp" (the native oracle and C++ agents). The oracle cache is
<results-dir>/.torch_oracle_cache/<library>/<device>, a path the JAX
driver never writes. Everything else is the JAX driver's:

Behavioral parity with the reference driver
(reference: scripts/run_benchmark.py:113-2094):
  - oracle results cached per case as <case_id>.json with NaN -> null
    JSON encoding (:162-205)
  - accuracy-first gating: error <= max(oracle_error * accuracy_tolerance,
    MIN_ERROR_THRESHOLD), then time <= oracle_time * time_tolerance
    (:500-521, MIN_ERROR_THRESHOLD = 1e-6)
  - NaN-masked rel-L2 with strict shape match (:291-345)
  - multi-attempt loop with feedback prompts, per-attempt gate
    transitions and best-attempt selection (:651-675, :873-1392)
  - per-case incremental result.json; per-agent summary.json; global
    all_results.json (:593-595, :1536-1546)
  - summary with per-equation-type / per-math-type breakdowns, gate
    statistics, LLM cost accounting, multi-attempt analytics (:1554-1929)

Usage:
  python scripts/torch_run_benchmark.py --agents mock --cases poisson_basic
  python scripts/torch_run_benchmark.py --agents mock --cases poisson_basic --device cpu
  python scripts/torch_run_benchmark.py --agents gpt-4o --equation-types poisson heat \
      --max-attempts 3 --solver-library torch
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from pdebench_tpu_torch.analysis import ErrorClassifier, GateAnalyzer  # noqa: E402
from pdebench_tpu_torch.analysis.gate_analyzer import GateBreakdown  # noqa: E402
from pdebench_tpu_torch.agents import AgentRegistry, get_agent  # noqa: E402
from pdebench_tpu_torch.core import (  # noqa: E402
    call_llm,
    create_feedback_prompt,
    generate_prompt,
)
from pdebench_tpu_torch.core.llm_client import SUPPORTED_AGENTS, LLMError  # noqa: E402
from pdebench_tpu_torch.metrics import (  # noqa: E402
    compute_universal_metrics,
    get_specialized_metrics_computer,
)
from pdebench_tpu_torch.oracle import OracleSolver  # noqa: E402
from pdebench_tpu_torch.sandbox import CppExecutor, execute_agent_function  # noqa: E402

MIN_ERROR_THRESHOLD = 1e-6

SOLVER_LIBRARIES = ("torch", "python", "cpp")

_DATA_CANDIDATES = [REPO_ROOT / "data"]


# ---------------------------------------------------------------------------
# case loading
# ---------------------------------------------------------------------------


def find_data_file(version: str, data_path: Optional[str]) -> Path:
    if data_path:
        return Path(data_path)
    name = f"benchmark_{version}.jsonl"
    for d in _DATA_CANDIDATES:
        p = d / name
        if p.exists():
            return p
    raise FileNotFoundError(f"no {name} found under {_DATA_CANDIDATES}")


def load_benchmark_cases(
    path: Path,
    case_ids: Optional[List[str]] = None,
    equation_types: Optional[List[str]] = None,
    solver_library: Optional[str] = None,
) -> List[Dict[str, Any]]:
    cases = [json.loads(l) for l in open(path) if l.strip()]
    if case_ids:
        wanted = set(case_ids)
        cases = [c for c in cases if c["id"] in wanted]
    if equation_types:
        wanted = set(equation_types)
        cases = [
            c
            for c in cases
            if c["oracle_config"]["pde"]["type"] in wanted
        ]
    if solver_library and solver_library not in SOLVER_LIBRARIES:
        # dataset-declared library support only constrains the reference's
        # dolfinx/firedrake/dealii stacks
        cases = [
            c
            for c in cases
            if solver_library in c.get("supported_libraries", [solver_library])
        ]
    return cases


# ---------------------------------------------------------------------------
# oracle (with NaN->null JSON cache)
# ---------------------------------------------------------------------------


def _nan_to_null(values: np.ndarray) -> List[Optional[float]]:
    return [None if not math.isfinite(v) else float(v) for v in values.ravel()]


def oracle_cache_dir(results_dir: Path, solver_library: str, device: str) -> Path:
    """Where this driver caches oracle results: keyed by library and
    device (a CPU oracle's time is not the card's), under a directory the
    JAX driver (<results_dir>/.oracle_cache/<library>) never writes."""
    return (
        Path(results_dir) / ".torch_oracle_cache" / solver_library
        / str(device).replace(":", "-")
    )


def run_oracle(
    case: Dict[str, Any],
    results_dir: Path,
    solver_library: str = "torch",
    force: bool = False,
    device: str = "cuda",
) -> Optional[Dict[str, Any]]:
    cache_dir = oracle_cache_dir(results_dir, solver_library, device)
    cache_dir.mkdir(parents=True, exist_ok=True)
    cache_file = cache_dir / f"{case['id']}.json"
    if cache_file.exists() and not force:
        try:
            return json.load(open(cache_file))
        except Exception:
            pass
    try:
        r = OracleSolver(device=device).solve(case["oracle_config"], solver_library)
    except Exception as e:
        print(f"  oracle FAILED for {case['id']}: {e}", file=sys.stderr)
        # graceful sentinel (reference :214)
        return {"error": 1e-2, "time": 10.0, "reference": None}
    info = {
        "error": r.baseline_error,
        "time": r.baseline_time,
        "num_dofs": r.num_dofs,
        "solver_info": r.solver_info,
        "reference": _nan_to_null(np.asarray(r.reference)),
        "reference_shape": list(np.asarray(r.reference).shape),
    }
    with open(cache_file, "w") as f:
        json.dump(info, f, default=str)
    return info


def write_oracle_reference(oracle_info: Dict[str, Any], outdir: Path) -> None:
    outdir.mkdir(parents=True, exist_ok=True)
    ref = oracle_info.get("reference")
    if ref is None:
        return
    arr = np.array(
        [np.nan if v is None else float(v) for v in ref], dtype=float
    ).reshape(oracle_info["reference_shape"])
    np.savez(outdir / "reference.npz", reference=arr)


# ---------------------------------------------------------------------------
# execution + error
# ---------------------------------------------------------------------------


def execute_solver(
    case: Dict[str, Any],
    code: str,
    workdir: Path,
    timeout_sec: float,
    solver_library: str,
    device: str = "cuda",
):
    outdir = workdir / "agent_output"
    if solver_library == "cpp":
        return CppExecutor().execute(code, case, str(outdir), timeout_sec)
    solver_path = workdir / "solver.py"
    solver_path.write_text(code)
    return execute_agent_function(
        str(solver_path), str(outdir), case, timeout_sec, device=device
    )


def compute_error(
    agent_outdir: Path, oracle_info: Dict[str, Any]
) -> Optional[float]:
    """NaN-masked rel-L2 with strict shape matching (reference :291-345)."""
    try:
        u = np.load(agent_outdir / "solution.npz")["u"]
    except Exception:
        return None
    ref = oracle_info.get("reference")
    if ref is None:
        return None
    r = np.array(
        [np.nan if v is None else float(v) for v in ref], dtype=float
    ).reshape(oracle_info["reference_shape"])
    if u.shape != r.shape:
        return None
    mask = np.isfinite(u) & np.isfinite(r)
    if not mask.any():
        return None
    diff = np.linalg.norm(u[mask] - r[mask])
    denom = np.linalg.norm(r[mask])
    if denom < 1e-15:
        return float(diff)
    return float(diff / denom)


def gate(
    error: Optional[float],
    agent_time: Optional[float],
    oracle_info: Dict[str, Any],
    eval_cfg: Dict[str, Any],
):
    """(status, target_error, target_time, fail_reason)."""
    acc_tol = eval_cfg.get("accuracy_tolerance")
    time_tol = eval_cfg.get("time_tolerance", 3)
    target_error = (
        max(oracle_info["error"] * acc_tol, MIN_ERROR_THRESHOLD)
        if acc_tol is not None
        else None
    )
    target_time = oracle_info["time"] * time_tol
    if target_error is not None:
        if error is None or not math.isfinite(error):
            return "FAIL", target_error, target_time, "INVALID_ERROR"
        if error > target_error:
            return "FAIL", target_error, target_time, "ACCURACY_FAIL"
    if agent_time is None or agent_time > target_time:
        return "FAIL", target_error, target_time, "TIME_FAIL"
    return "PASS", target_error, target_time, None


# ---------------------------------------------------------------------------
# single case (with multi-attempt loop)
# ---------------------------------------------------------------------------


def _generate_code(agent_name, agent_config, prompt, context=None):
    """Returns (code, meta, error_message)."""
    if AgentRegistry.is_registered(agent_name):
        agent = get_agent(agent_name, agent_config)
        resp = agent.generate_solution(prompt, context)
        if not resp.success:
            return None, resp.metadata, resp.error_message
        return resp.code, resp.metadata, None
    if agent_name in SUPPORTED_AGENTS:
        try:
            code, meta = call_llm(agent_name, prompt)
            return code, meta, None
        except LLMError as e:
            return None, {}, str(e)
    return None, {}, f"unknown agent '{agent_name}'"


def _gate_state(exec_ok, status, fail_reason):
    return {
        "exec": bool(exec_ok),
        "accuracy": bool(exec_ok and fail_reason not in ("ACCURACY_FAIL", "INVALID_ERROR") and status in ("PASS", "FAIL")) and fail_reason != "ACCURACY_FAIL" and fail_reason != "INVALID_ERROR",
        "final": status == "PASS",
    }


def _select_best_attempt(attempts: List[Dict[str, Any]]) -> int:
    """PASS > min error > last (reference :651-675)."""
    for i, a in enumerate(attempts):
        if a.get("status") == "PASS":
            return i
    errs = [
        (i, a.get("error"))
        for i, a in enumerate(attempts)
        if a.get("error") is not None and math.isfinite(a.get("error"))
    ]
    if errs:
        return min(errs, key=lambda t: t[1])[0]
    return len(attempts) - 1


def run_single_case(
    case: Dict[str, Any],
    agent_name: str,
    agent_config: Optional[Dict[str, Any]],
    results_dir: Path,
    solver_library: str,
    timeout_sec: float,
    max_attempts: int = 1,
    skip_generation: bool = False,
    solver_path: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    case_id = case["id"]
    case_dir = results_dir / agent_name / case_id
    case_dir.mkdir(parents=True, exist_ok=True)
    eval_cfg = case.get("evaluation_config", {})

    oracle_info = run_oracle(case, results_dir, solver_library, device=device)
    if oracle_info is None or oracle_info.get("reference") is None:
        result = {"case_id": case_id, "status": "ORACLE_ERROR"}
        json.dump(result, open(case_dir / "result.json", "w"))
        return result
    write_oracle_reference(oracle_info, case_dir / "oracle_output")

    prompt = generate_prompt(
        case,
        {"error": oracle_info["error"], "time": oracle_info["time"]},
        solver_library,
    )
    (case_dir / "prompt.md").write_text(prompt)

    attempts: List[Dict[str, Any]] = []
    transitions: List[Dict[str, Any]] = []
    total_cost = 0.0
    prev_gate = None

    ext = "cpp" if solver_library == "cpp" else "py"
    reuse_path = None
    if solver_path:
        reuse_path = Path(solver_path)
        if reuse_path.is_dir():
            # --eval-existing-dir batch mode: per-case solver files
            # (reference: run_benchmark.py:401-414, 1451-1472)
            cand = reuse_path / case_id / f"solver.{ext}"
            reuse_path = cand if cand.exists() else None
    elif skip_generation and (case_dir / f"solver.{ext}").exists():
        reuse_path = case_dir / f"solver.{ext}"

    for attempt_idx in range(1, max_attempts + 1):
        attempt: Dict[str, Any] = {"attempt": attempt_idx}
        if attempt_idx == 1 and reuse_path is not None:
            code, meta = reuse_path.read_text(), {}
        else:
            p = prompt
            if attempt_idx > 1:
                targets = {
                    "target_error": attempts[-1].get("target_error"),
                    "target_time": attempts[-1].get("target_time"),
                }
                p = create_feedback_prompt(prompt, attempts[-1], targets)
                (case_dir / f"prompt_attempt_{attempt_idx}.md").write_text(p)
            # code agents get the case + oracle for INTERNAL candidate
            # evaluation (reference codepde_wrapper.py:102-110)
            code, meta, gen_err = _generate_code(
                agent_name,
                agent_config,
                p,
                context={"case_spec": case, "oracle_info": oracle_info,
                         "device": device},
            )
            total_cost += float((meta or {}).get("cost_usd", 0.0))
            if code is None:
                attempt.update(status="LLM_ERROR", error_message=gen_err)
                attempts.append(attempt)
                continue
        suffix = "" if attempt_idx == 1 else f"_attempt_{attempt_idx}"
        (case_dir / f"solver{suffix}.{ext}").write_text(code)
        attempt["code"] = code

        t0 = time.time()
        er = execute_solver(
            case, code, case_dir, timeout_sec, solver_library, device
        )
        attempt.update(
            exec_success=er.success,
            error_message=er.error_message,
            stderr=er.stderr[-4000:],
            time=er.t_agent_run if er.t_agent_run else time.time() - t0,
        )
        if not er.success:
            attempt.update(status="FAIL", failure_stage="exec")
            attempts.append(attempt)
            g = {"exec": False, "accuracy": False, "final": False}
            if prev_gate is not None:
                transitions.append({"from": prev_gate, "to": g})
            prev_gate = g
            continue

        error = compute_error(case_dir / "agent_output", oracle_info)
        status, target_error, target_time, fail_reason = gate(
            error, attempt["time"], oracle_info, eval_cfg
        )
        attempt.update(
            error=error,
            status=status,
            fail_reason=fail_reason,
            target_error=target_error,
            target_time=target_time,
            failure_stage=(
                None
                if status == "PASS"
                else ("accuracy" if fail_reason in ("ACCURACY_FAIL", "INVALID_ERROR") else "time")
            ),
        )
        attempts.append(attempt)
        g = {
            "exec": True,
            "accuracy": fail_reason not in ("ACCURACY_FAIL", "INVALID_ERROR"),
            "final": status == "PASS",
        }
        if prev_gate is not None:
            transitions.append({"from": prev_gate, "to": g})
        prev_gate = g
        if status == "PASS":
            break

    best_idx = _select_best_attempt(attempts)
    best = attempts[best_idx]
    result: Dict[str, Any] = {
        "case_id": case_id,
        "agent": agent_name,
        "equation_type": case["oracle_config"]["pde"]["type"],
        "math_type": case.get("pde_classification", {}).get("math_type", []),
        "status": best.get("status", "FAIL"),
        "error": best.get("error"),
        "time": best.get("time"),
        "target_error": best.get("target_error"),
        "target_time": best.get("target_time"),
        "fail_reason": best.get("fail_reason"),
        "failure_stage": best.get("failure_stage"),
        "error_message": best.get("error_message", ""),
        "stderr": best.get("stderr", ""),
        "oracle_error": oracle_info["error"],
        "oracle_time": oracle_info["time"],
        "cost_usd": total_cost,
        "n_attempts": len(attempts),
        "best_attempt": best_idx + 1,
    }
    if max_attempts > 1:
        result["multi_attempt_info"] = {
            "all_attempts": [
                {k: v for k, v in a.items() if k not in ("code", "stderr")}
                for a in attempts
            ],
            "gate_transitions": transitions,
        }

    # gate breakdown + metrics
    ga = GateAnalyzer()
    breakdown = ga.analyze_single_case(
        case_id,
        {
            "success": best.get("exec_success", False),
            "error": best.get("error"),
            "time": best.get("time"),
            "error_message": best.get("error_message", ""),
        },
        {
            "target_error": best.get("target_error"),
            "target_time": best.get("target_time"),
            "fail_reason": best.get("fail_reason"),
        },
        oracle_info,
    )
    result["gate_breakdown"] = breakdown.__dict__

    if result["status"] == "PASS":
        result["universal_metrics"] = compute_universal_metrics(
            case_dir / "agent_output", oracle_info
        )
        for mt in result["math_type"]:
            comp = get_specialized_metrics_computer(
                mt, case_dir / "agent_output", case_dir / "oracle_output", case
            )
            if comp is not None:
                result.setdefault("specialized_metrics", {})[mt] = comp.compute(
                    {"runtime_sec": best.get("time")}
                )
    else:
        result["error_class"] = ErrorClassifier().classify(
            {**result, "code": best.get("code", "")}, case
        )

    json.dump(result, open(case_dir / "result.json", "w"), default=str)
    return result


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------


def compute_summary(results: List[Dict[str, Any]], agent: str) -> Dict[str, Any]:
    n = len(results)
    passed = [r for r in results if r.get("status") == "PASS"]

    def _rate(rs):
        return len([r for r in rs if r.get("status") == "PASS"]) / max(len(rs), 1)

    by_eq: Dict[str, List] = {}
    by_math: Dict[str, List] = {}
    for r in results:
        by_eq.setdefault(r.get("equation_type", "?"), []).append(r)
        for mt in r.get("math_type", []):
            by_math.setdefault(mt, []).append(r)

    ga = GateAnalyzer()
    breakdowns = []
    for r in results:
        b = r.get("gate_breakdown")
        if b:
            breakdowns.append(GateBreakdown(**b))
    summary = {
        "agent": agent,
        "total_cases": n,
        "passed": len(passed),
        "pass_rate": _rate(results),
        "by_equation_type": {
            t: {"total": len(rs), "passed": sum(r.get("status") == "PASS" for r in rs), "pass_rate": _rate(rs)}
            for t, rs in sorted(by_eq.items())
        },
        "by_math_type": {
            t: {"total": len(rs), "pass_rate": _rate(rs)}
            for t, rs in sorted(by_math.items())
        },
        "gate_statistics": ga.compute_aggregate_statistics(breakdowns),
        "total_cost_usd": sum(r.get("cost_usd", 0.0) for r in results),
        "error_classes": {},
    }
    for r in results:
        ec = r.get("error_class")
        if ec:
            summary["error_classes"][ec] = summary["error_classes"].get(ec, 0) + 1
    attempts = [r.get("n_attempts", 1) for r in results]
    if any(a > 1 for a in attempts):
        by_attempt: Dict[int, int] = {}
        for r in passed:
            by_attempt[r.get("best_attempt", 1)] = (
                by_attempt.get(r.get("best_attempt", 1), 0) + 1
            )
        summary["multi_attempt"] = {
            "mean_attempts": float(np.mean(attempts)),
            "pass_by_attempt": by_attempt,
        }
    return summary


def print_summary(summary: Dict[str, Any]) -> None:
    print(f"\n=== {summary['agent']} ===")
    print(
        f"pass {summary['passed']}/{summary['total_cases']} "
        f"({100 * summary['pass_rate']:.1f}%)  "
        f"cost ${summary['total_cost_usd']:.3f}"
    )
    for t, s in summary["by_equation_type"].items():
        print(f"  {t:24s} {s['passed']:3d}/{s['total']:3d} ({100 * s['pass_rate']:.0f}%)")
    gs = summary.get("gate_statistics", {})
    if gs.get("total_cases"):
        print(
            f"  gates: exec {100 * gs['exec_valid_rate']:.0f}% -> "
            f"accuracy {100 * gs['accuracy_pass_rate']:.0f}% -> "
            f"time {100 * gs['time_pass_rate']:.0f}%"
        )
    if summary.get("error_classes"):
        print(f"  failures: {summary['error_classes']}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def run_benchmark(args) -> Dict[str, Any]:
    data_file = find_data_file(args.version, args.data)
    cases = load_benchmark_cases(
        data_file, args.cases, args.equation_types, args.solver_library
    )
    if args.limit:
        cases = cases[: args.limit]
    print(f"loaded {len(cases)} cases from {data_file}")

    results_dir = Path(args.results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    agent_config = None
    if args.agent_config:
        raw = Path(args.agent_config).read_text()
        raw = os.path.expandvars(raw)  # ${ENV_VAR} interpolation (:94-102)
        agent_config = json.loads(raw)

    all_results: Dict[str, Any] = {}
    for agent in args.agents:
        results = []
        for i, case in enumerate(cases):
            print(f"[{agent}] {i + 1}/{len(cases)} {case['id']}", flush=True)
            r = run_single_case(
                case,
                agent,
                agent_config,
                results_dir,
                args.solver_library,
                args.timeout,
                max_attempts=args.max_attempts,
                skip_generation=args.skip_generation,
                solver_path=args.solver_path,
                device=args.device,
            )
            print(
                f"    -> {r.get('status')} "
                f"err={r.get('error') if r.get('error') is not None else '-'} "
                f"t={r.get('time') if r.get('time') is not None else '-'}",
                flush=True,
            )
            results.append(r)
        summary = compute_summary(results, agent)
        json.dump(
            summary,
            open(results_dir / agent / "summary.json", "w"),
            indent=2,
            default=str,
        )
        print_summary(summary)
        all_results[agent] = {"summary": summary, "results": results}

    json.dump(
        all_results,
        open(results_dir / "all_results.json", "w"),
        default=str,
    )
    return all_results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--agents", nargs="+", default=["mock"])
    ap.add_argument("--version", default="v2", choices=["v1", "v2"])
    ap.add_argument("--data", default=None, help="path to benchmark jsonl")
    ap.add_argument("--cases", nargs="+", default=None, help="case id filter")
    ap.add_argument("--equation-types", nargs="+", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--results-dir", default=str(REPO_ROOT / "results"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--max-attempts", type=int, default=1)
    ap.add_argument(
        "--solver-library",
        default="torch",
        choices=SOLVER_LIBRARIES,
        help="torch (pdebench_tpu_torch) | python | cpp",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the oracle and the agent's solver run (cuda, cpu, ...)",
    )
    ap.add_argument("--agent-config", default=None)
    ap.add_argument("--skip-generation", action="store_true")
    ap.add_argument(
        "--solver-path",
        default=None,
        help="solver file to evaluate for every case, or a directory of "
        "<case_id>/solver.py trees (--eval-existing-dir batch mode)",
    )
    ap.add_argument(
        "--eval-existing-dir",
        dest="solver_path",
        help="alias of --solver-path pointing at a results-style directory",
    )
    args = ap.parse_args(argv)
    run_benchmark(args)


if __name__ == "__main__":
    main()
