"""Library-level multi-attempt loop (generate -> execute -> gate ->
feedback), reusable outside the benchmark driver.

Role parity: pdebench/core/multi_attempt.py:13-251 (the reference driver
inlines its own copy at run_benchmark.py:873-1392; so does ours — this
module is the programmatic API for embedding the loop elsewhere).

Copy of pdebench_tpu/core/multi_attempt.py.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

from .feedback_prompt import create_feedback_prompt


def run_with_attempts(
    prompt: str,
    generate: Callable[[str], str],
    execute: Callable[[str], Dict[str, Any]],
    max_attempts: int = 3,
    targets: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Drive up to max_attempts generate/execute rounds with feedback.

    generate(prompt) -> code; execute(code) -> result dict with at least
    {status: 'PASS'|'FAIL', error?, time?, failure_stage?, error_message?,
    stderr?}. Returns {attempts, best, best_index, passed}.
    """
    targets = targets or {}
    attempts: List[Dict[str, Any]] = []
    current_prompt = prompt
    for i in range(1, max_attempts + 1):
        code = generate(current_prompt)
        result = dict(execute(code))
        result["attempt"] = i
        result["code"] = code
        attempts.append(result)
        if result.get("status") == "PASS":
            break
        current_prompt = create_feedback_prompt(prompt, result, targets)

    best_idx = select_best_attempt(attempts)
    return {
        "attempts": attempts,
        "best": attempts[best_idx],
        "best_index": best_idx,
        "passed": attempts[best_idx].get("status") == "PASS",
    }


def select_best_attempt(attempts: List[Dict[str, Any]]) -> int:
    """PASS > minimum finite error > last (reference :651-675)."""
    for i, a in enumerate(attempts):
        if a.get("status") == "PASS":
            return i
    scored = [
        (i, a["error"])
        for i, a in enumerate(attempts)
        if a.get("error") is not None and math.isfinite(a["error"])
    ]
    if scored:
        return min(scored, key=lambda t: t[1])[0]
    return len(attempts) - 1


def analyze_improvement(attempts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Attempt-over-attempt improvement analytics (reference :202-251)."""
    out: Dict[str, Any] = {
        "n_attempts": len(attempts),
        "passed_at": None,
        "error_trajectory": [a.get("error") for a in attempts],
        "stage_trajectory": [a.get("failure_stage") for a in attempts],
    }
    for i, a in enumerate(attempts):
        if a.get("status") == "PASS":
            out["passed_at"] = i + 1
            break
    errs = [
        e for e in out["error_trajectory"] if e is not None and math.isfinite(e)
    ]
    if len(errs) >= 2:
        out["error_improved"] = errs[-1] < errs[0]
        out["error_reduction_factor"] = (
            errs[0] / errs[-1] if errs[-1] > 0 else float("inf")
        )
    return out
