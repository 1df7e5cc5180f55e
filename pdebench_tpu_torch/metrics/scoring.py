"""0-100 scoring for the two evaluation modes.

Behavioral parity: pdebench/metrics/scoring.py:11-204.
  fix_accuracy (fixed accuracy, optimize speed):
    error > target -> 0; else 100*budget/runtime capped at 100 when
    within budget, 50*budget/runtime partial credit when over.
  fix_time (fixed budget, optimize accuracy):
    runtime > budget -> 0; error >= target -> 10 baseline;
    else 100*(1 - error/target).
Defined for leaderboard experiments; the main driver gates on
thresholds directly (as the reference's does).

Copy of pdebench_tpu/metrics/scoring.py.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def compute_score(
    mode: str,
    runtime: float,
    error: float,
    target_error: float,
    time_budget: float,
) -> float:
    if mode == "fix_accuracy":
        if error > target_error or runtime <= 0:
            return 0.0
        speedup = time_budget / runtime
        if runtime <= time_budget:
            return min(100.0 * speedup, 100.0)
        return max(50.0 * speedup, 0.0)
    if mode == "fix_time":
        if runtime > time_budget or error < 0 or target_error <= 0:
            return 0.0
        ratio = error / target_error
        if ratio >= 1.0:
            return 10.0
        return max(100.0 * (1.0 - ratio), 0.0)
    raise ValueError(f"unknown evaluation mode: {mode}")


def compute_weighted_score(
    score_accuracy: float,
    score_time: float,
    weight_accuracy: float = 0.6,
    weight_time: float = 0.4,
) -> float:
    if abs(weight_accuracy + weight_time - 1.0) > 1e-12:
        raise ValueError("weights must sum to 1.0")
    return weight_accuracy * score_accuracy + weight_time * score_time


def compute_aggregate_score(case_scores: List[float]) -> Dict[str, float]:
    if not case_scores:
        return {"mean": 0.0, "median": 0.0, "min": 0.0, "max": 0.0, "pass_rate": 0.0}
    s = np.asarray(case_scores, dtype=float)
    return {
        "mean": float(s.mean()),
        "median": float(np.median(s)),
        "min": float(s.min()),
        "max": float(s.max()),
        "pass_rate": float((s > 0).mean()),
    }
