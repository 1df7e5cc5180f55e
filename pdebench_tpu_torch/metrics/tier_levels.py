"""Three-tier (L1/L2/L3) evaluation derived from oracle baselines.

Behavioral parity: pdebench/metrics/tier_levels.py:14-280.
  Tiers generated from the oracle's own error/time:
    accuracy targets = baseline_error x (100, 1, 0.01)
    time budgets     = baseline_time  x (0.1, 1, 10)
  check_tier_levels gates one axis at the baseline (x1.2 slack) and
  grades the other.

Copy of pdebench_tpu/metrics/tier_levels.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def generate_tier_levels(
    error_ref: float,
    time_ref: float,
    accuracy_multipliers: Optional[Tuple[float, float, float]] = None,
    speed_multipliers: Optional[Tuple[float, float, float]] = None,
) -> Dict[str, Any]:
    am = accuracy_multipliers or (100.0, 1.0, 0.01)
    sm = speed_multipliers or (0.1, 1.0, 10.0)
    return {
        "accuracy": {
            "level_1": {"target_error": error_ref * am[0], "name": "Low/Engineering"},
            "level_2": {"target_error": error_ref * am[1], "name": "Medium/Standard"},
            "level_3": {"target_error": error_ref * am[2], "name": "High/Scientific"},
        },
        "speed": {
            "fast": {"time_budget": time_ref * sm[0], "name": "Real-time"},
            "medium": {"time_budget": time_ref * sm[1], "name": "Interactive"},
            "slow": {"time_budget": time_ref * sm[2], "name": "Batch"},
        },
    }


# alias used by driver code paths mirroring the reference
generate_tiers_from_baseline = generate_tier_levels


def check_tier_levels(
    mode: str, runtime: float, error: float, tiers: Dict[str, Any]
) -> Dict[str, Any]:
    empty = {
        "passed": [],
        "total": 3,
        "level_details": {f"level_{i}": False for i in (1, 2, 3)},
    }
    if not tiers:
        return empty
    passed: List[int] = []
    if mode == "fix_accuracy":
        budget = tiers["speed"]["medium"]["time_budget"]
        if runtime <= budget * 1.2:
            acc = tiers["accuracy"]
            if error <= acc["level_3"]["target_error"]:
                passed = [1, 2, 3]
            elif error <= acc["level_2"]["target_error"]:
                passed = [1, 2]
            elif error <= acc["level_1"]["target_error"]:
                passed = [1]
    elif mode == "fix_time":
        target = tiers["accuracy"]["level_2"]["target_error"]
        if error <= target * 1.2:
            spd = tiers["speed"]
            if runtime <= spd["fast"]["time_budget"]:
                passed = [1, 2, 3]
            elif runtime <= spd["medium"]["time_budget"]:
                passed = [1, 2]
            elif runtime <= spd["slow"]["time_budget"]:
                passed = [1]
    return {
        "passed": passed,
        "total": 3,
        "level_details": {f"level_{i}": (i in passed) for i in (1, 2, 3)},
    }


def compute_tier_pass_rates(results: List[Dict[str, Any]]) -> Dict[str, float]:
    """Fraction of cases passing each level over a result list containing
    'tier_result' dicts from check_tier_levels."""
    if not results:
        return {f"level_{i}_rate": 0.0 for i in (1, 2, 3)}
    out = {}
    for i in (1, 2, 3):
        hits = sum(
            1
            for r in results
            if r.get("tier_result", {}).get("level_details", {}).get(f"level_{i}")
        )
        out[f"level_{i}_rate"] = hits / len(results)
    return out


def compute_weighted_tier_score(
    tier_result: Dict[str, Any], weights: Tuple[float, float, float] = (20.0, 30.0, 50.0)
) -> float:
    """Weighted 0-100 score over passed levels (L1=20, L2=30, L3=50)."""
    details = tier_result.get("level_details", {})
    return float(
        sum(w for i, w in zip((1, 2, 3), weights) if details.get(f"level_{i}"))
    )
