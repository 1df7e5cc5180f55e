"""Three-gate (exec -> accuracy -> time) per-case analysis + aggregates.

Behavioral parity: pdebench/analysis/gate_analyzer.py:12-197 — the
accuracy-first gate order, failure_stage/reason labeling, aggregate
rates including conditional pass rates and per-PDE grouping.

Copy of pdebench_tpu/analysis/gate_analyzer.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class GateBreakdown:
    case_id: str
    exec_valid: bool = False
    accuracy_pass: bool = False
    time_pass: bool = False
    final_pass: bool = False
    failure_stage: Optional[str] = None  # 'exec' | 'accuracy' | 'time' | None
    failure_reason: Optional[str] = None


class GateAnalyzer:
    def analyze_single_case(
        self,
        case_id: str,
        exec_result: Dict[str, Any],
        eval_result: Dict[str, Any],
        oracle_info: Dict[str, Any],
    ) -> GateBreakdown:
        b = GateBreakdown(case_id=case_id)
        if not exec_result.get("success", False):
            b.failure_stage = "exec"
            b.failure_reason = exec_result.get("error_message", "EXECUTION_FAILED")
            return b
        b.exec_valid = True

        agent_error = exec_result.get("error")
        target_error = eval_result.get("target_error")
        if agent_error is None or target_error is None:
            b.failure_stage = "accuracy"
            b.failure_reason = "MISSING_ERROR_INFO"
            return b
        if np.isnan(agent_error) or agent_error > target_error:
            b.failure_stage = "accuracy"
            b.failure_reason = eval_result.get("fail_reason", "ACCURACY_FAIL")
            return b
        b.accuracy_pass = True

        agent_time = exec_result.get("time")
        target_time = eval_result.get("target_time")
        if agent_time is None or target_time is None:
            b.failure_stage = "time"
            b.failure_reason = "MISSING_TIME_INFO"
            return b
        if agent_time > target_time:
            b.failure_stage = "time"
            b.failure_reason = eval_result.get("fail_reason", "TIME_FAIL")
            return b
        b.time_pass = True
        b.final_pass = True
        return b

    def compute_aggregate_statistics(
        self, breakdowns: List[GateBreakdown]
    ) -> Dict[str, Any]:
        n = len(breakdowns)
        if n == 0:
            return {"total_cases": 0}
        n_exec = sum(b.exec_valid for b in breakdowns)
        n_acc = sum(b.accuracy_pass for b in breakdowns)
        n_time = sum(b.time_pass for b in breakdowns)
        n_pass = sum(b.final_pass for b in breakdowns)
        stages = [b.failure_stage for b in breakdowns if b.failure_stage]
        return {
            "total_cases": n,
            "exec_valid_rate": n_exec / n,
            "accuracy_pass_rate": n_acc / n,
            "time_pass_rate": n_time / n,
            "final_pass_rate": n_pass / n,
            # conditional rates (of those who reached the gate)
            "accuracy_pass_given_exec": (n_acc / n_exec) if n_exec else 0.0,
            "time_pass_given_accuracy": (n_time / n_acc) if n_acc else 0.0,
            "failure_by_stage": {
                s: stages.count(s) for s in ("exec", "accuracy", "time")
            },
        }

    def group_by_pde_type(
        self,
        breakdowns: List[GateBreakdown],
        case_types: Dict[str, str],
    ) -> Dict[str, Dict[str, Any]]:
        """Aggregate per PDE type; case_types maps case_id -> type."""
        groups: Dict[str, List[GateBreakdown]] = {}
        for b in breakdowns:
            groups.setdefault(case_types.get(b.case_id, "unknown"), []).append(b)
        return {
            t: self.compute_aggregate_statistics(bs) for t, bs in groups.items()
        }
