"""Multi-attempt feedback prompts.

Behavioral parity (reference: pdebench/core/feedback_prompt.py:10-229):
include the previous attempt's code (truncated), failure-stage-specific
advice (execution / accuracy / time), and a reminder of the task with
numeric targets.

Copy of pdebench_tpu/core/feedback_prompt.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

_MAX_CODE_CHARS = 2000


def _advice(failure_stage: Optional[str], prev: Dict[str, Any]) -> str:
    if failure_stage == "exec":
        return (
            "Your previous attempt FAILED TO EXECUTE. Read the error below "
            "carefully; fix the crash first (imports, syntax, output-shape "
            "or solver_info contract violations), then re-check numerics.\n"
            f"Error:\n{(prev.get('error_message') or '')[:800]}\n"
            f"Stderr (tail):\n{(prev.get('stderr') or '')[-800:]}"
        )
    def _fmt(v, spec=".3e"):
        return format(v, spec) if isinstance(v, (int, float)) else "?"

    if failure_stage == "accuracy":
        return (
            "Your previous attempt ran but was NOT ACCURATE ENOUGH "
            f"(error {_fmt(prev.get('error'))} vs target "
            f"{_fmt(prev.get('target_error'))}). Typical causes: mesh too "
            "coarse, polynomial degree too low, missing stabilization "
            "(SUPG for convection-dominated cases), too-loose solver "
            "tolerance, wrong source/BC signs, or sampling on the wrong "
            "grid orientation (u[j, i] = u(x[i], y[j]))."
        )
    if failure_stage == "time":
        def _fmt2(v):
            return format(v, ".2f") if isinstance(v, (int, float)) else "?"

        return (
            "Your previous attempt was accurate but TOO SLOW "
            f"(time {_fmt2(prev.get('time'))}s vs budget "
            f"{_fmt2(prev.get('target_time'))}s). Coarsen the mesh toward the "
            "minimum that still meets the accuracy target, use a cheaper "
            "solver/preconditioner, factorize once and reuse across time "
            "steps, and avoid Python-level per-element loops."
        )
    return "Your previous attempt failed; analyze the output below and fix it."


def create_feedback_prompt(
    original_prompt: str,
    prev_attempt: Dict[str, Any],
    targets: Optional[Dict[str, Any]] = None,
) -> str:
    targets = targets or {}
    code = (prev_attempt.get("code") or "")[:_MAX_CODE_CHARS]
    stage = prev_attempt.get("failure_stage")
    parts = [
        "You previously attempted this task and did not pass. Improve your "
        "solution based on the feedback below, then return the COMPLETE "
        "corrected solver code.",
        "",
        "## Previous Attempt (truncated)",
        "```",
        code,
        "```",
        "",
        "## What Went Wrong",
        _advice(stage, {**prev_attempt, **targets}),
        "",
        "## Task Reminder",
    ]
    if targets.get("target_error") is not None:
        parts.append(f"- accuracy target: rel-L2 <= {targets['target_error']:.3e}")
    if targets.get("target_time") is not None:
        parts.append(f"- time budget: <= {targets['target_time']:.2f} s")
    parts += ["", "## Original Task", original_prompt]
    return "\n".join(parts)
