"""Regex-based failure classification into the reference's nine buckets.

Behavioral parity: pdebench/analysis/error_classifier.py:13-224 — same
category labels (syntax_error, import_error, api_error, timeout,
convergence_error, math_error, parameter_error, stabilization_missing,
other) and the same precedence order; pattern sets are our own.

Copy of pdebench_tpu/analysis/error_classifier.py.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional


class ErrorClassifier:
    SYNTAX_ERROR = "syntax_error"
    API_ERROR = "api_error"
    MATH_ERROR = "math_error"
    PARAMETER_ERROR = "parameter_error"
    STABILIZATION_MISSING = "stabilization_missing"
    TIMEOUT = "timeout"
    IMPORT_ERROR = "import_error"
    CONVERGENCE_ERROR = "convergence_error"
    OTHER = "other"

    _SYNTAX = (
        r"syntaxerror",
        r"indentationerror",
        r"invalid syntax",
        r"unexpected eof",
        r"taberror",
    )
    _IMPORT = (
        r"importerror",
        r"modulenotfounderror",
        r"no module named",
        r"cannot import name",
    )
    _API = (
        r"attributeerror",
        r"typeerror.*argument",
        r"typeerror.*unexpected keyword",
        r"has no attribute",
        r"takes \d+ positional arguments",
        r"not callable",
        r"keyerror",
    )
    _TIMEOUT = (r"timeout", r"timed out", r"timeoutexpired")
    _CONVERGENCE = (
        r"did not converge",
        r"diverged",
        r"not converge",
        r"ksp_diverged",
        r"snes.*diverg",
        r"max.*iterations.*exceeded",
        r"singular matrix",
        r"factorization fail",
    )
    _MATH = (
        r"\bnan\b",
        r"\binf\b",
        r"overflow",
        r"division by zero",
        r"zerodivisionerror",
        r"domain error",
        r"shape mismatch",
        r"shapes.*not aligned",
        r"broadcast",
    )

    def classify(
        self,
        result: Dict[str, Any],
        case: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        status = result.get("status")
        if status == "PASS":
            return None
        if status in ("LLM_ERROR", "AGENT_ERROR"):
            return "llm_call_error"

        text = (
            f"{result.get('error_message', '')}\n{result.get('stderr', '')}"
        ).lower()

        def hit(patterns) -> bool:
            return any(re.search(p, text) for p in patterns)

        if hit(self._SYNTAX):
            return self.SYNTAX_ERROR
        if hit(self._IMPORT):
            return self.IMPORT_ERROR
        if hit(self._API):
            return self.API_ERROR
        if hit(self._TIMEOUT) or status == "TIMEOUT":
            return self.TIMEOUT
        if hit(self._CONVERGENCE):
            return self.CONVERGENCE_ERROR
        if hit(self._MATH):
            return self.MATH_ERROR

        # semantic analysis of the agent's code for parameter /
        # stabilization issues (accuracy failures with clean execution)
        code = (result.get("code") or "").lower()
        if case is not None and result.get("status") in ("ACCURACY_FAIL", "FAIL"):
            pde = case.get("oracle_config", case).get("pde", {})
            params = pde.get("pde_params", {})
            needs_supg = (
                str(params.get("stabilization", "")).lower() == "supg"
                or (
                    pde.get("type") == "convection_diffusion"
                    and float(params.get("epsilon", 1.0)) < 0.05
                )
            )
            if needs_supg and code and "supg" not in code and "tau" not in code:
                return self.STABILIZATION_MISSING
            if code:
                m = re.search(r"resolution\D{0,12}(\d+)", code)
                if m and int(m.group(1)) < 16:
                    return self.PARAMETER_ERROR
        return self.OTHER

    def classify_batch(self, results, cases=None) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        case_by_id = {c.get("id"): c for c in (cases or [])}
        for r in results:
            cat = self.classify(r, case_by_id.get(r.get("case_id")))
            if cat:
                counts[cat] = counts.get(cat, 0) + 1
        return counts
