"""Bundled agent wrappers.

Parity targets (reference: pdebench/agents/):
  - codepde_wrapper.py: repeated-sample generation with INTERNAL
    candidate evaluation (sandbox run + rel-L2 vs the oracle) and
    debug-message feedback between trials (:90-210, :487-540). Rebuilt
    natively here — the loop is the value, not the external framework,
    so 'codepde' is fully functional offline (any llm_client model,
    incl. the mock).
  - openhands_wrapper.py: drives the OpenHands CLI/SDK in a scratch
    workspace with an anti-cheating contract appended to the task
  - mini_swe_agent_wrapper.py: mini-swe-agent Python API in a tmp
    workspace, reads back solver.py

The OpenHands / mini-swe external frameworks don't ship in this image;
when they are absent both wrappers fall back to a NATIVE shell-agent
loop with the same shape as mini-swe-agent's: the model emits one bash
command per turn inside a scratch workspace, observes stdout/stderr,
and submits when the solver file is written. The loop runs fully
offline against the mock LLM (tests/test_agents.py), and against any
configured provider online. Two more fully-functional wrappers:
  - 'llm': one-shot LLM call through core.llm_client
  - 'script': run a user-supplied command that reads the prompt on
    stdin and prints solver code (hook for arbitrary local agents)

Copy of pdebench_tpu/agents/wrappers.py on the port's core and sandbox;
CodePDE's internal evaluation runs a candidate on the device named by
context["device"] (the sandbox's default when absent).
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..core.llm_client import LLMError, call_llm
from .agent_registry import register
from .base_agent import AgentResponse, BaseAgent

ANTI_CHEAT_CONTRACT = """
IMPORTANT CONSTRAINTS:
- Work ONLY inside the provided workspace directory.
- Do NOT read files outside the workspace (no oracle sources, no cached
  reference solutions, no benchmark data files).
- Do NOT attempt to recover or reverse-engineer the reference solver.
- Produce a single self-contained solver file as instructed.
"""


@register("llm")
class LLMAgent(BaseAgent):
    """One-shot LLM call; config: {'model': <SUPPORTED_AGENTS key>}."""

    def generate_solution(self, prompt, context=None) -> AgentResponse:
        model = self.config.get("model", "mock")
        try:
            code, meta = call_llm(model, prompt)
            return AgentResponse(code=code, raw_response=code, metadata=meta)
        except LLMError as e:
            return AgentResponse(code="", success=False, error_message=str(e))


@register("script")
class ScriptAgent(BaseAgent):
    """Run a local command as the agent: prompt on stdin, code on stdout.

    config: {'command': [argv...], 'timeout_sec': 600}
    """

    def generate_solution(self, prompt, context=None) -> AgentResponse:
        cmd = self.config.get("command")
        if not cmd:
            return AgentResponse(
                code="", success=False,
                error_message="script agent needs config['command']",
            )
        try:
            proc = subprocess.run(
                cmd,
                input=prompt,
                capture_output=True,
                text=True,
                timeout=float(self.config.get("timeout_sec", 600)),
            )
        except Exception as e:
            return AgentResponse(code="", success=False, error_message=str(e))
        if proc.returncode != 0:
            return AgentResponse(
                code="",
                success=False,
                error_message=f"agent command failed: {proc.stderr[-500:]}",
            )
        from ..core.llm_client import extract_code

        return AgentResponse(
            code=extract_code(proc.stdout), raw_response=proc.stdout
        )


SHELL_LOOP_INSTRUCTIONS = """
You are an autonomous agent working in a scratch workspace directory
(your current working directory). The workspace contains
`case_spec.json` (the case specification above, as a file).

Each turn, reply with exactly ONE shell command inside a ```bash
fenced code block. You will receive its stdout+stderr (truncated) as
the next observation. Multi-line commands (heredocs) are allowed
inside the single block.

Write the final solver to `{solver_name}` in the workspace. When it is
complete, submit by replying with:
```bash
echo SUBMIT_FINAL_ANSWER
```
"""

_BASH_BLOCK = None  # compiled lazily


def _extract_bash(text: str) -> Optional[str]:
    """Last ```bash/```sh fenced block in the reply (one command per
    turn, mini-swe-agent convention)."""
    import re

    global _BASH_BLOCK
    if _BASH_BLOCK is None:
        _BASH_BLOCK = re.compile(
            r"```(?:bash|sh|shell)?[ \t]*\n(.*?)```", re.S
        )
    blocks = _BASH_BLOCK.findall(text)
    return blocks[-1].strip() if blocks else None


def run_shell_agent_loop(
    prompt: str,
    model: str,
    workdir: Path,
    solver_name: str = "solver.py",
    max_steps: int = 15,
    step_timeout: float = 120.0,
    case_spec: Optional[Dict[str, Any]] = None,
) -> AgentResponse:
    """Native agentic shell loop (role parity with mini-swe-agent /
    OpenHands headless: reference agents/mini_swe_agent_wrapper.py,
    openhands_wrapper.py — task in a tmp workspace, bash tool loop,
    read back solver.py). One bash block per LLM turn; observations are
    fed back; terminates on the submit marker or the step budget."""
    import json as _json

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if case_spec is not None:
        (workdir / "case_spec.json").write_text(_json.dumps(case_spec))

    base = (
        prompt
        + "\n"
        + ANTI_CHEAT_CONTRACT
        + SHELL_LOOP_INSTRUCTIONS.format(solver_name=solver_name)
    )
    transcript: list = []
    n_calls, cost = 0, 0.0
    submitted = False
    for _step in range(max_steps):
        p = base + "".join(transcript[-8:])
        try:
            text, meta = call_llm(model, p, extract=False)
        except LLMError as e:
            return AgentResponse(
                code="", success=False, error_message=str(e)
            )
        n_calls += 1
        cost += float((meta or {}).get("cost_usd", 0.0))
        cmd = _extract_bash(text)
        if cmd is None:
            transcript.append(
                "\n\nObservation: no ```bash block found in your reply;"
                " respond with exactly one bash code block.\n"
            )
            continue
        if "SUBMIT_FINAL_ANSWER" in cmd:
            submitted = True
            break
        try:
            proc = subprocess.run(
                ["bash", "-c", cmd],
                cwd=str(workdir),
                capture_output=True,
                text=True,
                timeout=step_timeout,
            )
            obs = (proc.stdout + proc.stderr)[-2000:]
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            obs, rc = f"[command timed out after {step_timeout}s]", 124
        transcript.append(
            f"\n\n$ {cmd}\n(exit {rc})\n{obs}\n"
        )

    solver = workdir / solver_name
    if not solver.exists():
        how = "submitted" if submitted else "step budget exhausted"
        return AgentResponse(
            code="",
            success=False,
            error_message=(
                f"agent loop ended ({how}) without writing {solver_name}"
            ),
            metadata={"llm_calls": n_calls, "cost_usd": cost},
        )
    return AgentResponse(
        code=solver.read_text(),
        raw_response="".join(transcript)[-8000:],
        metadata={
            "native_loop": True,
            "llm_calls": n_calls,
            "steps": n_calls,
            "submitted": submitted,
            "cost_usd": cost,
        },
    )


class _ExternalFrameworkAgent(BaseAgent):
    """Shared base: drive the real external framework when installed,
    else run the native shell-agent loop (same task contract)."""

    framework = "?"
    install_hint = "?"

    def _setup(self):
        path = self.config.get("framework_path")
        if path:
            sys.path.insert(0, str(path))

    def _framework_available(self) -> bool:
        return False

    def _run_framework(self, task, context) -> AgentResponse:
        raise NotImplementedError

    def generate_solution(self, prompt, context=None) -> AgentResponse:
        task = prompt + "\n" + ANTI_CHEAT_CONTRACT
        if self._framework_available():
            return self._run_framework(task, context)
        if not bool(self.config.get("native_fallback", True)):
            return AgentResponse(
                code="",
                success=False,
                error_message=(
                    f"the external '{self.framework}' framework is not "
                    f"installed ({self.install_hint}) and native_fallback "
                    "is disabled"
                ),
            )
        context = context or {}
        with tempfile.TemporaryDirectory() as tmp:
            return run_shell_agent_loop(
                task,
                self.config.get("model", "mock"),
                Path(tmp),
                max_steps=int(self.config.get("max_steps", 15)),
                step_timeout=float(self.config.get("step_timeout", 120)),
                case_spec=context.get("case_spec"),
            )


def _debug_feedback(prompt: str, code: str, eval_result: Dict[str, Any]) -> str:
    """Debug message appended between trials (reference
    codepde_wrapper.py:464-476 _build_debug_message)."""
    parts = [
        prompt,
        "\n---\nThe previous code failed to run or produced invalid "
        "results. Fix the issues and return a FULL, runnable script "
        "only. solve(case_spec) must return {'u': grid, 'solver_info': "
        "{...}} with the exact output-grid shape.",
    ]
    if eval_result.get("error_message"):
        parts.append(f"\nError message:\n{eval_result['error_message']}")
    if eval_result.get("stderr"):
        parts.append(f"\nStderr (tail):\n{eval_result['stderr'][-2000:]}")
    if eval_result.get("error") is not None:
        parts.append(
            f"\nAchieved rel-L2 error: {eval_result['error']:.3e} "
            "(reduce it below the target)"
        )
    parts.append(f"\nPrevious code:\n```python\n{code[:2000]}\n```")
    return "\n".join(parts)


@register("codepde")
class CodePDEAgent(BaseAgent):
    """CodePDE-style repeated sampling with internal candidate
    evaluation + debug feedback, rebuilt natively (reference:
    agents/codepde_wrapper.py:90-210, 487-574).

    config:
      model                 llm_client model key (default 'mock')
      num_repeated_samples  outer samples (default 3)
      num_debugging_trials  feedback retries per sample (default 3)
      evaluate_candidates   internal sandbox eval on/off (default True)
      eval_timeout_sec      per-candidate sandbox timeout (default 120)

    generate_solution(prompt, context) expects context to carry
    'case_spec' (the full case record) and 'oracle_info' (with
    'reference'/'reference_shape' and 'error') for the internal
    evaluation, and may carry 'device' (where a candidate runs); without
    the first two it degrades to best-of-N sampling.
    """

    def generate_solution(self, prompt, context=None) -> AgentResponse:
        model = self.config.get("model", "mock")
        n_samples = int(self.config.get("num_repeated_samples", 3))
        n_trials = int(self.config.get("num_debugging_trials", 3))
        evaluate = bool(self.config.get("evaluate_candidates", True))
        timeout = float(self.config.get("eval_timeout_sec", 120))

        context = context or {}
        case_spec = context.get("case_spec")
        oracle_info = context.get("oracle_info")
        can_eval = evaluate and case_spec is not None and oracle_info

        best: Optional[Dict[str, Any]] = None
        last_code, last_raw = "", ""
        n_calls, n_evaluated = 0, 0
        cost = 0.0

        for _sample in range(n_samples):
            p = prompt
            for trial in range(n_trials):
                try:
                    code, meta = call_llm(model, p)
                except LLMError as e:
                    if best is not None or last_code:
                        break
                    return AgentResponse(
                        code="", success=False, error_message=str(e)
                    )
                n_calls += 1
                cost += float((meta or {}).get("cost_usd", 0.0))
                last_code, last_raw = code, code

                if not can_eval:
                    # best-of-N without an oracle: keep the longest
                    # non-empty candidate (reference :121-134 semantics)
                    score = len(code.strip())
                    if best is None or score > best.get("_score", -1):
                        best = {"code": code, "error": None, "_score": score}
                    break

                ev = self._evaluate_candidate(code, case_spec, timeout,
                                              oracle_info, context.get("device"))
                n_evaluated += 1
                if ev["success"] and ev["error"] is not None:
                    if best is None or (
                        best.get("error") is None
                        or ev["error"] < best["error"]
                    ):
                        best = {"code": code, "error": ev["error"]}
                    break  # this sample produced a working candidate
                if trial < n_trials - 1:
                    p = _debug_feedback(prompt, code, ev)

        if best is None:
            if not last_code:
                return AgentResponse(
                    code="",
                    success=False,
                    error_message="codepde: no candidate produced",
                )
            best = {"code": last_code, "error": None}

        return AgentResponse(
            code=best["code"],
            raw_response=last_raw,
            metadata={
                "agent": "codepde",
                "model": model,
                "llm_calls": n_calls,
                "candidates_evaluated": n_evaluated,
                "internal_best_error": best.get("error"),
                "cost_usd": cost,
            },
        )

    @staticmethod
    def _evaluate_candidate(
        code: str,
        case_spec: Dict[str, Any],
        timeout: float,
        oracle_info: Dict[str, Any],
        device: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Sandbox-run a candidate and score it against the oracle
        reference (reference codepde_wrapper.py:487-540)."""
        from ..sandbox.executor import execute_agent_function

        with tempfile.TemporaryDirectory() as tmp:
            solver = Path(tmp) / "solver.py"
            solver.write_text(code)
            outdir = Path(tmp) / "agent_output"
            er = execute_agent_function(
                str(solver), str(outdir), case_spec, timeout_sec=timeout,
                device=device,
            )
            if not er.success:
                return {
                    "success": False,
                    "error": None,
                    "stderr": er.stderr,
                    "error_message": er.error_message,
                }
            err = _rel_l2_vs_reference(outdir, oracle_info)
            if err is None or not np.isfinite(err):
                return {
                    "success": False,
                    "error": None,
                    "stderr": er.stderr,
                    "error_message": "error computation failed "
                    "(shape mismatch or non-finite values)",
                }
            return {"success": True, "error": float(err), "stderr": ""}


def _rel_l2_vs_reference(
    outdir: Path, oracle_info: Dict[str, Any]
) -> Optional[float]:
    """NaN-masked rel-L2 vs the oracle reference, strict shape (same
    semantics as the driver's compute_error)."""
    try:
        u = np.load(Path(outdir) / "solution.npz")["u"]
    except Exception:
        return None
    ref = oracle_info.get("reference")
    shape = oracle_info.get("reference_shape")
    if ref is None:
        return None
    ref = np.asarray(
        [np.nan if v is None else float(v) for v in np.ravel(ref)]
    )
    if shape:
        ref = ref.reshape(shape)
    if tuple(u.shape) != tuple(ref.shape):
        return None
    m = ~np.isnan(ref)
    if not m.any():
        return None
    diff = np.where(m, u - ref, 0.0)
    nref = float(np.linalg.norm(ref[m]))
    nd = float(np.linalg.norm(diff[m]))
    return nd / nref if nref > 1e-15 else nd


@register("openhands")
class OpenHandsAgent(_ExternalFrameworkAgent):
    """OpenHands headless CLI when installed; native shell-agent loop
    otherwise (reference: agents/openhands_wrapper.py — headless task
    with the anti-cheat contract, solver read back from the workspace)."""

    framework = "OpenHands"
    install_hint = "pip install openhands-ai (not available offline)"

    def _framework_available(self) -> bool:
        import shutil

        return shutil.which("openhands") is not None

    def _run_framework(self, task, context) -> AgentResponse:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                proc = subprocess.run(
                    ["openhands", "--headless", "-t", task],
                    cwd=tmp,
                    capture_output=True,
                    text=True,
                    timeout=float(self.config.get("timeout_sec", 1800)),
                )
            except Exception as e:
                return AgentResponse(
                    code="", success=False, error_message=str(e)
                )
            solver = Path(tmp) / "solver.py"
            if solver.exists():
                return AgentResponse(
                    code=solver.read_text(),
                    raw_response=proc.stdout[-8000:],
                    metadata={"agent": "openhands"},
                )
            from ..core.llm_client import extract_code

            code = extract_code(proc.stdout)
            return AgentResponse(
                code=code,
                raw_response=proc.stdout[-8000:],
                success=bool(code),
                error_message=None if code else "openhands wrote no solver",
                metadata={"agent": "openhands"},
            )


@register("mini-swe-agent")
class MiniSweAgent(_ExternalFrameworkAgent):
    """mini-swe-agent Python API when installed; the native loop IS the
    mini-swe protocol (one bash block per turn, observation feedback),
    so the fallback preserves the agent's semantics offline (reference:
    agents/mini_swe_agent_wrapper.py:19-37)."""

    framework = "mini-swe-agent"
    install_hint = "pip install mini-swe-agent (not available offline)"

    def _framework_available(self) -> bool:
        try:
            import minisweagent  # noqa: F401

            return True
        except ImportError:
            return False

    def _run_framework(self, task, context) -> AgentResponse:
        # External-framework drive; exercised only when minisweagent is
        # installed (not in this image). Keep the surface minimal: run
        # the default agent in a tmp workspace, read back solver.py.
        with tempfile.TemporaryDirectory() as tmp:
            try:
                from minisweagent.run import run_task  # type: ignore

                run_task(task, cwd=tmp)
            except Exception as e:
                return AgentResponse(
                    code="", success=False, error_message=str(e)
                )
            solver = Path(tmp) / "solver.py"
            if not solver.exists():
                return AgentResponse(
                    code="",
                    success=False,
                    error_message="mini-swe-agent wrote no solver.py",
                )
            return AgentResponse(
                code=solver.read_text(),
                metadata={"agent": "mini-swe-agent"},
            )
