"""The port's harness layers (metrics, analysis, prompts, feedback, the
LLM client's mock, agents, the sandbox) against the JAX package's: the
same inputs through both, the outputs equal. Cases follow the reference's
tests/test_harness.py, test_core.py and test_agents.py.

The reference's sandbox runner imports jax when PDEBENCH_TPU_PLATFORM is
set (this suite's conftest sets it); the reference runs here clear it, so
its agent processes start as fast as the port's (the mock agents import
numpy only)."""

import json
import math
import shutil
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import pdebench_tpu.agents as ref_agents
import pdebench_tpu.agents.wrappers as ref_wrappers
import pdebench_tpu.analysis as ref_analysis
import pdebench_tpu.core as ref_core
import pdebench_tpu.core.llm_client as ref_llm
import pdebench_tpu.core.multi_attempt as ref_multi
import pdebench_tpu.metrics as ref_metrics
import pdebench_tpu.metrics.universal as ref_universal
import pdebench_tpu.sandbox as ref_sandbox
import pdebench_tpu.sandbox.executor as ref_executor
import pdebench_tpu_torch.agents as agents
import pdebench_tpu_torch.agents.wrappers as wrappers
import pdebench_tpu_torch.analysis as analysis
import pdebench_tpu_torch.core as core
import pdebench_tpu_torch.core.llm_client as llm
import pdebench_tpu_torch.core.multi_attempt as multi
import pdebench_tpu_torch.metrics as metrics
import pdebench_tpu_torch.metrics.universal as universal
import pdebench_tpu_torch.sandbox as sandbox
import pdebench_tpu_torch.sandbox.executor as executor

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data" / "benchmark_v2.jsonl"


def same(a, b):
    """Equal, NaN equal to NaN, through dicts, lists and arrays."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _dataset(*ids):
    out = {}
    with open(DATA) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] in ids:
                out[c["id"]] = c
    return [out[i] for i in ids]


def _toy_case():
    return {
        "id": "t1",
        "oracle_config": {
            "pde": {
                "type": "poisson",
                "source_term": "1.0",
                "manufactured_solution": {"u": "x"},
            },
            "domain": {"type": "unit_square"},
            "mesh": {"resolution": 64},
            "fem": {"degree": 1},
            "oracle_solver": {"ksp_type": "cg"},
            "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 8, "ny": 8}},
        },
    }


def _supg_case():
    return {
        "id": "case1",
        "pde_classification": {"math_type": ["mixed_type"]},
        "oracle_config": {
            "pde": {
                "type": "convection_diffusion",
                "pde_params": {"epsilon": 0.01, "beta": [10.0, 10.0],
                               "stabilization": "supg"},
                "source_term": "1.0",
            },
            "domain": {"type": "unit_square"},
            "mesh": {"resolution": 160},
            "fem": {"degree": 1},
            "bc": {"dirichlet": {"on": "all", "value": "0"}},
            "oracle_solver": {"ksp_type": "gmres", "stabilization": "supg"},
            "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 50, "ny": 50}},
        },
        "evaluation_config": {"accuracy_tolerance": 10, "time_tolerance": 3,
                              "timeout_sec": 300},
        "agent_knobs": ["mesh_resolution (64-256)", "element_degree"],
    }


# ---------------------------------------------------------------------------
# metrics and analysis
# ---------------------------------------------------------------------------


def _arrays(kind):
    rng = np.random.default_rng(0)
    if kind == "ramp":
        ref = np.outer(np.linspace(0, 1, 16), np.ones(16))
        return ref + 0.01, ref
    if kind == "nan_mask":
        ref = np.ones((8, 8))
        ref[0, :] = np.nan
        return np.ones((8, 8)) * 1.5, ref
    if kind == "random_3d":
        ref = rng.random((6, 7, 8))
        return ref + 0.05 * rng.standard_normal(ref.shape), ref
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["ramp", "nan_mask", "random_3d"])
def test_metrics_from_arrays_match_reference(kind):
    agent, ref = _arrays(kind)
    got = universal.compute_metrics_from_arrays(agent, ref)
    assert same(got, ref_universal.compute_metrics_from_arrays(agent, ref))
    assert "rmse" in got and ("frmse_low" in got) == (agent.ndim == 2)


def test_universal_metrics_files_match_reference(tmp_path):
    u = np.random.default_rng(0).random((8, 8))
    np.savez(tmp_path / "solution.npz", u=u)
    ref = u + 0.1
    ref[2, 3] = np.nan
    oracle_info = {
        "reference": [None if np.isnan(v) else float(v) for v in ref.ravel()],
        "reference_shape": [8, 8],
    }
    got = metrics.compute_universal_metrics(tmp_path, oracle_info)
    assert same(got, ref_metrics.compute_universal_metrics(tmp_path, oracle_info))
    assert abs(got["rmse"] - 0.1) < 1e-12


@pytest.mark.parametrize(
    "args",
    [
        ("fix_accuracy", 1.0, 0.005, 0.01, 10.0),
        ("fix_accuracy", 1.0, 0.02, 0.01, 10.0),
        ("fix_time", 8.0, 0.005, 0.01, 10.0),
        ("fix_time", 11.0, 0.005, 0.01, 10.0),
        ("fix_time", 8.0, 0.02, 0.01, 10.0),
    ],
)
def test_scoring_matches_reference(args):
    assert same(metrics.compute_score(*args), ref_metrics.compute_score(*args))


@pytest.mark.parametrize(
    "mode,time_,error",
    [("fix_accuracy", 0.5, 1e-5), ("fix_time", 0.05, 1e-4), ("fix_accuracy", 9.0, 0.5)],
)
def test_tier_levels_match_reference(mode, time_, error):
    tiers = metrics.generate_tier_levels(1e-4, 1.0)
    assert same(tiers, ref_metrics.generate_tier_levels(1e-4, 1.0))
    assert same(metrics.check_tier_levels(mode, time_, error, tiers),
                ref_metrics.check_tier_levels(mode, time_, error, tiers))


MATH_TYPES = (
    "elliptic", "parabolic", "hyperbolic", "incompressible_flow", "mixed_type",
    "dispersive", "reaction_diffusion", "compressible_flow", "kinetic",
    "fractional", "stochastic", "multiphysics", "bogus",
)


@pytest.mark.parametrize("math_type", MATH_TYPES)
def test_specialized_computers_match_reference(tmp_path, math_type):
    u = np.random.default_rng(0).random((8, 8))
    np.savez(tmp_path / "solution.npz", u=u)
    np.savez(tmp_path / "reference.npz", reference=u + 0.01)
    (tmp_path / "meta.json").write_text(json.dumps({"solver_info": {
        "mesh_resolution": 32, "element_degree": 1, "iterations": 40,
        "dt": 0.01, "num_steps": 10}}))
    cfg = _toy_case()["oracle_config"]
    comp = metrics.get_specialized_metrics_computer(math_type, tmp_path, tmp_path, cfg)
    ref = ref_metrics.get_specialized_metrics_computer(math_type, tmp_path, tmp_path, cfg)
    if math_type == "bogus":
        assert comp is None and ref is None
        return
    got = comp.compute({"runtime_sec": 2.0})
    assert "error" not in got, got
    assert same(got, ref.compute({"runtime_sec": 2.0}))


GATE_CASES = {
    "pass": ({"success": True, "error": 1e-4, "time": 0.5}, {"target_error": 1e-3, "target_time": 1.0}),
    "accuracy": ({"success": True, "error": 1e-2, "time": 0.5}, {"target_error": 1e-3, "target_time": 1.0}),
    "time": ({"success": True, "error": 1e-4, "time": 5.0}, {"target_error": 1e-3, "target_time": 1.0}),
    "exec": ({"success": False, "error_message": "boom"}, {}),
    "time_only": ({"success": True, "error": 3.0, "time": 0.5}, {"target_error": None, "target_time": 1.0}),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_gate_analyzer_matches_reference(name):
    run, targets = GATE_CASES[name]
    got = analysis.GateAnalyzer().analyze_single_case(name, run, targets, {})
    want = ref_analysis.GateAnalyzer().analyze_single_case(name, run, targets, {})
    assert same(got.__dict__, want.__dict__)


def test_gate_statistics_match_reference():
    def stats(mod):
        ga = mod.GateAnalyzer()
        return ga.compute_aggregate_statistics(
            [ga.analyze_single_case(n, *GATE_CASES[n], {}) for n in sorted(GATE_CASES)]
        )

    got = stats(analysis)
    assert same(got, stats(ref_analysis))
    assert got["total_cases"] == len(GATE_CASES)


@pytest.mark.parametrize(
    "result",
    [
        {"status": "PASS"},
        {"status": "FAIL", "stderr": "SyntaxError: invalid syntax"},
        {"status": "FAIL", "stderr": "ModuleNotFoundError: no module named 'foo'"},
        {"status": "FAIL", "stderr": "KSP_DIVERGED_ITS: did not converge"},
        {"status": "TIMEOUT", "stderr": ""},
        {"status": "FAIL", "stderr": "AttributeError: 'X' has no attribute 'y'"},
        {"status": "FAIL", "fail_reason": "ACCURACY_FAIL", "error": 0.5, "stderr": ""},
    ],
)
def test_error_classifier_matches_reference(result):
    case = _toy_case()
    got = analysis.ErrorClassifier().classify(result, case)
    assert got == ref_analysis.ErrorClassifier().classify(result, case)


# ---------------------------------------------------------------------------
# prompts, LLM client, feedback, multi-attempt
# ---------------------------------------------------------------------------

PROMPT_CASES = ["poisson_basic", "heat_basic", "convdiff_high_pe", "wave_lshape_trig_cos",
                "poisson_3d_smooth_trig", "stokes_basic", "navier_stokes_basic",
                "poisson_circle_sinsin"]
ORACLE_INFO = {"error": 1.924806820736457e-4, "time": 0.37}


@pytest.mark.parametrize("library", ["python", "cpp"])
@pytest.mark.parametrize("case_id", PROMPT_CASES)
def test_python_and_cpp_prompts_equal_reference(case_id, library):
    (case,) = _dataset(case_id)
    for oracle_info in (ORACLE_INFO, None):
        assert core.generate_prompt(case, oracle_info, library) == ref_core.generate_prompt(
            case, oracle_info, library)


@pytest.mark.parametrize("case_id", PROMPT_CASES)
def test_torch_prompt_is_the_jax_prompt_with_the_port_guide(case_id):
    (case,) = _dataset(case_id)
    got = core.generate_prompt(case, ORACLE_INFO)  # "torch" is the default
    want = ref_core.generate_prompt(case, ORACLE_INFO, "jax")
    head, guide = got.split("\n## API Guide\n")
    ref_head, _ = want.split("\n## API Guide\n")
    assert head.replace("/torch (with pdebench_tpu_torch importable)",
                        "/jax (with pdebench_tpu importable)") == ref_head
    assert "/torch (with pdebench_tpu_torch importable)" in head
    port_guide = Path(core.prompt_builder._DOCS_DIR) / "PDEBENCH_TPU_TORCH_GUIDE.md"
    assert guide.startswith("\n" + port_guide.read_text())
    assert core.generate_prompt(case, ORACLE_INFO, "jax") != want  # the port has no jax guide


def test_supg_prompt_and_description_match_reference():
    case = _supg_case()
    for lib in ("python", "cpp"):
        assert core.generate_prompt(case, {"error": 1e-4, "time": 2.0}, lib) == (
            ref_core.generate_prompt(case, {"error": 1e-4, "time": 2.0}, lib))
    d = core.generate_nl_description(case)
    assert d == ref_core.generate_nl_description(case)
    assert "convection" in d and "dominated" in d


@pytest.mark.parametrize(
    "text",
    ["Here you go:\n```python\nprint(1)\n```\nand a note", "no fences at all",
     "```cpp\nint main(){}\n```\n```python\nx = 1\ny = 2\n```"],
)
def test_extract_code_matches_reference(text):
    assert core.extract_code(text) == ref_core.extract_code(text)


def test_llm_tables_and_mock_match_reference(monkeypatch):
    monkeypatch.delenv("PDEBENCH_MOCK_RESPONSE_FILE", raising=False)
    assert core.SUPPORTED_AGENTS == ref_core.SUPPORTED_AGENTS
    assert core.PRICING == ref_core.PRICING
    code, meta = core.call_llm("mock", "solve it")
    ref_code, ref_meta = ref_core.call_llm("mock", "solve it")
    assert code == ref_code and "def solve" in code
    assert {k: v for k, v in meta.items() if k != "latency_sec"} == {
        k: v for k, v in ref_meta.items() if k != "latency_sec"}
    with pytest.raises(llm.LLMError):
        core.call_llm("no-such-model", "x")


@pytest.mark.parametrize(
    "prev,targets",
    [
        ({"code": "x = 1", "failure_stage": "accuracy", "error": 0.5, "target_error": 1e-3},
         {"target_error": 1e-3, "target_time": 2.0}),
        ({"code": "", "failure_stage": "exec", "error_message": "boom", "stderr": "trace"}, {}),
        ({"code": "y", "failure_stage": "time", "time": 9.0, "target_time": 2.0},
         {"target_time": 2.0}),
        ({"code": "z", "failure_stage": None}, None),
    ],
)
def test_feedback_prompt_matches_reference(prev, targets):
    got = core.create_feedback_prompt("ORIGINAL TASK", prev, targets)
    assert got == ref_core.create_feedback_prompt("ORIGINAL TASK", prev, targets)
    assert "ORIGINAL TASK" in got


def test_multi_attempt_matches_reference():
    def run(mod):
        calls = []

        def generate(prompt):
            calls.append(prompt)
            return f"code{len(calls)}"

        def execute(code):
            if code == "code3":
                return {"status": "PASS", "error": 1e-5, "time": 1.0}
            return {"status": "FAIL", "error": 0.5, "failure_stage": "accuracy"}

        out = mod.run_with_attempts("task", generate, execute, max_attempts=5)
        return out, calls, mod.analyze_improvement(out["attempts"])

    got, ref = run(multi), run(ref_multi)
    assert same(got, ref)
    assert got[0]["passed"] and got[0]["best_index"] == 2 and got[2]["passed_at"] == 3


@pytest.mark.parametrize(
    "attempts",
    [
        [{"status": "FAIL", "error": 0.5}, {"status": "FAIL", "error": 0.1}],
        [{"status": "FAIL"}, {"status": "FAIL"}],
        [{"status": "PASS"}, {"status": "FAIL"}],
        [{"status": "FAIL", "error": float("nan")}, {"status": "FAIL", "error": 2.0}],
    ],
)
def test_select_best_attempt_matches_reference(attempts):
    assert multi.select_best_attempt(attempts) == ref_multi.select_best_attempt(attempts)


# ---------------------------------------------------------------------------
# agents on the mock LLM
# ---------------------------------------------------------------------------


def _agent_case():
    return {
        "id": "toy_case",
        "oracle_config": {
            "pde": {"type": "poisson", "source_term": "0"},
            "domain": {"type": "unit_square"},
            "bc": {"dirichlet": {"on": "all", "value": "0"}},
            "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 8, "ny": 8}},
        },
        "evaluation_config": {"accuracy_tolerance": 10, "time_tolerance": 3},
    }


def _agent_oracle_info():
    return {"error": 1e-4, "time": 1.0, "reference": [1.5] * 64, "reference_shape": [8, 8]}


GOOD = textwrap.dedent(
    """
    ```python
    import numpy as np
    def solve(case_spec):
        g = case_spec["output"]["grid"]
        return {"u": np.full((g["ny"], g["nx"]), 1.5), "solver_info": {
            "mesh_resolution": 8, "element_degree": 1,
            "ksp_type": "cg", "pc_type": "jacobi", "rtol": 1e-8}}
    ```
    """
)
OFFBY = GOOD.replace("1.5", "1.2")
BROKEN = "```python\ndef solve(case_spec):\n    raise RuntimeError('kaboom')\n```\n"
BAD_SHAPE = GOOD.replace('np.full((g["ny"], g["nx"]), 1.5)', "np.zeros((3, 3))")
LS_TURN = "I'll look around first.\n```bash\nls\n```\n"
WRITE_TURN = (
    "Now write the solver.\n```bash\ncat > solver.py <<'PYEOF'\n"
    "import numpy as np\ndef solve(case_spec):\n    g = case_spec['output']['grid']\n"
    "    return {'u': np.full((g['ny'], g['nx']), 1.5)}\nPYEOF\n```\n"
)
SUBMIT_TURN = "Done.\n```bash\necho SUBMIT_FINAL_ANSWER\n```\n"


@pytest.fixture
def both(tmp_path, monkeypatch):
    """Runs `fn(agents_module)` for the port and the reference, each with
    the mock LLM serving `chunks` from the start."""
    monkeypatch.delenv("PDEBENCH_TPU_PLATFORM", raising=False)

    def run(chunks, fn):
        f = tmp_path / "responses.md"
        f.write_text("\n===NEXT===\n".join(chunks))
        monkeypatch.setenv("PDEBENCH_MOCK_RESPONSE_FILE", str(f))
        out = []
        for mod, client in ((agents, llm), (ref_agents, ref_llm)):
            monkeypatch.setattr(client, "_MOCK_CALL_COUNT", 0)
            out.append(fn(mod))
        return out

    return run


def _resp(r):
    """An agent's response, its wall-clock latency left out."""
    meta = {k: v for k, v in r.metadata.items() if k != "latency_sec"}
    return r.success, r.code, r.error_message, meta


AGENT_FLOWS = {
    # codepde: broken -> bad shape -> good, the internal evaluation keeps the last
    "codepde_recovers": ((BROKEN, BAD_SHAPE, GOOD), "codepde",
                         {"num_repeated_samples": 1, "num_debugging_trials": 3}, True),
    "codepde_best_sample": ((OFFBY, GOOD), "codepde",
                            {"num_repeated_samples": 2, "num_debugging_trials": 1}, True),
    "codepde_no_oracle": ((GOOD,), "codepde",
                          {"num_repeated_samples": 2, "num_debugging_trials": 3}, False),
    "codepde_keeps_last": ((BROKEN,), "codepde",
                           {"num_repeated_samples": 1, "num_debugging_trials": 2}, True),
    "shell_writes_and_submits": ((LS_TURN, WRITE_TURN, SUBMIT_TURN), "mini-swe-agent",
                                 {"max_steps": 5}, True),
    "shell_step_budget": ((LS_TURN,), "mini-swe-agent", {"max_steps": 3}, False),
    "shell_missing_block": (("thinking out loud", WRITE_TURN, SUBMIT_TURN), "openhands",
                            {"max_steps": 5}, True),
    "fallback_disabled": ((WRITE_TURN,), "mini-swe-agent", {"native_fallback": False}, False),
    "llm_one_shot": ((GOOD,), "llm", {}, False),
}


@pytest.mark.parametrize("flow", sorted(AGENT_FLOWS))
def test_agent_flows_match_reference(both, flow):
    chunks, name, config, with_context = AGENT_FLOWS[flow]

    def go(mod):
        agent = mod.get_agent(name, {"model": "mock", "eval_timeout_sec": 60, **config})
        ctx = ({"case_spec": _agent_case(), "oracle_info": _agent_oracle_info(),
                "device": "cpu"} if with_context else None)
        return _resp(agent.generate_solution("task", ctx))

    got, ref = both(chunks, go)
    assert same(got, ref)
    if flow in ("codepde_recovers", "codepde_best_sample", "shell_writes_and_submits"):
        assert got[0] and "1.5" in got[1]


def test_registry_matches_reference():
    assert agents.AgentRegistry.names() == ref_agents.AgentRegistry.names()
    for name in ("llm", "script", "codepde", "openhands", "mini-swe-agent"):
        assert agents.AgentRegistry.is_registered(name)
    assert wrappers.ANTI_CHEAT_CONTRACT == ref_wrappers.ANTI_CHEAT_CONTRACT


def _fake_run(solver_text, stdout):
    def fake_run(cmd, cwd=None, capture_output=None, text=None, timeout=None):
        fake_run.seen = (cmd, timeout)
        if solver_text is not None:
            (Path(cwd) / "solver.py").write_text(solver_text)
        return types.SimpleNamespace(returncode=0, stdout=stdout, stderr="")

    return fake_run


@pytest.mark.parametrize(
    "solver_text,stdout",
    [("def solve(case_spec):\n    pass\n", "done"),
     (None, "```python\ndef solve(case_spec):\n    return {}\n```")],
)
def test_openhands_boundary_matches_reference(monkeypatch, solver_text, stdout):
    out = []
    for mod, wmod in ((agents, wrappers), (ref_agents, ref_wrappers)):
        fake = _fake_run(solver_text, stdout)
        monkeypatch.setattr(wmod.subprocess, "run", fake)
        monkeypatch.setattr(wmod.OpenHandsAgent, "_framework_available", lambda self: True)
        resp = mod.get_agent("openhands", {"model": "mock", "timeout_sec": 77}).generate_solution(
            "solve the PDE")
        out.append((_resp(resp), fake.seen))
    assert same(out[0], out[1])
    assert out[0][0][0] and "def solve" in out[0][0][1]
    assert out[0][1][0][:3] == ["openhands", "--headless", "-t"]


@pytest.mark.parametrize("writes", [True, False])
def test_miniswe_boundary_matches_reference(monkeypatch, writes):
    def fake_run_task(task, cwd=None):
        if writes:
            (Path(cwd) / "solver.py").write_text("def solve(case_spec):\n    pass\n")

    pkg = types.ModuleType("minisweagent")
    runmod = types.ModuleType("minisweagent.run")
    runmod.run_task = fake_run_task
    pkg.run = runmod
    monkeypatch.setitem(sys.modules, "minisweagent", pkg)
    monkeypatch.setitem(sys.modules, "minisweagent.run", runmod)
    got = _resp(agents.get_agent("mini-swe-agent", {"model": "mock"}).generate_solution("x"))
    ref = _resp(ref_agents.get_agent("mini-swe-agent", {"model": "mock"}).generate_solution("x"))
    assert same(got, ref)
    assert got[0] == writes


# ---------------------------------------------------------------------------
# the sandbox
# ---------------------------------------------------------------------------


def test_agent_view_matches_reference():
    for case in [_toy_case()] + _dataset("poisson_basic", "stokes_basic"):
        spec = executor.build_agent_case_spec(case)
        assert spec == ref_executor.build_agent_case_spec(case)
        assert "oracle_config" not in spec and "manufactured_solution" not in spec["pde"]


def test_runner_is_the_reference_runner_without_its_jax_block():
    ref = ref_executor._RUNNER_TEMPLATE
    start = ref.index("# this image pre-imports jax")
    end = ref.index("def main():")
    assert executor._RUNNER_TEMPLATE == ref[:start] + ref[end:]
    assert "jax" not in executor._RUNNER_TEMPLATE


SANDBOX_SOLVERS = {
    "roundtrip": textwrap.dedent(
        """
        import numpy as np
        def solve(case_spec):
            grid = case_spec["output"]["grid"]
            u = np.arange(grid["ny"] * grid["nx"], dtype=float).reshape(grid["ny"], grid["nx"])
            return {"u": u, "solver_info": {
                "mesh_resolution": 32, "element_degree": 1,
                "ksp_type": "cg", "pc_type": "jacobi", "rtol": 1e-8}}
        """
    ),
    "bad_shape": (
        "import numpy as np\n"
        "def solve(c):\n"
        "    return {'u': np.zeros((3, 3)), 'solver_info': {"
        "'mesh_resolution': 1, 'element_degree': 1, 'ksp_type': 'cg',"
        "'pc_type': 'none', 'rtol': 1e-8}}\n"
    ),
    "missing_solver_info": (
        "import numpy as np\n"
        "def solve(c):\n"
        "    return {'u': np.zeros((8, 8)), 'solver_info': {}}\n"
    ),
}


@pytest.mark.parametrize("name", sorted(SANDBOX_SOLVERS))
def test_execute_agent_function_matches_reference(tmp_path, monkeypatch, name):
    monkeypatch.delenv("PDEBENCH_TPU_PLATFORM", raising=False)
    solver = tmp_path / "solver.py"
    solver.write_text(SANDBOX_SOLVERS[name])
    out = {}
    for tag, fn in (("port", sandbox.execute_agent_function),
                    ("ref", ref_sandbox.execute_agent_function)):
        r = fn(str(solver), str(tmp_path / tag), _toy_case(), timeout_sec=60)
        sol = tmp_path / tag / "solution.npz"
        out[tag] = (r.success, r.error_message, r.returncode,
                    np.load(sol)["u"] if sol.exists() else None)
    assert same(out["port"], out["ref"])
    assert out["port"][0] == (name == "roundtrip")


def test_sandbox_names_the_device(tmp_path, monkeypatch):
    """The agent's process reads the device in DEVICE_ENV: the caller's,
    else the environment's, else "cuda"."""
    solver = tmp_path / "solver.py"
    solver.write_text(
        "import os\nimport numpy as np\n"
        "def solve(c):\n"
        "    g = c['output']['grid']\n"
        "    return {'u': np.zeros((g['ny'], g['nx'])), 'solver_info': {"
        "'mesh_resolution': 1, 'element_degree': 1, 'ksp_type': 'cg',"
        "'pc_type': os.environ['PDEBENCH_TORCH_DEVICE'], 'rtol': 1e-8}}\n"
    )
    assert executor.DEVICE_ENV == "PDEBENCH_TORCH_DEVICE"

    def seen(**kw):
        out = tmp_path / f"o{len(list(tmp_path.iterdir()))}"
        r = sandbox.execute_agent_function(str(solver), str(out), _toy_case(), 60, **kw)
        assert r.success, r.error_message
        return json.loads((out / "meta.json").read_text())["solver_info"]["pc_type"]

    monkeypatch.delenv(executor.DEVICE_ENV, raising=False)
    assert seen() == "cuda"
    assert seen(device="cpu") == "cpu"
    monkeypatch.setenv(executor.DEVICE_ENV, "cuda:1")
    assert seen() == "cuda:1"
    assert seen(device="cpu") == "cpu"


CPP_OK = r"""
#include "pdebench_json.hpp"
#include <cstdio>
#include <string>
#include <vector>
int main(int argc, char** argv) {
    auto spec = pdebench::json::parse_file(argv[1]);
    auto& grid = spec["output"]["grid"];
    long nx = grid["nx"].int_or(0), ny = grid["ny"].int_or(0);
    std::vector<double> u(nx * ny, 1.5);
    std::string out = std::string(argv[2]) + "/solution_grid.bin";
    FILE* f = fopen(out.c_str(), "wb");
    fwrite(u.data(), sizeof(double), u.size(), f);
    fclose(f);
    FILE* m = fopen((std::string(argv[2]) + "/meta.json").c_str(), "w");
    fprintf(m, "{\"nx\": %ld, \"ny\": %ld, \"baseline_time\": 0.01}", nx, ny);
    fclose(m);
    return 0;
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("code", [CPP_OK, "int main( {"], ids=["roundtrip", "compile_error"])
def test_cpp_executor_matches_reference(tmp_path, code):
    out = {}
    for tag, cls in (("port", sandbox.CppExecutor), ("ref", ref_sandbox.CppExecutor)):
        ex = cls(build_dir=str(tmp_path / tag / "build"))
        r = ex.execute(code, _toy_case(), str(tmp_path / tag / "out"), timeout_sec=120)
        sol = tmp_path / tag / "out" / "solution.npz"
        out[tag] = (r.success, r.error_message.split("\n")[0], r.t_agent_run if r.success else 0,
                    np.load(sol)["u"] if sol.exists() else None)
        if r.success:
            assert ex.build(code)["cached"]
    assert same(out["port"], out["ref"])
    assert out["port"][0] == (code == CPP_OK)
