"""The port's benchmark drivers, scripts/torch_run_benchmark.py and
scripts/torch_test_oracle_cases.py, against the JAX package's
scripts/run_benchmark.py on the CPU: gating, errors and attempt selection
equal the reference's; the case filter selects the dataset's cases under
"torch"; the oracle cache is a path the JAX driver never writes; the
torch guide's worked examples pass through the port's sandbox; a
mock-agent round trip on poisson_basic passes the accuracy gate, its
oracle grid held to the reference's oracle; the driver runs to its
summary with jax and pdebench_tpu blocked from import; the runner CLI."""

import copy
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu_torch.fem import sampling, symbolic
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.sandbox.executor import execute_agent_function

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
GUIDE = ROOT / "pdebench_tpu_torch" / "docs" / "PDEBENCH_TPU_TORCH_GUIDE.md"
GRID_TOL = 1e-8  # relative L2 between the packages' grids (test_torch_poisson.py)
ERR_TOL = 1e-6  # relative difference of baseline_error (test_torch_poisson.py)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tb = _load("torch_rb", ROOT / "scripts" / "torch_run_benchmark.py")
rb = _load("rb_reference", ROOT / "scripts" / "run_benchmark.py")


def _case(case_id):
    for c in tb.load_benchmark_cases(ROOT / "data" / "benchmark_v2.jsonl", [case_id]):
        return c
    raise KeyError(case_id)


def _guide_solvers():
    blocks = re.findall(r"```python\n(.*?)```", GUIDE.read_text(), flags=re.S)
    return [b for b in blocks if "def solve(case_spec)" in b and "import" in b]


def _exact_grid(oracle_config):
    grid = oracle_config["output"]["grid"]
    pts, shape = sampling.grid_points(grid)
    t_end = oracle_config["pde"].get("time", {}).get("t_end")
    fn = symbolic.lambdify_numpy(oracle_config["pde"]["manufactured_solution"]["u"],
                                 3 if grid.get("nz") else 2, with_time=t_end is not None)
    return (fn(pts, t_end) if t_end is not None else fn(pts)).reshape(shape)


def _rel_l2(a, b):
    m = np.isfinite(a) & np.isfinite(b)
    return float(np.linalg.norm((a - b)[m]) / np.linalg.norm(b[m]))


@pytest.fixture(scope="module")
def reference_poisson_basic():
    """The JAX package's oracle on poisson_basic, once for the module."""
    return RefOracle().solve(copy.deepcopy(_case("poisson_basic")["oracle_config"]))


# ---------------------------------------------------------------------------
# the driver's functions against the reference's
# ---------------------------------------------------------------------------

GATES = [
    (5e-4, 2.0, {"error": 1e-4, "time": 1.0}, {"accuracy_tolerance": 10, "time_tolerance": 3}),
    (1e-2, 99.0, {"error": 1e-4, "time": 1.0}, {"accuracy_tolerance": 10, "time_tolerance": 3}),
    (5e-4, 99.0, {"error": 1e-4, "time": 1.0}, {"accuracy_tolerance": 10, "time_tolerance": 3}),
    (float("nan"), 1.0, {"error": 1e-4, "time": 1.0}, {"accuracy_tolerance": 10}),
    (None, 1.0, {"error": 1e-4, "time": 1.0}, {"accuracy_tolerance": 10}),
    (5e-7, 1.0, {"error": 1e-12, "time": 1.0}, {"accuracy_tolerance": 10, "time_tolerance": 3}),
    (123.0, 2.0, {"error": 0.0, "time": 1.0}, {"time_tolerance": 3}),
    (1e-5, None, {"error": 1e-4, "time": 1.0}, {"accuracy_tolerance": 10}),
]


@pytest.mark.parametrize("args", GATES)
def test_gate_matches_reference(args):
    assert tb.gate(*args) == rb.gate(*args)
    assert tb.MIN_ERROR_THRESHOLD == rb.MIN_ERROR_THRESHOLD


@pytest.mark.parametrize("kind", ["nan_masked", "strict_shape", "zero_reference", "missing"])
def test_compute_error_matches_reference(tmp_path, kind):
    ref = np.random.default_rng(0).random((6, 6))
    ref[0, 0] = np.nan
    u = ref.copy()
    u[3, 3] += 0.1
    if kind == "strict_shape":
        u = np.zeros((5, 5))
    if kind == "zero_reference":
        ref = np.zeros((6, 6))
    if kind != "missing":
        np.savez(tmp_path / "solution.npz", u=u)
    info = {"reference": [None if np.isnan(v) else float(v) for v in ref.ravel()],
            "reference_shape": [6, 6]}
    got = tb.compute_error(tmp_path, info)
    assert got == rb.compute_error(tmp_path, info)
    if kind == "nan_masked":
        m = ~np.isnan(ref)
        assert got == pytest.approx(0.1 / np.linalg.norm(ref[m]))


@pytest.mark.parametrize(
    "attempts",
    [
        [{"status": "FAIL", "error": 0.9}, {"status": "PASS", "error": 0.1}],
        [{"status": "FAIL", "error": 0.2}, {"status": "FAIL", "error": 0.05}],
        [{"status": "LLM_ERROR"}, {"status": "LLM_ERROR"}],
    ],
)
def test_select_best_attempt_matches_reference(attempts):
    assert tb._select_best_attempt(attempts) == rb._select_best_attempt(attempts)


def test_summary_matches_reference():
    results = [
        {"status": "PASS", "equation_type": "poisson", "math_type": ["elliptic"],
         "cost_usd": 0.5, "n_attempts": 2, "best_attempt": 2,
         "gate_breakdown": {"case_id": "a", "exec_valid": True, "accuracy_pass": True,
                            "time_pass": True, "final_pass": True}},
        {"status": "FAIL", "equation_type": "heat", "math_type": ["parabolic"],
         "error_class": "timeout", "n_attempts": 1},
    ]
    assert tb.compute_summary(results, "mock") == rb.compute_summary(results, "mock")


def test_case_filter_selects_the_dataset_under_every_library():
    data = ROOT / "data" / "benchmark_v2.jsonl"
    every = tb.load_benchmark_cases(data)
    assert len(every) == 645
    for lib in tb.SOLVER_LIBRARIES:
        assert len(tb.load_benchmark_cases(data, solver_library=lib)) == 645
    got = tb.load_benchmark_cases(data, ["poisson_basic"], ["poisson"], "torch")
    assert [c["id"] for c in got] == ["poisson_basic"]
    # the reference's filter knows no "torch": the trap the twin avoids
    assert rb.load_benchmark_cases(data, ["poisson_basic"], None, "torch") == []


@pytest.mark.parametrize("library", ["torch", "python", "cpp", "jax"])
@pytest.mark.parametrize("device", ["cuda", "cpu", "cuda:1"])
def test_oracle_cache_is_never_the_reference_drivers(tmp_path, library, device):
    ours = tb.oracle_cache_dir(tmp_path, library, device)
    assert tmp_path / ".oracle_cache" not in ours.parents
    assert ours.parent.parent == tmp_path / ".torch_oracle_cache"
    assert ours != tb.oracle_cache_dir(tmp_path, library, "cpu" if device != "cpu" else "cuda")


def test_oracle_cache_roundtrip(tmp_path):
    case = {
        "id": "cache_case",
        "oracle_config": {
            "pde": {"type": "poisson", "manufactured_solution": {"u": "sin(pi*x)*sin(pi*y)"}},
            "domain": {"type": "unit_square"},
            "mesh": {"resolution": 12},
            "fem": {"degree": 1},
            "bc": {"dirichlet": {"on": "all", "value": "0"}},
            "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 8, "ny": 8}},
            "oracle_solver": {"ksp_type": "cg", "pc_type": "jacobi", "rtol": 1e-9},
        },
    }
    info1 = tb.run_oracle(case, tmp_path, device="cpu")
    path = tmp_path / ".torch_oracle_cache" / "torch" / "cpu" / "cache_case.json"
    assert path.exists()
    info2 = tb.run_oracle(case, tmp_path, device="cpu")  # cache hit
    assert info2["reference"] == info1["reference"] and info2["error"] == info1["error"]
    ref = rb.run_oracle(case, tmp_path)
    assert (tmp_path / ".oracle_cache" / "jax" / "cache_case.json").exists()
    grid = np.asarray(info1["reference"], dtype=float)
    assert _rel_l2(grid, np.asarray(ref["reference"], dtype=float)) < GRID_TOL
    assert abs(info1["error"] - ref["error"]) <= ERR_TOL * ref["error"]


def test_oracle_failure_gives_the_reference_sentinel(tmp_path, capsys):
    case = {"id": "bad", "oracle_config": {"pde": {"type": "no_such_pde"}}}
    assert tb.run_oracle(case, tmp_path, device="cpu") == rb.run_oracle(case, tmp_path)
    assert tb.run_oracle(case, tmp_path, device="cpu") == {
        "error": 1e-2, "time": 10.0, "reference": None}
    assert "oracle FAILED for bad" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the torch guide's worked examples, the round trip, the blocked driver
# ---------------------------------------------------------------------------


def test_guide_has_full_examples():
    assert len(_guide_solvers()) >= 2
    text = GUIDE.read_text()
    for key in ("mesh_resolution", "element_degree", "ksp_type", "pc_type", "rtol",
                "PDEBENCH_TORCH_DEVICE"):
        assert key in text


@pytest.mark.parametrize(
    "marker,case_id,tol",
    [("local_stiffness(cb, kappa_q)", "poisson_basic", 2e-3),
     ("backward Euler LHS", "heat_basic", 5e-3)],
)
def test_guide_example_through_sandbox(tmp_path, marker, case_id, tol):
    code = next(b for b in _guide_solvers() if marker in b)
    (tmp_path / "solver.py").write_text(code)
    config = _case(case_id)["oracle_config"]
    er = execute_agent_function(str(tmp_path / "solver.py"), str(tmp_path / "out"), config,
                                timeout_sec=600, device="cpu")
    assert er.success, f"{er.error_message}\n{er.stderr[-2000:]}"
    u = np.load(tmp_path / "out" / "solution.npz")["u"]
    assert _rel_l2(u, _exact_grid(config)) < tol
    info = json.loads((tmp_path / "out" / "meta.json").read_text())["solver_info"]
    for key in ("mesh_resolution", "element_degree", "ksp_type", "pc_type", "rtol"):
        assert key in info


def test_mock_agent_roundtrip_on_poisson_basic(tmp_path, monkeypatch, reference_poisson_basic):
    code = next(b for b in _guide_solvers() if "local_stiffness(cb, kappa_q)" in b)
    resp = tmp_path / "resp.md"
    resp.write_text("```python\n" + code + "```\n")
    monkeypatch.setenv("PDEBENCH_MOCK_RESPONSE_FILE", str(resp))
    results = tmp_path / "results"
    result = tb.run_single_case(_case("poisson_basic"), "mock", None, results, "torch",
                                timeout_sec=600, device="cpu")
    assert result["gate_breakdown"]["exec_valid"], result.get("error_message")
    # the time gate compares a cold CPU sandbox run against the warm
    # oracle: not asserted here
    assert result["fail_reason"] not in ("ACCURACY_FAIL", "INVALID_ERROR")
    assert result["error"] is not None and result["error"] <= result["target_error"]
    case_dir = results / "mock" / "poisson_basic"
    for name in ("prompt.md", "solver.py", "result.json", "oracle_output/reference.npz"):
        assert (case_dir / name).exists(), name
    assert "PDEBENCH_TORCH_DEVICE" in (case_dir / "prompt.md").read_text()
    cached = json.loads((results / ".torch_oracle_cache" / "torch" / "cpu"
                         / "poisson_basic.json").read_text())
    ref = reference_poisson_basic
    grid = np.asarray(cached["reference"], dtype=float).reshape(cached["reference_shape"])
    assert grid.shape == ref.reference.shape
    assert _rel_l2(grid, ref.reference) < GRID_TOL
    assert abs(cached["error"] - ref.baseline_error) <= ERR_TOL * ref.baseline_error
    assert not (results / ".oracle_cache").exists()


_BLOCKED = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["pdebench_tpu"] = None
sys.argv = ["torch_run_benchmark.py", "--agents", "mock", "--cases", "poisson_basic",
            "--device", "cpu", "--results-dir", sys.argv[1]]
runpy.run_path({script!r}, run_name="__main__")
leaked = sorted(m for m, v in sys.modules.items() if v is not None
                and (m.split(".")[0] in ("jax", "jaxlib", "pdebench_tpu")))
assert not leaked, leaked
print("NO_JAX_IMPORTED")
"""


def test_driver_runs_with_jax_and_the_reference_blocked(tmp_path):
    script = str(ROOT / "scripts" / "torch_run_benchmark.py")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(script=script), str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded 1 cases" in proc.stdout
    assert "=== mock ===" in proc.stdout and "NO_JAX_IMPORTED" in proc.stdout
    summary = json.loads((tmp_path / "mock" / "summary.json").read_text())
    assert summary["total_cases"] == 1
    assert summary["gate_statistics"]["exec_valid_rate"] == 1.0
    assert (tmp_path / "all_results.json").exists()
    assert (tmp_path / ".torch_oracle_cache" / "torch" / "cpu" / "poisson_basic.json").exists()


def test_oracle_case_sweep_script(capsys):
    toc = _load("torch_toc", ROOT / "scripts" / "torch_test_oracle_cases.py")
    assert toc.main(["--cases", "poisson_basic", "--device", "cpu"]) == 0
    assert "1/1 oracles valid" in capsys.readouterr().out


TINY = {
    "pde": {"type": "poisson", "manufactured_solution": {"u": "sin(pi*x)*sin(pi*y)"}},
    "domain": {"type": "unit_square"},
    "mesh": {"resolution": 16},
    "fem": {"degree": 1},
    "bc": {"dirichlet": {"on": "all", "value": "0"}},
    "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 12, "ny": 12}},
    "oracle_solver": {"ksp_type": "cg", "pc_type": "jacobi", "rtol": 1e-9},
}


@pytest.mark.parametrize("spec", [TINY, {"pde": {"type": "no_such_pde"}}], ids=["ok", "fails"])
def test_oracle_runner_cli(tmp_path, spec):
    (tmp_path / "case.json").write_text(json.dumps(spec))
    proc = subprocess.run(
        [sys.executable, "-m", "pdebench_tpu_torch.oracle.runner", str(tmp_path / "case.json"),
         str(tmp_path / "out"), "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    meta = json.loads((tmp_path / "out" / "meta.json").read_text())
    if spec is not TINY:
        assert proc.returncode == 1 and not meta["success"]
        assert meta["error"].startswith("ValueError")
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    grid = np.load(tmp_path / "out" / "reference.npy")
    res = OracleSolver(device="cpu").solve(copy.deepcopy(TINY))
    assert np.array_equal(grid, res.reference)
    assert meta["success"] and meta["baseline_error"] == res.baseline_error < 5e-2
    ref = RefOracle().solve(copy.deepcopy(TINY))
    assert _rel_l2(grid, ref.reference) < GRID_TOL
