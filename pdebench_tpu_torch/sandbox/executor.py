"""Python-solver sandbox: run agent-generated `solve(case_spec)` code in
an isolated subprocess and validate its outputs.

Behavioral parity (reference: pdebench/sandbox/executor.py:21-537):
  - agents see a SANITIZED case view: oracle discretization hints
    (mesh, fem, oracle_solver) and the manufactured solution are
    stripped (:222-262)
  - the child runs a generated _runner.py that imports the agent
    module, calls solve(case_spec) (or solve_case), and writes
    solution.npz + u.npy + meta.json into outdir (:283-413)
  - solver_info MUST contain [mesh_resolution, element_degree,
    ksp_type, pc_type, rtol] (:331-334)
  - output shape must be exactly (ny, nx) / (nz, ny, nx); no
    interpolation is performed (:363-372)
  - LENIENT SUCCESS: a nonzero exit with valid output files still
    counts (solver-library teardown crashes, :497-517)
  - timing split: t_agent_run vs t_validation on the result

Isolation is subprocess-level; the use_docker/docker_image args are
accepted for interface parity (this harness runs bare, the reference
used containers for its Firedrake/deal.II stacks).

Copy of pdebench_tpu/sandbox/executor.py, with two changes: the
generated runner sets no JAX platform, and the agent's process is told
the device the harness runs on through DEVICE_ENV (PDEBENCH_TORCH_DEVICE;
"cuda" when neither the caller nor the environment names one), where the
"torch" library's solvers put their tensors.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

REQUIRED_SOLVER_INFO_KEYS = [
    "mesh_resolution",
    "element_degree",
    "ksp_type",
    "pc_type",
    "rtol",
]

_STRIPPED_KEYS = ("mesh", "fem", "oracle_solver", "reference_config")

# the device an agent's solver runs on ("cuda", "cpu", ...), read by the
# "torch" library's solvers (docs/PDEBENCH_TPU_TORCH_GUIDE.md)
DEVICE_ENV = "PDEBENCH_TORCH_DEVICE"


def agent_device(device: Optional[str] = None) -> str:
    """The device named by the caller, else by DEVICE_ENV, else "cuda"."""
    return device or os.environ.get(DEVICE_ENV) or "cuda"


@dataclass
class ExecutionResult:
    success: bool
    error_message: str = ""
    stdout: str = ""
    stderr: str = ""
    returncode: int = 0
    t_agent_run: float = 0.0
    t_validation: float = 0.0
    outputs: Dict[str, Any] = field(default_factory=dict)

    @property
    def time(self) -> float:
        return self.t_agent_run


_PDE_HIDDEN_KEYS = ("manufactured_solution", "manufactured_u",
                    "exact_solution")


def build_agent_case_spec(case_spec: Dict[str, Any]) -> Dict[str, Any]:
    """Sanitized agent view of the case (reference :222-262).

    The reference FLATTENS the spec the agent's solve() receives: pde /
    domain / bc / output appear top-level (executor.py:253-262), with
    the oracle's own discretization (mesh/fem/oracle_solver) and every
    exact-solution field hidden.
    """
    spec = copy.deepcopy(case_spec)
    oc = spec.get("oracle_config", spec)
    pde = {
        k: v
        for k, v in oc.get("pde", {}).items()
        if k not in _PDE_HIDDEN_KEYS
    }
    knobs = [
        k
        for k in spec.get("agent_knobs", [])
        if k.get("name") not in _PDE_HIDDEN_KEYS
    ]
    return {
        "id": spec.get("id", ""),
        "pde_classification": spec.get("pde_classification", {}),
        "pde": pde,
        "domain": oc.get("domain", {"type": "unit_square"}),
        "bc": oc.get("bc", {}),
        "output": oc.get("output", {}),
        "agent_knobs": knobs,
        "evaluation_config": spec.get("evaluation_config", {}),
    }


_RUNNER_TEMPLATE = '''\
"""Generated sandbox runner (do not edit)."""
import importlib.util
import json
import os
import sys
import time
import numpy as np

def main():
    script_path, case_path, outdir = sys.argv[1], sys.argv[2], sys.argv[3]
    with open(case_path) as f:
        case_spec = json.load(f)

    spec = importlib.util.spec_from_file_location("agent_solver", script_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    solve = getattr(mod, "solve", None) or getattr(mod, "solve_case", None)
    if solve is None:
        print("AGENT_ERROR: no solve(case_spec) function found", file=sys.stderr)
        sys.exit(3)

    t0 = time.time()
    result = solve(case_spec)
    t_run = time.time() - t0

    if not isinstance(result, dict) or "u" not in result:
        print("AGENT_ERROR: solve() must return {'u': ndarray, 'solver_info': {...}}",
              file=sys.stderr)
        sys.exit(4)

    u = np.asarray(result["u"], dtype=np.float64)
    solver_info = result.get("solver_info", {})
    missing = [k for k in %(required)s if k not in solver_info]
    if missing:
        print("AGENT_ERROR: solver_info missing required keys: " + ", ".join(missing),
              file=sys.stderr)
        sys.exit(5)

    grid = case_spec.get("oracle_config", case_spec)["output"]["grid"]
    ny, nx = int(grid["ny"]), int(grid["nx"])
    expected = (int(grid["nz"]), ny, nx) if grid.get("nz") else (ny, nx)
    if tuple(u.shape) != expected:
        print(f"AGENT_ERROR: output shape {u.shape} != required {expected} "
              "(return the exact grid; do not interpolate)", file=sys.stderr)
        sys.exit(6)

    np.savez(outdir + "/solution.npz", u=u)
    np.save(outdir + "/u.npy", u)
    if "u_initial" in result:
        np.save(outdir + "/u_initial.npy",
                np.asarray(result["u_initial"], dtype=np.float64))
    with open(outdir + "/meta.json", "w") as f:
        json.dump({"solver_info": solver_info, "t_run": t_run}, f, default=str)

if __name__ == "__main__":
    main()
'''


def _outputs_valid(outdir: Path, case_spec: Dict[str, Any]) -> Optional[str]:
    """Validate output files; returns error message or None."""
    sol = outdir / "solution.npz"
    if not sol.exists():
        return "solution.npz not written"
    try:
        u = np.load(sol)["u"]
    except Exception as e:
        return f"solution.npz unreadable: {e}"
    grid = case_spec.get("oracle_config", case_spec)["output"]["grid"]
    ny, nx = int(grid["ny"]), int(grid["nx"])
    expected = (int(grid["nz"]), ny, nx) if grid.get("nz") else (ny, nx)
    if tuple(u.shape) != expected:
        return f"output shape {u.shape} != required {expected}"
    meta = outdir / "meta.json"
    if meta.exists():
        try:
            info = json.load(open(meta)).get("solver_info", {})
            missing = [k for k in REQUIRED_SOLVER_INFO_KEYS if k not in info]
            if missing:
                return f"solver_info missing keys: {missing}"
        except Exception as e:
            return f"meta.json unreadable: {e}"
    return None


def execute_agent_function(
    script_path: str,
    outdir: str,
    case_spec: Dict[str, Any],
    timeout_sec: float = 300.0,
    use_docker: bool = False,
    docker_image: Optional[str] = None,
    python_exe: Optional[str] = None,
    device: Optional[str] = None,
) -> ExecutionResult:
    """Run an agent solver script against a sanitized case in a subprocess,
    its DEVICE_ENV set to agent_device(device)."""
    del use_docker, docker_image  # interface parity; bare subprocess isolation
    outdir_p = Path(outdir)
    outdir_p.mkdir(parents=True, exist_ok=True)
    agent_spec = build_agent_case_spec(case_spec)

    with tempfile.TemporaryDirectory() as tmp:
        case_path = Path(tmp) / "case_spec.json"
        runner_path = Path(tmp) / "_runner.py"
        case_path.write_text(json.dumps(agent_spec))
        runner_path.write_text(
            _RUNNER_TEMPLATE % {"required": repr(REQUIRED_SOLVER_INFO_KEYS)}
        )

        cmd = [
            python_exe or sys.executable,
            str(runner_path),
            str(script_path),
            str(case_path),
            str(outdir_p),
        ]
        # the torch solver-library contract promises `pdebench_tpu_torch`
        # is importable inside the sandbox, and names the device
        env = dict(os.environ)
        env[DEVICE_ENV] = agent_device(device)
        repo_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = (
            repo_root + os.pathsep + env.get("PYTHONPATH", "")
        ).rstrip(os.pathsep)
        t0 = time.time()
        try:
            proc = subprocess.run(
                cmd,
                capture_output=True,
                text=True,
                timeout=timeout_sec,
                cwd=tmp,
                env=env,
            )
        except subprocess.TimeoutExpired as e:
            return ExecutionResult(
                success=False,
                error_message=f"timeout after {timeout_sec}s",
                stdout=(e.stdout or b"").decode() if isinstance(e.stdout, bytes) else (e.stdout or ""),
                stderr="TimeoutExpired",
                returncode=-9,
                t_agent_run=time.time() - t0,
            )
        t_run = time.time() - t0

    t1 = time.time()
    problem = _outputs_valid(outdir_p, case_spec)
    t_val = time.time() - t1

    # agent-measured solve time (excludes interpreter startup) if present
    meta = outdir_p / "meta.json"
    if meta.exists():
        try:
            t_run = float(json.load(open(meta)).get("t_run", t_run))
        except Exception:
            pass

    if problem is None:
        # lenient success: valid outputs count even on nonzero exit
        # (reference :497-517, MUMPS/OpenBLAS teardown crashes)
        return ExecutionResult(
            success=True,
            stdout=proc.stdout,
            stderr=proc.stderr,
            returncode=proc.returncode,
            t_agent_run=t_run,
            t_validation=t_val,
        )
    msg = problem if proc.returncode == 0 else (
        proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else problem
    )
    return ExecutionResult(
        success=False,
        error_message=msg,
        stdout=proc.stdout,
        stderr=proc.stderr,
        returncode=proc.returncode,
        t_agent_run=t_run,
        t_validation=t_val,
    )
