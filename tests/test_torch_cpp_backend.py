"""The port's native (C++) oracle backend against the JAX package's:
`OracleSolver(device=...).solve(cfg, "cpp")` on the same configs gives the
reference's grid, array-equal, and its baseline_error.

Both packages run the same native/ binaries. The port builds them into
build/pdebench_tpu_torch/native/; the reference's `ensure_built` (make into
native/build/, which tests/test_cpp_backend.py drives in another test
process) is pointed at the port's build here, so no two processes run
make on the same targets."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdebench_tpu.oracle import OracleSolver as RefOracle
from pdebench_tpu.oracle import cpp_backend as ref_cpp
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.oracle import cpp_backend

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

# one intra-op thread: the suite runs several test processes on a few cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MMS_U = "sin(pi*x)*sin(pi*y)"


def _cfg(pde, **kw):
    base = {
        "pde": pde,
        "domain": {"type": "unit_square"},
        "mesh": {"resolution": 48},
        "fem": {"family": "Lagrange", "degree": 1},
        "bc": {"dirichlet": {"on": "all", "value": "0"}},
        "output": {"grid": {"bbox": [0, 1, 0, 1], "nx": 40, "ny": 40}},
        "oracle_solver": {"ksp_type": "cg", "pc_type": "jacobi", "rtol": 1e-10},
    }
    base.update(kw)
    return base


CONFIGS = {
    "poisson_unit_square": _cfg({"type": "poisson", "manufactured_solution": {"u": MMS_U}}),
    "poisson_l_shape": _cfg({"type": "poisson", "manufactured_solution": {"u": MMS_U}},
                            domain={"type": "l_shape"}),
    "heat_unit_square": _cfg({"type": "heat", "time": {"t0": 0.0, "t_end": 0.1, "dt": 0.01},
                              "manufactured_solution": {"u": "exp(-t)*" + MMS_U}}),
    "stokes_taylor_hood": _cfg(
        {"type": "stokes", "pde_params": {"nu": 1.0},
         "manufactured_solution": {
             "u": ["pi*cos(pi*y)*sin(pi*x)", "-pi*cos(pi*x)*sin(pi*y)"],
             "p": "cos(pi*x)*cos(pi*y)"}},
        mesh={"resolution": 12}, fem={"degree_u": 2, "degree_p": 1},
        oracle_solver={"ksp_type": "minres", "pc_type": "hypre", "rtol": 1e-10,
                       "pressure_fixing": "point"}),
}
ERR_BOUND = {"poisson_unit_square": 2e-3, "poisson_l_shape": 5e-3, "heat_unit_square": 5e-3,
             "stokes_taylor_hood": 2e-3}


@pytest.fixture(autouse=True)
def _reference_uses_the_port_build(monkeypatch):
    monkeypatch.setattr(ref_cpp, "ensure_built", cpp_backend.ensure_built)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cpp_grid_equals_reference(name):
    res = OracleSolver(device="cpu").solve(CONFIGS[name], "cpp")
    ref = RefOracle().solve(CONFIGS[name], solver_library="cpp")
    assert np.array_equal(res.reference, ref.reference, equal_nan=True)
    assert res.baseline_error == ref.baseline_error
    assert res.num_dofs == ref.num_dofs
    assert res.solver_info == ref.solver_info
    assert res.solver_info["library"] == "pdebench_tpu_native"
    assert res.baseline_error < ERR_BOUND[name]
    assert np.isfinite(res.reference).any()


def test_cpp_builds_outside_the_reference_build():
    binary = cpp_backend.ensure_built("stokes")
    build = ROOT / "build" / "pdebench_tpu_torch" / "native"
    assert binary == build / "system_solver" and binary.is_file()
    assert (build / "scalar_solver").is_file() and (build / ".make.lock").is_file()
    assert ROOT / "native" not in binary.parents


def test_cpp_unsupported_raises_as_reference():
    cfg = _cfg({"type": "poisson", "manufactured_solution": {"u": MMS_U}},
               domain={"type": "cylinder_shell"})
    for solver in (OracleSolver(device="cpu"), RefOracle()):
        with pytest.raises(NotImplementedError):
            solver.solve(cfg, "cpp")


def test_reference_signature_arguments():
    """The reference's call shapes: positional library, and the docker
    arguments (accepted, unused)."""
    cfg = CONFIGS["poisson_unit_square"]
    a = OracleSolver(device="cpu").solve(cfg, "cpp")
    b = OracleSolver(device="cpu").solve(cfg, solver_library="cpp", use_docker=True,
                                         docker_image="unused")
    assert np.array_equal(a.reference, b.reference)


def test_runner_cli_cpp(tmp_path):
    cfg = CONFIGS["poisson_l_shape"]
    spec = tmp_path / "case.json"
    spec.write_text(json.dumps({"oracle_config": cfg}))
    proc = subprocess.run(
        [sys.executable, "-m", "pdebench_tpu_torch.oracle.runner", str(spec),
         str(tmp_path / "out"), "cpp", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    meta = json.loads((tmp_path / "out" / "meta.json").read_text())
    res = OracleSolver(device="cpu").solve(cfg, "cpp")
    assert meta["success"] and meta["baseline_error"] == res.baseline_error
    assert np.array_equal(np.load(tmp_path / "out" / "reference.npy"), res.reference,
                          equal_nan=True)
