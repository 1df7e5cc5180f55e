"""C++ agent sandbox: compile agent-written solver C++ and run it under
the binary contract `<solver> <case_spec.json> <outdir>`.

Behavioral parity (reference: pdebench/sandbox/cpp_executor.py): shared
build directory with content-hash caching (SHA256 of toolchain flags +
source, :250-296), thread-safe configure/compile locks (:204-205),
markdown-fence stripping (:159-179), compile-error extraction
(:144-156), and output normalization accepting either `solution.npz`
or `solution_grid.bin` + `meta.json` (:540-627 — raw float64 C-order
(ny, nx) / (nz, ny, nx)).

Differences by design: the reference compiled against deal.II through a
generated CMake project inside a Docker image; this sandbox compiles
hermetic C++17 binaries directly with g++ against the repo's vendored
headers (native/include, e.g. pdebench_json.hpp) — no containers, no
external libraries.

Copy of pdebench_tpu/sandbox/cpp_executor.py; the default build
directory is build/pdebench_tpu_torch/cpp_agent/ (git-ignored).
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from .executor import ExecutionResult, build_agent_case_spec

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_INCLUDE = _REPO_ROOT / "native" / "include"

_CXX = "g++"
_CXXFLAGS = ["-O2", "-std=c++17", "-march=native"]


def _sanitize_cpp_code(code: str) -> str:
    """Strip markdown fences an LLM may wrap around the source."""
    text = code.strip()
    m = re.search(r"```(?:cpp|c\+\+|cxx)?\s*\n(.*?)```", text, re.DOTALL)
    if m:
        return m.group(1)
    if text.startswith("```"):
        text = text.split("\n", 1)[-1]
    if text.endswith("```"):
        text = text.rsplit("```", 1)[0]
    return text


def _extract_compile_errors(stderr: str, max_lines: int = 30) -> str:
    lines = [
        l
        for l in stderr.splitlines()
        if "error:" in l or "undefined reference" in l
    ]
    return "\n".join(lines[:max_lines]) if lines else stderr[-2000:]


class CppExecutor:
    """Compile-and-run sandbox for agent C++ solvers, with build caching."""

    _compile_lock = threading.Lock()

    def __init__(
        self,
        docker_image: Optional[str] = None,
        build_dir: Optional[str] = None,
    ):
        del docker_image  # interface parity; no containers needed
        self.build_dir = Path(
            build_dir or (_REPO_ROOT / "build" / "pdebench_tpu_torch" / "cpp_agent")
        )
        self.build_dir.mkdir(parents=True, exist_ok=True)

    # -- build ------------------------------------------------------------

    def _content_hash(self, source: str) -> str:
        h = hashlib.sha256()
        h.update(" ".join([_CXX] + _CXXFLAGS).encode())
        h.update(source.encode())
        return h.hexdigest()[:24]

    def build(self, solver_cpp: str) -> Dict[str, Any]:
        """Compile (or reuse cached) agent binary. Returns build info."""
        source = _sanitize_cpp_code(solver_cpp)
        key = self._content_hash(source)
        binary = self.build_dir / f"solver_{key}"
        if binary.exists():
            return {"success": True, "binary": str(binary), "cached": True}

        with self._compile_lock:
            if binary.exists():
                return {"success": True, "binary": str(binary), "cached": True}
            src_path = self.build_dir / f"solver_{key}.cc"
            src_path.write_text(source)
            cmd = (
                [_CXX]
                + _CXXFLAGS
                + [f"-I{_NATIVE_INCLUDE}", str(src_path), "-o", str(binary)]
            )
            t0 = time.time()
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
            if proc.returncode != 0:
                return {
                    "success": False,
                    "compile_errors": _extract_compile_errors(proc.stderr),
                    "stderr": proc.stderr,
                }
            return {
                "success": True,
                "binary": str(binary),
                "cached": False,
                "t_compile": time.time() - t0,
            }

    # -- output conversion ------------------------------------------------

    @staticmethod
    def _convert_output(outdir: Path, case_spec: Dict[str, Any]) -> Optional[str]:
        """Normalize binary outputs to solution.npz. Returns error or None."""
        grid = case_spec.get("oracle_config", case_spec)["output"]["grid"]
        ny, nx = int(grid["ny"]), int(grid["nx"])
        shape = (int(grid["nz"]), ny, nx) if grid.get("nz") else (ny, nx)

        npz = outdir / "solution.npz"
        if npz.exists():
            try:
                u = np.load(npz)["u"]
            except Exception as e:
                return f"solution.npz unreadable: {e}"
        else:
            binfile = outdir / "solution_grid.bin"
            if not binfile.exists():
                return "neither solution.npz nor solution_grid.bin written"
            u = np.fromfile(binfile, dtype=np.float64)
            if u.size != int(np.prod(shape)):
                return (
                    f"solution_grid.bin has {u.size} values, expected "
                    f"{int(np.prod(shape))} for grid {shape}"
                )
            u = u.reshape(shape)
            np.savez(npz, u=u)
            np.save(outdir / "u.npy", u)
        if tuple(u.shape) != shape:
            return f"output shape {u.shape} != required {shape}"
        return None

    # -- run --------------------------------------------------------------

    def execute(
        self,
        solver_cpp: str,
        case_spec: Dict[str, Any],
        outdir: str,
        timeout_sec: float = 300.0,
    ) -> ExecutionResult:
        outdir_p = Path(outdir)
        outdir_p.mkdir(parents=True, exist_ok=True)

        build = self.build(solver_cpp)
        if not build["success"]:
            return ExecutionResult(
                success=False,
                error_message="compile failed:\n" + build["compile_errors"],
                stderr=build.get("stderr", ""),
                returncode=1,
            )

        agent_spec = build_agent_case_spec(case_spec)
        with tempfile.TemporaryDirectory() as tmp:
            case_path = Path(tmp) / "case_spec.json"
            case_path.write_text(json.dumps(agent_spec))
            t0 = time.time()
            try:
                proc = subprocess.run(
                    [build["binary"], str(case_path), str(outdir_p)],
                    capture_output=True,
                    text=True,
                    timeout=timeout_sec,
                    cwd=tmp,
                )
            except subprocess.TimeoutExpired:
                return ExecutionResult(
                    success=False,
                    error_message=f"timeout after {timeout_sec}s",
                    returncode=-9,
                    t_agent_run=time.time() - t0,
                )
            t_run = time.time() - t0

        t1 = time.time()
        problem = self._convert_output(outdir_p, case_spec)
        t_val = time.time() - t1

        meta = outdir_p / "meta.json"
        if meta.exists():
            try:
                t_run = float(json.load(open(meta)).get("baseline_time", t_run))
            except Exception:
                pass

        if problem is None:
            return ExecutionResult(
                success=True,
                stdout=proc.stdout,
                stderr=proc.stderr,
                returncode=proc.returncode,
                t_agent_run=t_run,
                t_validation=t_val,
            )
        return ExecutionResult(
            success=False,
            error_message=problem if proc.returncode == 0 else (
                proc.stderr.strip().splitlines()[-1]
                if proc.stderr.strip()
                else problem
            ),
            stdout=proc.stdout,
            stderr=proc.stderr,
            returncode=proc.returncode,
            t_agent_run=t_run,
            t_validation=t_val,
        )
