"""Out-of-process native (C++) oracle backend.

Mirrors the reference's deal.II-binaries architecture
(dealii_oracle/oracle.py + common.py): the Python side derives
manufactured-solution data symbolically and injects `_computed_*`
expression strings into the spec, builds the binary on demand (make,
cached by mtime), runs it under the contract
`<solver> <case_spec.json> <outdir>`, and reads back
solution_grid.bin + meta.json. Accuracy baselines are computed host-side
against the analytic exact grid exactly like the in-process oracles.

Covered (same families as the reference's nine deal.II programs,
dealii_oracle/programs/*.cc): poisson / helmholtz / heat / darcy
(elliptic) / convection_diffusion / wave / reaction_diffusion (linear)
via `scalar_solver` (P1), and biharmonic / linear_elasticity / stokes /
navier_stokes via `system_solver` (generic-degree Lagrange, Taylor-Hood
saddle points) on unit_square and unit_cube; the in-process PyTorch
oracles remain the primary ones.

Copy of pdebench_tpu/oracle/cpp_backend.py on the port's modules
(symbolic, scalar, base.build_mesh, types). It runs the same native/
sources, built into build/pdebench_tpu_torch/native/ (git-ignored) under
a file lock, never into native/build/, where the JAX package's build of
the same binaries goes.
"""

from __future__ import annotations

import copy
import fcntl
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import sympy as sp

from ..fem import symbolic
from . import scalar
from .types import OracleResult, compute_rel_L2_grid

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
# the port's own build of the native binaries (native/Makefile's BUILD)
_BUILD_DIR = _REPO_ROOT / "build" / "pdebench_tpu_torch" / "native"

_SCALAR_PDES = (
    "poisson",
    "helmholtz",
    "heat",
    "darcy",
    "convection_diffusion",
    "wave",
    "reaction_diffusion",
)
_SYSTEM_PDES = (
    "biharmonic",
    "linear_elasticity",
    "stokes",
    "navier_stokes",
)
_SUPPORTED_PDES = _SCALAR_PDES + _SYSTEM_PDES
_SUPPORTED_DOMAINS = ("unit_square", "unit_cube")
# complex 2-D geometries: triangulation imported from the Python mesher
# (shared mesh GENERATION, like the reference's shared Gmsh files —
# dealii_oracle/common.py:616-858 — with independent C++ discretization)
_COMPLEX_2D_DOMAINS = (
    "l_shape",
    "circle",
    "annulus",
    "square_with_hole",
    "multi_hole",
    "t_junction",
    "sector",
    "star",
    "gear",
    "dumbbell",
    "eccentric_annulus",
)


def _write_mesh_file(mesh, path: Path) -> None:
    """Flat binary triangulation for pdebench_unstructured.hpp:
    int32 magic 'pdm1', dim, n_nodes, n_cells; f64 coords; int32 cells."""
    coords = np.asarray(mesh.coords, dtype=np.float64)
    cells = np.asarray(mesh.cells, dtype=np.int32)
    with open(path, "wb") as f:
        np.asarray(
            [0x70646D31, coords.shape[1], coords.shape[0], cells.shape[0]],
            dtype=np.int32,
        ).tofile(f)
        coords.tofile(f)
        cells.tofile(f)


def _binary_for(pde_type: str) -> Path:
    name = "system_solver" if pde_type in _SYSTEM_PDES else "scalar_solver"
    return _BUILD_DIR / name


def ensure_built(pde_type: str = "poisson") -> Path:
    """Build (or reuse) the native binaries into _BUILD_DIR; mtime-cached
    via make, one make at a time across processes (a file lock)."""
    binary = _binary_for(pde_type)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".make.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(
            ["make", "-C", str(_NATIVE_DIR), "-s", "-j2", f"BUILD={_BUILD_DIR}"],
            capture_output=True,
            text=True,
            timeout=600,
        )
    if proc.returncode != 0 or not binary.exists():
        raise RuntimeError(f"native build failed:\n{proc.stderr[-2000:]}")
    return binary


def preprocess_case_spec(config: Dict[str, Any]) -> Dict[str, Any]:
    """Inject _computed_source/_computed_bc/_computed_ic sympy strings.

    Role parity with the reference's sympy->muParser preprocessors
    (dealii_oracle/common.py:104-605); our native evaluator reads sympy
    syntax directly, so derived expressions are passed as str(sympy).
    """
    cfg = copy.deepcopy(config)
    pde = cfg["pde"]
    dim = 3 if cfg["domain"]["type"] == "unit_cube" else 2
    t = pde.get("type")
    mms = pde.get("manufactured_solution", {})
    u = mms.get("u", mms.get("p") if t != "stokes" else None)
    if u is None:
        return cfg
    params = pde.get("pde_params", {})
    if t in ("linear_elasticity", "stokes", "navier_stokes"):
        # vector MMS: derive componentwise sources + exact-u BCs
        from .linear_elasticity import elasticity_source, lame_from_params
        from .navier_stokes import ns_source
        from .stokes import stokes_source

        u_list = list(u)
        if t == "linear_elasticity":
            lam, mu = lame_from_params(params)
            src = elasticity_source(u_list, lam, mu, dim)
        elif t == "stokes":
            src = stokes_source(u_list, mms.get("p"), float(params.get("nu", 1.0)), dim)
        else:
            src = ns_source(u_list, mms.get("p"), float(params.get("nu", 1.0)), dim)
        pde["_computed_source"] = [str(s) for s in src]
        pde["_computed_bc"] = [str(symbolic.parse(e)) for e in u_list]
        return cfg
    u_sym = symbolic.parse(u)
    kspec = pde.get("coefficients", {}).get("kappa") or {}
    kexpr = kspec.get("expr", kspec.get("value", 1.0)) if kspec else 1.0
    params = pde.get("pde_params", {})
    if t in ("poisson", "darcy"):
        src = symbolic.poisson_source(u_sym, kexpr, dim)
    elif t == "helmholtz":
        k = float(params.get("k", 1.0))
        src = sp.simplify(-symbolic.laplacian(u_sym, dim) - k * k * u_sym)
    elif t == "biharmonic":
        lap_u = symbolic.laplacian(u_sym, dim)
        src = sp.simplify(symbolic.laplacian(lap_u, dim))
        pde["_computed_bc_lap"] = str(sp.simplify(-lap_u))
    elif t == "heat":
        src = symbolic.heat_source(u_sym, kexpr, dim)
        pde["_computed_ic"] = str(u_sym)
    elif t == "convection_diffusion":
        eps = float(params.get("epsilon", 1.0))
        beta = params.get("beta", [0.0] * dim)
        sv = [symbolic.X, symbolic.Y, symbolic.Z][:dim]
        conv = sum(
            symbolic.parse(b) * sp.diff(u_sym, v) for b, v in zip(beta, sv)
        )
        src = -eps * symbolic.laplacian(u_sym, dim) + conv
        if pde.get("time"):
            src = sp.diff(u_sym, symbolic.T) + src
            pde["_computed_ic"] = str(u_sym)
    elif t == "wave":
        c = float(params.get("c", 1.0))
        src = sp.simplify(
            sp.diff(u_sym, symbolic.T, 2)
            - c * c * symbolic.laplacian(u_sym, dim)
        )
        pde["_computed_ic"] = str(u_sym)
        pde["_computed_iv"] = str(sp.diff(u_sym, symbolic.T))
    elif t == "reaction_diffusion":
        eps = float(params.get("epsilon", 1.0))
        reaction = params.get("reaction", {})
        if str(reaction.get("type", "linear")).lower() != "linear":
            raise NotImplementedError(
                "native backend: nonlinear reactions unsupported"
            )
        alpha = symbolic.parse(reaction.get("alpha", 0.0))
        src = (
            sp.diff(u_sym, symbolic.T)
            - eps * symbolic.laplacian(u_sym, dim)
            + alpha * u_sym
        )
        pde["_computed_ic"] = str(u_sym)
    else:
        return cfg
    pde["_computed_source"] = str(src)
    pde["_computed_bc"] = str(u_sym)
    return cfg


def solve_via_cpp(oracle_config: Dict[str, Any]) -> OracleResult:
    pde_type = oracle_config["pde"]["type"]
    domain = oracle_config["domain"]["type"]
    if pde_type not in _SUPPORTED_PDES or (
        domain not in _SUPPORTED_DOMAINS
        and domain not in _COMPLEX_2D_DOMAINS
    ):
        raise NotImplementedError(
            f"native backend covers {_SUPPORTED_PDES} on "
            f"{_SUPPORTED_DOMAINS} + complex 2-D; got {pde_type} on {domain}"
        )
    binary = ensure_built(pde_type)
    cfg = preprocess_case_spec(oracle_config)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if domain in _COMPLEX_2D_DOMAINS:
            from . import base as _base

            mesh = _base.build_mesh(cfg["domain"], cfg.get("mesh", {}))
            mesh_path = Path(tmp) / "domain_mesh.bin"
            _write_mesh_file(mesh, mesh_path)
            cfg["domain"]["_mesh_file"] = str(mesh_path)
        spec_path = Path(tmp) / "case_spec.json"
        spec_path.write_text(json.dumps(cfg))
        timeout_s = float(os.environ.get("PDEBENCH_TPU_CPP_TIMEOUT", "900"))

        def _run():
            return subprocess.run(
                [str(binary), str(spec_path), tmp],
                capture_output=True,
                text=True,
                timeout=timeout_s,
            )

        # robustness-override escalation, mirroring the reference's
        # dealii driver forcing stronger solvers on cases where its
        # iterative configs fail (dealii_oracle/oracle.py:503-529):
        # when the default-strength run times out or exits nonzero and
        # no per-case override was given, retry ONCE with a much
        # stronger ILUT + longer restart (high-Pe SUPG systems on
        # complex domains are the known class, e.g.
        # convdiff_gear_12teeth_supg).
        try:
            proc = _run()
            failed = proc.returncode != 0
        except subprocess.TimeoutExpired:
            proc, failed = None, True
        # Escalate only when the failure looks like solver weakness
        # (timeout, or a solver-convergence message on stderr) — a
        # spec/assembly error would fail identically with stronger ILUT
        # and burn another full timeout (ADVICE r4).
        looks_solver = proc is None or any(
            m in (proc.stderr or "").lower()
            for m in ("converge", "breakdown", "stagnat", "iteration")
        )
        if failed and looks_solver and "native_solver" not in cfg:
            cfg["native_solver"] = {
                "ilut_tau": 1e-5,
                "ilut_fill": 160,
                "restart": 400,
            }
            spec_path.write_text(json.dumps(cfg))
            try:
                proc = _run()
            except subprocess.TimeoutExpired:
                proc = None  # fall into the existing `proc is None` error
        if proc is None or proc.returncode != 0:
            raise RuntimeError(
                "native solver failed"
                + (
                    f" ({proc.returncode}): {proc.stderr[-1000:]}"
                    if proc is not None
                    else " (timeout, incl. escalated retry)"
                )
            )
        meta = json.load(open(Path(tmp) / "meta.json"))
        grid_cfg = oracle_config["output"]["grid"]
        ny, nx = int(grid_cfg["ny"]), int(grid_cfg["nx"])
        shape = (
            (int(grid_cfg["nz"]), ny, nx) if grid_cfg.get("nz") else (ny, nx)
        )
        u = np.fromfile(Path(tmp) / "solution_grid.bin", dtype=np.float64)
        u = u.reshape(shape)
    wall = time.perf_counter() - t0

    t_final = None
    if pde_type in ("heat", "wave", "reaction_diffusion") or (
        pde_type == "convection_diffusion"
        and oracle_config["pde"].get("time")
    ):
        tcfg = oracle_config["pde"].get("time", {})
        t0_, te, dt = (
            float(tcfg.get("t0", 0.0)),
            float(tcfg.get("t_end", 0.1)),
            float(tcfg.get("dt", 0.01)),
        )
        if pde_type in ("heat", "wave"):
            steps = max(int((te - t0_) / dt + 0.5), 1)  # round
        else:
            steps = max(int(-(-((te - t0_) / dt) // 1)), 1)  # ceil
        t_final = t0_ + steps * dt

    err = scalar.mms_baseline_error(oracle_config, u, t_end=t_final)
    if err is None and "reference_config" in oracle_config:
        ref = solve_via_cpp(scalar.merge_reference_config(oracle_config))
        err = compute_rel_L2_grid(u, ref.reference)

    solver_info = dict(meta.get("solver_info", {}))
    solver_info.update(library="pdebench_tpu_native", pde=pde_type)
    return OracleResult(
        baseline_error=float(err if err is not None else 0.0),
        baseline_time=float(meta.get("baseline_time", wall)),
        reference=u,
        solver_info=solver_info,
        num_dofs=int(meta.get("num_dofs", 0)),
    )
