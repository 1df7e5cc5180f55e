"""Math-type-specific metrics computers.

One computer per math_type tag (the reference ships 12 near-identical
classes under metrics/specialized/; here they are small functions behind
one registry, same factory interface and metric keys —
pdebench/metrics/specialized/__init__.py:45-96, meta_reader.py:12-80).

Each computer reads the agent's self-reported solver_info from
agent_output_dir/meta.json plus the solution grids, and returns a dict
of domain-specific indicators (DOF throughput, iteration counts, CFL,
conservation checks, ...). All computers are best-effort: failures land
in an 'error' key, never raise.

Copy of pdebench_tpu/metrics/specialized.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# meta.json access (reference: specialized/meta_reader.py)
# ---------------------------------------------------------------------------


def read_solver_info(agent_output_dir: Path) -> Dict[str, Any]:
    meta_file = Path(agent_output_dir) / "meta.json"
    if not meta_file.exists():
        return {}
    try:
        with open(meta_file) as f:
            meta = json.load(f)
        return meta.get("solver_info", meta) or {}
    except Exception:
        return {}


def _load_grid(path: Path, key: str = "u") -> Optional[np.ndarray]:
    try:
        return np.load(Path(path) / "solution.npz")[key]
    except Exception:
        try:
            return np.load(Path(path) / "reference.npz")["reference"]
        except Exception:
            return None


def _estimate_dof(resolution: int, degree: int) -> int:
    if degree == 1:
        return resolution**2
    if degree == 2:
        return (2 * resolution + 1) ** 2
    return resolution**2 * degree**2


def _total_variation(u: np.ndarray) -> float:
    u = np.where(np.isfinite(u), u, 0.0)
    tv = np.abs(np.diff(u, axis=0)).sum() + np.abs(np.diff(u, axis=1)).sum()
    return float(tv)


class SpecializedMetricsComputer:
    """Factory product: binds a metric function to the case's file layout."""

    def __init__(
        self,
        agent_output_dir: Path,
        oracle_output_dir: Path,
        config: Dict[str, Any],
        fn: Callable,
        math_type: str,
    ):
        self.agent_output_dir = Path(agent_output_dir)
        self.oracle_output_dir = Path(oracle_output_dir)
        self.config = config
        self._fn = fn
        self.math_type = math_type

    def compute(self, result: Dict[str, Any]) -> Dict[str, Any]:
        try:
            return self._fn(self, result)
        except Exception as e:  # never raise (reference behavior)
            return {"error": f"Failed to compute {self.math_type} metrics: {e}"}


# ---------------------------------------------------------------------------
# per-math-type computers
# ---------------------------------------------------------------------------


def _common_discretization(c: SpecializedMetricsComputer, result) -> Dict[str, Any]:
    info = read_solver_info(c.agent_output_dir)
    resolution = int(info.get("mesh_resolution", 0) or 0)
    degree = int(info.get("element_degree", 1) or 1)
    if resolution == 0:
        resolution = int(result.get("test_params", {}).get("resolution", 0) or 0)
    return {
        "info": info,
        "resolution": resolution,
        "degree": degree,
        "dof": _estimate_dof(resolution, degree),
    }


def _elliptic(c, result):
    d = _common_discretization(c, result)
    m: Dict[str, Any] = {
        "dof": d["dof"],
        "resolution": d["resolution"],
        "degree": d["degree"],
    }
    runtime = result.get("runtime_sec", 0) or 0
    if runtime > 0:
        m["efficiency_dof_per_sec"] = float(d["dof"] / runtime)
    iters = d["info"].get("iterations")
    if isinstance(iters, (int, float)):
        m["linear_iterations"] = int(iters)
        # CG iteration count ~ sqrt(kappa): kappa ~ (iters/2)^2 estimate
        if iters > 0:
            m["condition_number_estimate"] = float((iters / 2.0) ** 2)
    return m


def _parabolic(c, result):
    d = _common_discretization(c, result)
    info = d["info"]
    time_cfg = c.config.get("pde", {}).get("time", {}) or {}
    dt = float(info.get("dt", time_cfg.get("dt", 0.01)) or 0.01)
    t_end = float(time_cfg.get("t_end", 1.0))
    n_steps = int(info.get("num_steps", max(int(round(t_end / dt)), 1)))
    m = {
        "dof": d["dof"],
        "n_steps": n_steps,
        "dt": dt,
        "t_end": t_end,
        "agent_resolution": d["resolution"],
        "agent_degree": d["degree"],
    }
    scheme = info.get("time_scheme", time_cfg.get("scheme"))
    if scheme:
        m["time_scheme"] = scheme
    runtime = result.get("runtime_sec", 0) or 0
    if runtime > 0:
        m["efficiency_workrate"] = float(d["dof"] * n_steps / runtime)
        m["time_per_step"] = float(runtime / max(n_steps, 1))
    kappa = 1.0
    if d["resolution"] > 0:
        h = 1.0 / d["resolution"]
        cfl = kappa * dt / (h * h)
        m["cfl_number"] = float(cfl)
        if cfl > 0.5 and str(scheme or "").startswith("forward"):
            m["cfl_warning"] = f"CFL={cfl:.2f} > 0.5 (explicit unstable)"
    return m


def _hyperbolic(c, result):
    d = _common_discretization(c, result)
    info = d["info"]
    time_cfg = c.config.get("pde", {}).get("time", {}) or {}
    m: Dict[str, Any] = {"element_degree": d["degree"]}
    if d["resolution"]:
        m["mesh_resolution"] = d["resolution"]
    dt = info.get("dt", time_cfg.get("dt"))
    if dt is not None:
        m["dt"] = float(dt)
        n_steps = info.get("num_steps")
        if n_steps is not None:
            m["n_steps"] = int(n_steps)
        cwave = float(c.config.get("pde", {}).get("pde_params", {}).get("c", 1.0))
        if d["resolution"]:
            cfl = cwave * float(dt) * d["resolution"]
            m["cfl_number"] = float(cfl)
            if cfl > 1.0:
                m["cfl_warning"] = f"CFL={cfl:.2f} > 1.0 (explicit unstable)"
    iters = info.get("iterations")
    if isinstance(iters, (int, float)):
        m["linear_iterations"] = int(iters)
    u = _load_grid(c.agent_output_dir)
    if u is not None and u.ndim == 2:
        m["total_variation"] = _total_variation(u)
    return m


def _incompressible_flow(c, result):
    info = read_solver_info(c.agent_output_dir)
    m: Dict[str, Any] = {}
    nu = float(c.config.get("pde", {}).get("pde_params", {}).get("nu", 1.0))
    m["viscosity"] = nu
    u = _load_grid(c.agent_output_dir)
    if u is not None:
        umax = float(np.nanmax(np.abs(u)))
        m["max_velocity_magnitude"] = umax
        if nu > 0:
            m["reynolds_estimate"] = float(umax / nu)
    for k in ("iterations", "init_mode", "pressure_fixing"):
        if k in info:
            m[k] = info[k]
    return m


def _mixed_type(c, result):
    p = c.config.get("pde", {}).get("pde_params", {})
    m: Dict[str, Any] = {}
    eps = float(p.get("epsilon", 1.0))
    beta = p.get("beta")
    if beta is not None:
        bnorm = float(np.linalg.norm([float(b) for b in beta]))
        info = read_solver_info(c.agent_output_dir)
        res = int(info.get("mesh_resolution", 0) or 0)
        h = 1.0 / res if res else 0.01
        if eps > 0:
            m["peclet_number"] = float(bnorm * h / (2 * eps))
        m["beta_norm"] = bnorm
    m["epsilon"] = eps
    u = _load_grid(c.agent_output_dir)
    if u is not None and u.ndim == 2:
        m["total_variation"] = _total_variation(u)
    return m


def _dispersive(c, result):
    m: Dict[str, Any] = {}
    u = _load_grid(c.agent_output_dir)
    if u is not None:
        m["mass_agent"] = float(np.nansum(u))
        ref = _load_grid(c.oracle_output_dir, "reference")
        if ref is not None and ref.shape == u.shape:
            m["mass_reference"] = float(np.nansum(ref))
            denom = max(abs(m["mass_reference"]), 1e-30)
            m["mass_conservation_error"] = float(
                abs(m["mass_agent"] - m["mass_reference"]) / denom
            )
    return m


def _reaction_diffusion(c, result):
    info = read_solver_info(c.agent_output_dir)
    m: Dict[str, Any] = {}
    if "mesh_resolution" in info:
        m["mesh_resolution"] = int(info["mesh_resolution"])
    if "element_degree" in info:
        m["element_degree"] = int(info["element_degree"])
    iters = info.get("iterations")
    if isinstance(iters, (int, float)):
        m["linear_iterations"] = int(iters)
    elif isinstance(iters, (list, tuple)) and iters:
        m["linear_iterations_mean"] = float(np.mean(iters))
        m["linear_iterations_max"] = int(np.max(iters))
    reaction = c.config.get("pde", {}).get("pde_params", {}).get("reaction", {})
    if reaction:
        m["reaction_type"] = reaction.get("type", "linear")
    u = _load_grid(c.agent_output_dir)
    if u is not None:
        m["solution_min"] = float(np.nanmin(u))
        m["solution_max"] = float(np.nanmax(u))
    return m


def _compressible_flow(c, result):
    m: Dict[str, Any] = {}
    u = _load_grid(c.agent_output_dir)
    if u is not None:
        rho_min = float(np.nanmin(u))
        m["density_min"] = rho_min
        m["density_positive"] = bool(rho_min > -1e-10)
        if u.ndim == 2:
            grad = np.abs(np.gradient(np.where(np.isfinite(u), u, 0.0))[0])
            gmax = grad.max()
            if gmax > 0:
                m["shock_width"] = float((grad > 0.5 * gmax).mean())
    p = c.config.get("pde", {}).get("pde_params", {})
    if "mach" in p:
        m["mach_number"] = float(p["mach"])
    return m


def _kinetic(c, result):
    m: Dict[str, Any] = {}
    u = _load_grid(c.agent_output_dir)
    if u is not None:
        rho = np.where(np.isfinite(u), u, 0.0)
        m["total_mass"] = float(np.sum(rho))
        m["total_momentum"] = float(np.sum(rho * np.arange(rho.shape[-1])))
        m["total_energy"] = float(np.sum(rho**2))
    return m


def _fractional(c, result):
    d = _common_discretization(c, result)
    m: Dict[str, Any] = {"dof": d["dof"]}
    alpha = c.config.get("pde", {}).get("pde_params", {}).get("alpha")
    if alpha is not None:
        m["fractional_order_alpha"] = float(alpha)
    runtime = result.get("runtime_sec", 0) or 0
    if runtime > 0:
        m["efficiency_dof_per_sec"] = float(d["dof"] / runtime)
    nnz = d["info"].get("matrix_nnz")
    if nnz and d["dof"]:
        m["matrix_sparsity"] = float(nnz / (d["dof"] ** 2))
    return m


def _stochastic(c, result):
    info = read_solver_info(c.agent_output_dir)
    m: Dict[str, Any] = {}
    for k in ("n_samples", "seed", "variance_estimate"):
        if k in info:
            m[k] = info[k]
    u = _load_grid(c.agent_output_dir)
    if u is not None:
        m["field_variance"] = float(np.nanvar(u))
    return m


def _multiphysics(c, result):
    info = read_solver_info(c.agent_output_dir)
    m: Dict[str, Any] = {}
    fields = []
    try:
        with np.load(Path(c.agent_output_dir) / "solution.npz") as z:
            fields = list(z.keys())
    except Exception:
        pass
    m["available_fields"] = fields
    m["n_fields"] = len(fields)
    iters = info.get("coupling_iterations", info.get("iterations"))
    if isinstance(iters, (list, tuple)) and iters:
        m["coupling_iterations_mean"] = float(np.mean(iters))
        m["coupling_iterations_max"] = int(np.max(iters))
    elif isinstance(iters, (int, float)):
        m["coupling_iterations"] = int(iters)
    return m


_COMPUTERS: Dict[str, Callable] = {
    "elliptic": _elliptic,
    "parabolic": _parabolic,
    "hyperbolic": _hyperbolic,
    "incompressible_flow": _incompressible_flow,
    "mixed_type": _mixed_type,
    "dispersive": _dispersive,
    "reaction_diffusion": _reaction_diffusion,
    "compressible_flow": _compressible_flow,
    "kinetic": _kinetic,
    "fractional": _fractional,
    "stochastic": _stochastic,
    "multiphysics": _multiphysics,
}


def get_specialized_metrics_computer(
    pde_type: str,
    agent_output_dir: Path,
    oracle_output_dir: Path,
    config: Dict[str, Any],
) -> Optional[SpecializedMetricsComputer]:
    fn = _COMPUTERS.get(str(pde_type).lower())
    if fn is None:
        return None
    return SpecializedMetricsComputer(
        agent_output_dir, oracle_output_dir, config, fn, str(pde_type).lower()
    )
