"""Per-case prompt generation for LLM/code agents.

Assembles the same information blocks as the reference prompt builder
(reference: pdebench/core/prompt_builder.py:10-801): a natural-language
problem line, the equation template, domain geometry, sources/BCs/ICs/
coefficients, PDE-specific numerical warnings (SUPG, Newmark,
semi-implicit Burgers), the output-grid contract with NaN-mask guidance,
the `solve(case_spec)` interface contract with required solver_info
keys, agent knobs (with anchoring ranges stripped), pass/fail thresholds
derived from the oracle baseline, and an injected API guide.

solver_library values: "python" (pure numpy/scipy), "torch" (this repo's
pdebench_tpu_torch FEM library on PyTorch, the default), "cpp"
(standalone C++17 binary contract). The reference's
dolfinx/firedrake/dealii libraries map to torch/torch/cpp respectively.

Copy of pdebench_tpu/core/prompt_builder.py with the in-process library
named "torch" in place of "jax" (its guide, docs/PDEBENCH_TPU_TORCH_GUIDE.md,
and the importable package); the "python" and "cpp" prompts are the
reference's, string for string.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

_DOCS_DIR = Path(__file__).resolve().parents[1] / "docs"

EQUATION_TEMPLATES: Dict[str, Dict[str, str]] = {
    "poisson": {
        "title": "the Poisson equation",
        "equation": "-div(kappa * grad(u)) = f   in Omega,   u = g on the boundary",
        "description": "Steady diffusion with (possibly space-varying) "
        "coefficient kappa and Dirichlet boundary conditions.",
    },
    "heat": {
        "title": "the heat equation",
        "equation": "du/dt - div(kappa * grad(u)) = f,   u(x, t0) = u0,   u = g(t) on the boundary",
        "description": "Transient diffusion. Use an implicit time scheme "
        "(backward Euler is the oracle's choice) for unconditional stability.",
    },
    "wave": {
        "title": "the wave equation",
        "equation": "d2u/dt2 - c^2 * Lap(u) = f,   u(x,t0) = u0,  du/dt(x,t0) = v0",
        "description": "Second-order hyperbolic. The oracle uses a Newmark "
        "theta-scheme (theta = 1/4), unconditionally stable and 2nd-order.",
    },
    "helmholtz": {
        "title": "the Helmholtz equation",
        "equation": "-Lap(u) - k^2 * u = f   in Omega,   u = g on the boundary",
        "description": "Indefinite elliptic problem; direct solvers or "
        "GMRES-type Krylov methods are appropriate (CG will fail).",
    },
    "convection_diffusion": {
        "title": "the steady convection-diffusion equation",
        "equation": "-epsilon * Lap(u) + beta . grad(u) = f,   u = g on the boundary",
        "description": "Convection-dominated transport when the Peclet "
        "number is large; stabilization (e.g. SUPG) is then required.",
    },
    "convection_diffusion_transient": {
        "title": "the transient convection-diffusion equation",
        "equation": "du/dt - epsilon * Lap(u) + beta . grad(u) = f",
        "description": "Transient transport; implicit stepping plus SUPG "
        "when convection dominates.",
    },
    "reaction_diffusion": {
        "title": "the reaction-diffusion equation",
        "equation": "du/dt - epsilon * Lap(u) + R(u) = f",
        "description": "Reaction term R(u) may be nonlinear (cubic, "
        "Allen-Cahn, logistic): use Newton iterations inside each "
        "implicit time step.",
    },
    "burgers": {
        "title": "the 2-D Burgers equation",
        "equation": "du/dt + u * (du/dx + du/dy) - nu * Lap(u) = f",
        "description": "Nonlinear advection-diffusion. A semi-implicit "
        "scheme (lagged convection, implicit diffusion) is stable and "
        "cheap — it is what the oracle uses.",
    },
    "linear_elasticity": {
        "title": "linear elasticity",
        "equation": "-div(sigma(u)) = f,  sigma = 2*mu*eps(u) + lambda*tr(eps(u))*I",
        "description": "Vector-valued displacement with Lame parameters "
        "from (E, nu) in plane strain or given (lambda, mu). The output "
        "is the displacement MAGNITUDE |u|.",
    },
    "biharmonic": {
        "title": "the biharmonic equation",
        "equation": "Lap(Lap(u)) = f,   u = g_u and -Lap(u) = g_w on the boundary",
        "description": "Fourth-order elliptic. A mixed splitting into two "
        "Poisson solves (-Lap w = f, then -Lap u = w) works with standard "
        "C0 elements.",
    },
    "stokes": {
        "title": "the steady Stokes equations",
        "equation": "-nu * Lap(u) + grad(p) = f,  div(u) = 0",
        "description": "Saddle-point system: use inf-sup stable element "
        "pairs (Taylor-Hood P2-P1) and pin the pressure at one point. "
        "The output is the velocity MAGNITUDE |u|.",
    },
    "navier_stokes": {
        "title": "the steady incompressible Navier-Stokes equations",
        "equation": "(u . grad)u - nu * Lap(u) + grad(p) = f,  div(u) = 0",
        "description": "Nonlinear saddle point; Newton iteration with a "
        "Stokes warm start (or viscosity continuation at higher Reynolds "
        "numbers). The output is the velocity MAGNITUDE |u|.",
    },
    "darcy": {
        "title": "the Darcy flow equation",
        "equation": "-div(kappa * grad(p)) = f",
        "description": "Pressure formulation of porous-media flow with "
        "strictly positive permeability kappa.",
    },
}


def format_domain(domain_cfg: Dict[str, Any]) -> str:
    """Geometry description for all 14 domain types
    (reference: prompt_builder.py:79-187)."""
    t = domain_cfg.get("type", "unit_square")
    p = domain_cfg.get("geometry_params", {})
    if t == "unit_square":
        return "the unit square [0,1] x [0,1]"
    if t == "unit_cube":
        return "the unit cube [0,1]^3"
    if t == "periodic_square":
        b = p.get("bounds", p.get("extents", [0, 1, 0, 1]))
        return (
            f"the rectangle [{b[0]},{b[1]}] x [{b[2]},{b[3]}] with PERIODIC "
            "boundary conditions in x and y (identify opposite edges)"
        )
    if t == "l_shape":
        if "outer_bbox" in domain_cfg:
            return (
                f"an L-shaped domain: the rectangle {domain_cfg['outer_bbox']} "
                f"minus the cutout {domain_cfg['cutout_bbox']}"
            )
        v = p.get("vertices")
        return f"an L-shaped polygon with vertices {v}"
    if t == "circle":
        return (
            f"a disk centered at {p.get('center', [0.5, 0.5])} with radius "
            f"{p.get('radius', 0.5)}"
        )
    if t == "annulus":
        return (
            f"an annulus centered at {p.get('center', [0, 0])}, inner radius "
            f"{p.get('inner_r')}, outer radius {p.get('outer_r')}"
        )
    if t == "eccentric_annulus":
        return (
            f"an eccentric annulus: outer circle {p.get('outer_circle')} minus "
            f"inner circle {p.get('inner_circle')} (circles are NOT concentric)"
        )
    if t == "square_with_hole":
        return (
            f"the rectangle {p.get('outer', [0, 1, 0, 1])} with a hole: "
            f"{p.get('inner_hole')}"
        )
    if t == "multi_hole":
        return (
            f"the rectangle {p.get('outer', [0, 1, 0, 1])} with "
            f"{len(p.get('holes', []))} circular holes: {p.get('holes')}"
        )
    if t == "t_junction":
        return (
            f"a T-junction: union of the horizontal rectangle "
            f"{p.get('horizontal_rect')} and the vertical rectangle "
            f"{p.get('vertical_rect')} (rectangles as [x0, x1, y0, y1])"
        )
    if t == "sector":
        return (
            f"a circular sector centered at {p.get('center', [0, 0])}, radius "
            f"{p.get('radius', 1.0)}, spanning {p.get('angle', 90)} degrees "
            "from the positive x-axis"
        )
    if t in ("star", "star_shape"):
        return (
            f"a {p.get('points', 5)}-pointed star centered at "
            f"{p.get('center', [0, 0])}, inner radius {p.get('inner_r')}, "
            f"outer radius {p.get('outer_r')}"
        )
    if t == "gear":
        return (
            f"a gear-shaped polygon with {p.get('teeth', 8)} teeth, base "
            f"radius {p.get('base_r')}, tooth height {p.get('tooth_h')}, "
            f"centered at {p.get('center', [0, 0])}"
        )
    if t == "dumbbell":
        return f"a dumbbell: two disks joined by a bridge ({json.dumps(p)})"
    return f"domain '{t}' with parameters {json.dumps(p)}"


def format_coefficient(coeff: Optional[Dict[str, Any]]) -> str:
    if not coeff:
        return "1 (constant)"
    if coeff.get("type") == "constant":
        return f"{coeff.get('value', 1.0)} (constant)"
    if coeff.get("type") == "expr":
        return f"`{coeff['expr']}` (function of the coordinates)"
    return json.dumps(coeff)


def generate_nl_description(case: Dict[str, Any]) -> str:
    """One-line problem statement with difficulty callouts
    (reference: prompt_builder.py:190-301)."""
    oc = case["oracle_config"]
    pde = oc["pde"]
    t = pde["type"]
    params = pde.get("pde_params", {})
    dom = format_domain(oc["domain"])
    bits: List[str] = []
    if t == "convection_diffusion":
        eps = float(params.get("epsilon", 1.0))
        beta = params.get("beta", [0, 0])
        import numpy as np

        bnorm = float(np.linalg.norm([float(b) for b in beta]))
        if eps > 0 and bnorm / eps > 50:
            bits.append(
                f"convection-dominated (|beta|/epsilon = {bnorm / eps:.0f}; "
                "expect boundary layers — stabilize your discretization)"
            )
    if t == "helmholtz":
        k = float(params.get("k", 1.0))
        if k >= 10:
            bits.append(
                f"wavenumber k = {k:g} — resolve the oscillation with a "
                "fine enough mesh and use an indefinite-capable solver"
            )
    if t == "navier_stokes":
        nu = float(params.get("nu", 1.0))
        if nu <= 0.05:
            bits.append(
                f"viscosity nu = {nu:g} (moderate Reynolds number — a plain "
                "Newton from zero may diverge; warm start or continuation)"
            )
    if t == "reaction_diffusion":
        rt = params.get("reaction", {}).get("type", "linear")
        if rt != "linear":
            bits.append(f"nonlinear '{rt}' reaction — Newton per time step")
    extra = ("; " + "; ".join(bits)) if bits else ""
    transient = "time-dependent " if pde.get("time") else ""
    return (
        f"Solve a {transient}{t.replace('_', ' ')} problem on {dom}{extra}."
    )


_OUTPUT_CONTRACT = """
## Output Contract (STRICT)

Sample your final solution on the uniform output grid:
  - grid bbox: {bbox}; nx = {nx}, ny = {ny}{nz_line}
  - 2-D: return an array of shape (ny, nx) with u[j, i] = u(x[i], y[j])
    where x = linspace(bbox[0], bbox[1], nx), y = linspace(bbox[2], bbox[3], ny)
  - 3-D: shape (nz, ny, nx), C-order (iz, iy, ix)
  - the shape must match EXACTLY; do not interpolate to another grid
{nan_note}"""

_NAN_NOTE_COMPLEX = """  - grid points OUTSIDE the domain must be NaN (the grid spans the
    bounding box; the domain is not rectangular — mask exterior points)"""

_PY_CONTRACT = """
## Interface Contract (Python)

Write a single file defining:

```python
def solve(case_spec: dict) -> dict:
    ...
    return {
        "u": u,                       # ndarray of the EXACT grid shape
        "solver_info": {
            "mesh_resolution": ...,   # int, your mesh resolution
            "element_degree": ...,    # int, polynomial degree
            "ksp_type": ...,          # str, linear solver used
            "pc_type": ...,           # str, preconditioner used
            "rtol": ...,              # float, solver tolerance
        },
    }
```

`case_spec` is a dict with TOP-LEVEL keys `pde` (type, coefficients,
pde_params, source_term, time/initial_condition for transient cases),
`domain` (type + geometry_params), `bc`, `output` (the grid spec),
`agent_knobs`, `evaluation_config`, `id`, `pde_classification` —
oracle-internal fields (mesh/fem/solver choices, exact solutions) are
removed. All five solver_info keys are REQUIRED. The script runs
in a sandbox with numpy/scipy{lib_note} available; it must be
self-contained (no network, no reading files outside the working dir).
"""

_CPP_CONTRACT = """
## Interface Contract (C++)

Write a single standalone C++17 file with:

```cpp
int main(int argc, char** argv)  // argv[1] = case_spec.json, argv[2] = outdir
```

It must write into outdir:
  - `solution_grid.bin` — the grid as raw little-endian float64, C-order,
    exactly ny*nx (or nz*ny*nx) values
  - `meta.json` — {"nx": ..., "ny": ..., "num_dofs": ..., "baseline_time": ...,
     "solver_info": {"mesh_resolution": ..., "element_degree": ...,
     "ksp_type": ..., "pc_type": ..., "rtol": ...}}

The build has NO external libraries; `#include "pdebench_json.hpp"`
(vendored, on the include path) provides a minimal JSON parser. Compile
target: g++ -O2 -std=c++17.
"""


def _load_guide(solver_library: str) -> str:
    name = {
        "torch": "PDEBENCH_TPU_TORCH_GUIDE.md",
        "python": "PYTHON_GUIDE.md",
        "cpp": "CPP_GUIDE.md",
    }.get(solver_library)
    if not name:
        return ""
    path = _DOCS_DIR / name
    if path.exists():
        return path.read_text()
    return ""


def generate_prompt(
    case: Dict[str, Any],
    oracle_info: Optional[Dict[str, Any]] = None,
    solver_library: str = "torch",
) -> str:
    oc = case["oracle_config"]
    pde = oc["pde"]
    t = pde["type"]
    key = (
        "convection_diffusion_transient"
        if t == "convection_diffusion" and pde.get("time")
        else t
    )
    tpl = EQUATION_TEMPLATES.get(key, EQUATION_TEMPLATES["poisson"])

    parts: List[str] = [generate_nl_description(case), ""]
    parts.append(f"# Task: Solve {tpl['title']}")
    parts.append("\n## Problem Description\n")
    parts.append(f"    {tpl['equation']}\n")
    parts.append(tpl["description"])
    parts.append(f"\n**Case ID:** {case.get('id', '?')}")
    mt = case.get("pde_classification", {}).get("math_type")
    if mt:
        parts.append(f"**Math type:** {', '.join(mt)}")

    parts.append(f"\n**Domain:** {format_domain(oc['domain'])}")

    params = pde.get("pde_params", {})
    if params:
        shown = {k: v for k, v in params.items() if k != "stabilization"}
        if shown:
            parts.append(f"**PDE parameters:** {json.dumps(shown)}")
    coeffs = pde.get("coefficients", {})
    if coeffs.get("kappa"):
        parts.append(f"**kappa:** {format_coefficient(coeffs['kappa'])}")

    src = pde.get("source_term")
    if src is not None:
        parts.append(f"**Source term f:** `{json.dumps(src)}`")
    ic = pde.get("initial_condition")
    if ic is not None:
        parts.append(f"**Initial condition:** `{json.dumps(ic)}`")
    iv = pde.get("initial_velocity")
    if iv is not None:
        parts.append(f"**Initial velocity:** `{json.dumps(iv)}`")

    bc = oc.get("bc", {})
    if bc.get("dirichlet") is not None:
        parts.append(f"**Dirichlet BC:** `{json.dumps(bc['dirichlet'])}`")
    if "periodic" in bc:
        parts.append(f"**Periodic BC:** `{json.dumps(bc['periodic'])}`")

    time_cfg = pde.get("time")
    if time_cfg:
        parts.append(
            f"**Time integration:** t in [{time_cfg.get('t0', 0.0)}, "
            f"{time_cfg['t_end']}], dt = {time_cfg.get('dt', 0.01)}"
        )

    # numerical warnings (reference :425-492)
    warnings = []
    stab = params.get("stabilization") or oc.get("oracle_solver", {}).get(
        "stabilization"
    )
    if t == "convection_diffusion" and stab == "supg":
        warnings.append(
            "This case is convection-dominated: a plain Galerkin "
            "discretization will oscillate. Add SUPG (streamline upwind "
            "Petrov-Galerkin) stabilization with tau ~ h / (2 |beta|)."
        )
    if t == "wave":
        warnings.append(
            "Use an implicit, unconditionally stable scheme (Newmark "
            "theta = 1/4) — explicit leapfrog at this dt may be unstable."
        )
    if t == "burgers":
        warnings.append(
            "Semi-implicit stepping (lag the convection coefficient at "
            "u^n, keep diffusion implicit) avoids a nonlinear solve per step."
        )
    if t in ("stokes", "navier_stokes"):
        warnings.append(
            "Use an inf-sup stable velocity/pressure pair (P2-P1) and fix "
            "the pressure nullspace (pin one pressure value)."
        )
    if warnings:
        parts.append("\n## Numerical Warnings\n")
        parts.extend(f"- {w}" for w in warnings)

    # output contract
    grid = oc["output"]["grid"]
    nz_line = f", nz = {grid['nz']}" if grid.get("nz") else ""
    nan_note = (
        _NAN_NOTE_COMPLEX
        if oc["domain"].get("type") not in ("unit_square", "unit_cube",
                                            "periodic_square")
        else ""
    )
    parts.append(
        _OUTPUT_CONTRACT.format(
            bbox=grid["bbox"], nx=grid["nx"], ny=grid["ny"],
            nz_line=nz_line, nan_note=nan_note,
        )
    )

    # interface contract
    if solver_library == "cpp":
        parts.append(_CPP_CONTRACT)
    else:
        lib_note = (
            "/torch (with pdebench_tpu_torch importable)"
            if solver_library == "torch"
            else ""
        )
        parts.append(_PY_CONTRACT.replace("{lib_note}", lib_note))

    # agent knobs, anchoring ranges stripped (reference :741-751)
    knobs = case.get("agent_knobs")
    if knobs:
        clean = [
            k.split("(")[0].strip() if isinstance(k, str) else k for k in knobs
        ]
        parts.append(f"\n**You control:** {', '.join(map(str, clean))}")

    # pass/fail thresholds (reference :753-770)
    if oracle_info:
        ec = case.get("evaluation_config", {})
        acc_tol = ec.get("accuracy_tolerance")
        time_tol = ec.get("time_tolerance", 3)
        oe = oracle_info.get("error")
        ot = oracle_info.get("time")
        parts.append("\n## Pass Criteria\n")
        if acc_tol is not None and oe is not None:
            target_err = max(oe * acc_tol, 1e-6)
            parts.append(
                f"- accuracy: relative L2 error vs the reference solution "
                f"<= {target_err:.3e}"
            )
        if ot is not None:
            parts.append(
                f"- time: your solve wall-clock <= {ot * time_tol:.2f} s"
            )
        parts.append(
            f"- timeout: {ec.get('timeout_sec', 300)} s hard limit"
        )

    guide = _load_guide(solver_library)
    if guide:
        parts.append("\n## API Guide\n")
        parts.append(guide)

    parts.append(
        "\nRespond with ONLY the complete solver code in a single code block."
    )
    return "\n".join(parts)
