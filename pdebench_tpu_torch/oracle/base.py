"""Shared oracle machinery: spec -> mesh/space/coefficients/BCs/sampling.

Each per-PDE solver module composes these pieces; this module owns the
case-spec conventions (mesh factory, coefficient fields, Dirichlet data,
exact-grid evaluation, solver options, timing).

Timing policy: `baseline_time` is the wall clock of the warm compute path
(host setup + device execute + grid sampling), measured after one warm-up
execution, so one-time work (CUDA context and library initialisation,
kernel builds) is excluded. The cold time is reported alongside in
solver_info["t_cold"]. Device work is waited for with
torch.cuda.synchronize() inside every timed region.

Port of pdebench_tpu/oracle/base.py (the parts the scalar oracles use).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem import mesh as meshmod
from ..fem import sampling, symbolic
from ..fem.mesh import Mesh
from ..fem.spaces import FunctionSpace

ExprLike = symbolic.ExprLike


# ---------------------------------------------------------------------------
# Cross-case geometry memoization
# ---------------------------------------------------------------------------

_GEOM_CACHE: "dict" = {}
_GEOM_CACHE_MAX = 6


def memo_geometry(key_obj, builder: Callable[[], Any]) -> Any:
    """Memoize per-(domain, resolution, degree) geometry artifacts.

    Mesh generation, dof maps, point location and quadrature batches are
    pure functions of the case's (domain, mesh, fem) spec; across cases
    (and across a case's main + reference_config re-solve) they repeat.
    The cached objects are treated as immutable everywhere, so sharing is
    safe. Small LRU; `clear_setup_caches` empties it.
    """
    try:
        key = json.dumps(key_obj, sort_keys=True)
    except TypeError:
        # a non-JSON key component disables caching rather than risking
        # a collision through a truncated repr
        return builder()
    if key in _GEOM_CACHE:
        val = _GEOM_CACHE.pop(key)
        _GEOM_CACHE[key] = val  # move to MRU
        return val
    val = builder()
    _GEOM_CACHE[key] = val
    while len(_GEOM_CACHE) > _GEOM_CACHE_MAX:
        _GEOM_CACHE.pop(next(iter(_GEOM_CACHE)))
    return val


def geom_cache_has(key_obj) -> bool:
    """True if memo_geometry would hit."""
    try:
        return json.dumps(key_obj, sort_keys=True) in _GEOM_CACHE
    except TypeError:
        return False


def clear_setup_caches() -> None:
    """Drop every process-level setup cache (geometry + sympy parse/
    lambdify), restoring cold per-case setup costs."""
    _GEOM_CACHE.clear()
    symbolic._parse_str.cache_clear()
    symbolic._lambdify_numpy_cached.cache_clear()


# ---------------------------------------------------------------------------
# Mesh factory
# ---------------------------------------------------------------------------


def build_mesh(domain_spec: Dict[str, Any], mesh_spec: Dict[str, Any]) -> Mesh:
    """Mesh a case domain: unit_square and unit_cube so far."""
    resolution = int(mesh_spec.get("resolution", 16))
    domain_type = domain_spec["type"]
    cell_type = mesh_spec.get("cell_type", "triangle")

    if domain_type == "unit_square":
        ct = "quadrilateral" if cell_type == "quadrilateral" else "triangle"
        return meshmod.unit_square_mesh(resolution, ct)
    if domain_type == "unit_cube":
        return meshmod.unit_cube_mesh(resolution)
    raise NotImplementedError(
        f"domain {domain_type!r} is not ported yet (unit_square, unit_cube)"
    )


# ---------------------------------------------------------------------------
# Coefficients & expressions
# ---------------------------------------------------------------------------


def coefficient_fn(
    spec: Optional[Dict[str, Any]], dim: int, device, default: float = 1.0
) -> Callable:
    """kappa-style coefficient: constant or expression of x[, y, z].

    Returns fn(points (..., dim)) -> float64 tensor (...,) on `device`
    (evaluated at quadrature points directly).
    """
    if spec is None:
        spec = {"type": "constant", "value": default}
    if spec.get("type") == "constant":
        val = float(spec.get("value", default))
        return lambda pts: torch.full(
            tuple(pts.shape[:-1]), val, dtype=torch.float64, device=device
        )
    if spec.get("type") == "expr":
        return symbolic.lambdify_spatial(spec["expr"], dim, device)
    raise ValueError(f"unknown coefficient spec {spec}")


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions
# ---------------------------------------------------------------------------


def dirichlet_dofs_values(
    space: FunctionSpace,
    bc_spec: Dict[str, Any],
    t: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[Callable]]:
    """Resolve a case's Dirichlet spec to (blocked dofs, values, value_fn(t)).

    Handles 'on': 'all' | side | list of {on, value} segments, and scalar
    or vector (list) value expressions. value_fn is returned for
    time-dependent BCs: value_fn(t) -> values at the same dofs.
    """
    d = bc_spec.get("dirichlet")
    if d is None:
        return np.zeros(0, dtype=np.int64), np.zeros(0), None

    segments: List[Dict[str, Any]]
    if isinstance(d, list):
        segments = d
    else:
        on = d.get("on", "all")
        if isinstance(on, list):
            segments = [{"on": o, "value": d.get("value", 0.0)} for o in on]
        else:
            segments = [d]

    ncomp = space.ncomp
    dim = space.mesh.dim
    all_dofs: List[np.ndarray] = []
    fns: List[Tuple[np.ndarray, List[Callable], bool]] = []
    any_time = False

    for seg in segments:
        on = seg.get("on", "all")
        sdofs = space.boundary_dofs_on(on)
        value = seg.get("value", 0.0)
        exprs = value if isinstance(value, (list, tuple)) else [value] * ncomp
        if len(exprs) != ncomp:
            raise ValueError(f"BC value arity {len(exprs)} != ncomp {ncomp}")
        seg_time = any(symbolic.depends_on_t(e) for e in exprs)
        any_time = any_time or seg_time
        comp_fns = [
            symbolic.lambdify_numpy(e, dim, with_time=True) for e in exprs
        ]
        fns.append((sdofs, comp_fns, seg_time))
        blocked = (sdofs[:, None] * ncomp + np.arange(ncomp)[None, :]).reshape(-1)
        all_dofs.append(blocked)

    dofs = np.concatenate(all_dofs) if all_dofs else np.zeros(0, dtype=np.int64)

    def value_fn(tv: float) -> np.ndarray:
        out = []
        for sdofs, comp_fns, _ in fns:
            pts = space.dof_coords[sdofs]
            vals = np.stack([f(pts, tv) for f in comp_fns], axis=1)  # (n, ncomp)
            out.append(vals.reshape(-1))
        return np.concatenate(out) if out else np.zeros(0)

    t0 = 0.0 if t is None else float(t)
    values = value_fn(t0)
    # dedupe (corner dofs may appear in several segments; keep unique for
    # mask construction)
    uniq, first = np.unique(dofs, return_index=True)
    return uniq, values[first], (value_fn if any_time else None)


# ---------------------------------------------------------------------------
# Exact solutions & baseline error
# ---------------------------------------------------------------------------


def exact_grid_scalar(
    expr: ExprLike,
    grid: Dict[str, Any],
    mask_from: Optional[np.ndarray] = None,
    t: Optional[float] = None,
) -> np.ndarray:
    """Analytic (machine-precision) exact solution on the output grid;
    the FEM solve's domain mask (NaNs) is then applied."""
    pts, shape = sampling.grid_points(grid)
    dim = pts.shape[1]
    fn = symbolic.lambdify_numpy(expr, dim, with_time=t is not None)
    vals = fn(pts, t) if t is not None else fn(pts)
    out = vals.reshape(shape)
    if mask_from is not None:
        out = np.where(np.isnan(mask_from), np.nan, out)
    return out


def exact_grid_vector_magnitude(
    exprs: Sequence[ExprLike],
    grid: Dict[str, Any],
    mask_from: Optional[np.ndarray] = None,
    t: Optional[float] = None,
) -> np.ndarray:
    pts, shape = sampling.grid_points(grid)
    dim = pts.shape[1]
    comps = []
    for e in exprs:
        fn = symbolic.lambdify_numpy(e, dim, with_time=t is not None)
        comps.append(fn(pts, t) if t is not None else fn(pts))
    mag = np.linalg.norm(np.stack(comps, axis=1), axis=1).reshape(shape)
    if mask_from is not None:
        mag = np.where(np.isnan(mask_from), np.nan, mag)
    return mag


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def synchronize(device) -> None:
    """Wait for queued work on a CUDA device (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def charge_setup(ctx, fn: Callable[[], Any]) -> Any:
    """Run one-time pipeline work NOW and charge its wall time to
    ctx.t_setup.

    Hoists per-case constants (host assembly, host->device transfers) out
    of the timed run(). The first call absorbs one-time initialisation;
    the second is measured and charged, so baseline_time = t_setup + warm
    counts the work exactly once.
    """
    fn()
    synchronize(ctx.device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(ctx.device)
    ctx.t_setup += time.perf_counter() - t0
    return out


def timed_run(run: Callable[[], Any], device) -> Tuple[Any, float, float]:
    """Execute `run` cold, then warm: returns (result, t_warm, t_cold)."""
    t0 = time.perf_counter()
    run()
    synchronize(device)
    t_cold = time.perf_counter() - t0
    t1 = time.perf_counter()
    result = run()
    synchronize(device)
    return result, time.perf_counter() - t1, t_cold


def solver_opts(config: Dict[str, Any]) -> Dict[str, Any]:
    o = dict(config.get("oracle_solver", {}))
    o.setdefault("ksp_type", "cg")
    o.setdefault("pc_type", "jacobi")
    o.setdefault("rtol", 1e-10)
    o.setdefault("atol", 1e-14)
    return o
