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
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

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
    symbolic._lambdify_raw.cache_clear()
    from ..fem import geometry

    geometry._mesh_domain_cached.cache_clear()


# ---------------------------------------------------------------------------
# Mesh factory
# ---------------------------------------------------------------------------


def build_mesh(domain_spec: Dict[str, Any], mesh_spec: Dict[str, Any]) -> Mesh:
    """Mesh a case domain (reference: base.py build_mesh): unit_square,
    unit_cube, periodic_square (a rectangle mesh whose opposite sides the
    function spaces identify), and every other 2-D domain through
    `geometry.mesh_domain` at edge length 1 / resolution: the axis-aligned
    rectilinear ones (l_shape, t_junction) as exact structured masked
    triangulations, the rest by the signed-distance mesher. An unknown
    domain type raises ValueError."""
    resolution = int(mesh_spec.get("resolution", 16))
    domain_type = domain_spec["type"]
    cell_type = mesh_spec.get("cell_type", "triangle")

    if domain_type == "unit_square":
        ct = "quadrilateral" if cell_type == "quadrilateral" else "triangle"
        return meshmod.unit_square_mesh(resolution, ct)
    if domain_type == "unit_cube":
        return meshmod.unit_cube_mesh(resolution)
    if domain_type == "periodic_square":
        params = domain_spec.get("geometry_params", {})
        b = params.get("bounds", params.get("extents", [0.0, 1.0, 0.0, 1.0]))
        x0, x1, y0, y1 = [float(v) for v in b]
        # keep cells near-isotropic on non-square extents
        nx = resolution
        ny = max(int(round(resolution * (y1 - y0) / max(x1 - x0, 1e-300))), 1)
        m = meshmod.rectangle_mesh(nx, ny, (x0, x1, y0, y1), "triangle")
        m.periodic = (x0, x1, y0, y1)
        return m

    from ..fem import geometry

    return geometry.mesh_domain(domain_type, domain_spec, 1.0 / float(resolution))


def lattice_free_domain(domain_spec: Dict[str, Any]) -> bool:
    """Whether a domain's meshes never form a lattice, decided from its
    spec before any meshing: periodic_square (the lattice detection
    refuses wrap-around offsets) and the domains of the signed-distance
    mesher. The rectilinear l_shape and t_junction domains may form one
    (a t_junction filling under 40% of its box does not: that shows only
    after meshing)."""
    from ..fem import geometry

    dtype = domain_spec["type"]
    if dtype in ("unit_square", "unit_cube"):
        return False
    return dtype == "periodic_square" or geometry.rectilinear_outline(dtype, domain_spec) is None


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


def _dirichlet_segments(space: FunctionSpace, bc_spec: Dict[str, Any]):
    """A case's Dirichlet spec as its segments, in order: per segment
    (dof coordinates of its scalar dofs, its blocked dofs, one value
    function fn(points, t) per component, whether it depends on t).
    Handles 'on': 'all' | side | list of {on, value} segments, and scalar
    or vector (list) value expressions."""
    d = bc_spec.get("dirichlet")
    if d is None:
        return []
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
    out = []
    for seg in segments:
        sdofs = space.boundary_dofs_on(seg.get("on", "all"))
        value = seg.get("value", 0.0)
        exprs = value if isinstance(value, (list, tuple)) else [value] * ncomp
        if len(exprs) != ncomp:
            raise ValueError(f"BC value arity {len(exprs)} != ncomp {ncomp}")
        comp_fns = [symbolic.lambdify_numpy(e, dim, with_time=True) for e in exprs]
        blocked = (sdofs[:, None] * ncomp + np.arange(ncomp)[None, :]).reshape(-1)
        seg_time = any(symbolic.depends_on_t(e) for e in exprs)
        out.append((space.dof_coords[sdofs], blocked, comp_fns, seg_time))
    return out


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
    segs = _dirichlet_segments(space, bc_spec)
    if not segs:
        return np.zeros(0, dtype=np.int64), np.zeros(0), None
    any_time = any(seg_time for _, _, _, seg_time in segs)
    dofs = np.concatenate([blocked for _, blocked, _, _ in segs])

    def value_fn(tv: float) -> np.ndarray:
        return np.concatenate([
            np.stack([f(pts, tv) for f in comp_fns], axis=1).reshape(-1)  # (n, ncomp)
            for pts, _, comp_fns, _ in segs
        ])

    t0 = 0.0 if t is None else float(t)
    values = value_fn(t0)
    # dedupe (corner dofs may appear in several segments; keep unique for
    # mask construction)
    uniq, first = np.unique(dofs, return_index=True)
    return uniq, values[first], (value_fn if any_time else None)


def dirichlet_traceable(
    space: FunctionSpace, bc_spec: Dict[str, Any], device
) -> Tuple[np.ndarray, Callable[[float], torch.Tensor]]:
    """Dirichlet values at any time, for step loops: (bc_dofs (blocked,
    unique), g_fn) where g_fn(t) is a float64 tensor of length ndof on
    `device`, the segments' values written at their dofs in segment order
    (a dof on several segments takes the LAST one's value, as the
    reference's g.at[blocked].set loop does; dirichlet_dofs_values keeps
    the first), zeros elsewhere."""
    segs = _dirichlet_segments(space, bc_spec)
    device = torch.device(device)
    if not segs:
        return np.zeros(0, dtype=np.int64), lambda t: torch.zeros(
            space.ndof, dtype=torch.float64, device=device
        )
    bc_dofs = np.unique(np.concatenate([blocked for _, blocked, _, _ in segs]))

    def g_fn(t: float) -> torch.Tensor:
        g = np.zeros(space.ndof)
        for pts, blocked, comp_fns, _ in segs:
            g[blocked] = np.stack([f(pts, float(t)) for f in comp_fns], axis=1).reshape(-1)
        return torch.as_tensor(g, device=device)

    return bc_dofs, g_fn


def time_params(pde_cfg: Dict[str, Any], default_t_end=0.1, default_dt=0.01):
    """(t0, t_end, dt, num_steps) from a case's pde.time block.

    num_steps = int((t_end - t0)/dt + 0.5), the rounding of the
    reference's heat and wave oracles."""
    tc = pde_cfg.get("time", {}) or {}
    t0 = float(tc.get("t0", 0.0))
    t_end = float(tc.get("t_end", pde_cfg.get("t_final", default_t_end)))
    dt = float(tc.get("dt", pde_cfg.get("dt", default_dt)))
    num_steps = max(int((t_end - t0) / dt + 0.5), 1)
    return t0, t_end, dt, num_steps


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


def interpolate_nodal(
    space: FunctionSpace,
    exprs: Union[ExprLike, Sequence[ExprLike]],
    t: Optional[float] = None,
) -> np.ndarray:
    """Nodal interpolation: evaluate expression(s) at dof coordinates
    (equispaced Lagrange nodes). Returns (ndof,) blocked for vector
    spaces (host numpy)."""
    dim = space.mesh.dim

    def at_nodes(e):
        fn = symbolic.lambdify_numpy(e, dim, with_time=t is not None)
        return fn(space.dof_coords, t) if t is not None else fn(space.dof_coords)

    if isinstance(exprs, (list, tuple)):
        return np.stack([at_nodes(e) for e in exprs], axis=1).reshape(-1)
    if space.ncomp != 1:
        raise ValueError("scalar expression on vector space")
    return at_nodes(exprs)


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


def timed_run(run: Callable[[], Tuple[Any, Dict[str, Any]]], device) -> Tuple[Any, float, float]:
    """Execute `run`, which returns (grid, info), cold and then warm, each
    pass synchronised, under the reference's timing switches, read here at
    call time: PDEBENCH_TPU_WARM_REPEATS=N warm passes (default 1), the
    fastest kept; PDEBENCH_TPU_COLD_TIMING=1 no warm pass, the cold time
    reported as t_warm. Returns (the last pass's (grid, info), t_warm,
    t_cold); info gains the protocol as it ran: "warm_passes" (0 under
    cold timing), "warm_pass_s" (each warm pass's wall time) and
    "cold_timing". (The reference's retry of a warm pass slower than its
    cold one, a remote-TPU stall, is not ported.)"""
    cold = os.environ.get("PDEBENCH_TPU_COLD_TIMING", "0") == "1"
    repeats = 0 if cold else max(int(os.environ.get("PDEBENCH_TPU_WARM_REPEATS", "1")), 1)
    t0 = time.perf_counter()
    result = run()
    synchronize(device)
    t_cold = time.perf_counter() - t0
    passes = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        result = run()
        synchronize(device)
        passes.append(time.perf_counter() - t1)
    result[1].update(warm_passes=repeats, warm_pass_s=passes, cold_timing=cold)
    return result, (t_cold if cold else min(passes)), t_cold


def solver_opts(config: Dict[str, Any]) -> Dict[str, Any]:
    o = dict(config.get("oracle_solver", {}))
    o.setdefault("ksp_type", "cg")
    o.setdefault("pc_type", "jacobi")
    o.setdefault("rtol", 1e-10)
    o.setdefault("atol", 1e-14)
    return o
