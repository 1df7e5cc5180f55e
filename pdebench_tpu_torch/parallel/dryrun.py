"""The multi-device dry run and the rank-side functions of the
multi-device checks.

    from pdebench_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, "cuda")   # or "cpu": 4 gloo ranks on the host

runs the reference's five legs (pdebench_tpu/__graft_entry__.py's
dryrun_multichip, :107-186) on n ranks, one process each
(parallel/group.launch), with the reference's sizes and checks:

  1  cell-parallel Poisson (sharded.py) at n = 8: converged, finite
  2  stripe-partitioned elasticity (halo.py, block stencil) at 4 n
  3  the dataset's `poisson_p2` at mesh resolution 48 through
     dispatch's halo route (PDEBENCH_TPU_HALO=1): pc_used names
     halo-sharded, baseline_error < 1e-2
  4  `poisson_3d_smooth_trig` at resolution 16 through the same route
  5  the Taylor-Hood saddle (HaloSaddleOperator, MINRES) at n = 8

The other functions here run on every rank under `launch` (they take the
rank's Group first, and return picklable values: numpy arrays, numbers,
dicts) for the tests and chip_smoke.py; `run_legs` runs several of them in
one launch. `check_halo_route` holds an `oracle_solve` result to the
single-device solve (chip_smoke.py's phase 20b and
scripts/torch_halo_ranks.py).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .group import Group, launch

DATASET = Path(__file__).resolve().parents[2] / "data" / "benchmark_v2.jsonl"
# the halo route's grid against the single-device grid, relative: the
# bound of the reference's dataset-case test (tests/test_parallel.py:200-221)
HALO_GRID_TOL = 1e-7


def load_case(case_id: str, path: Path = DATASET) -> Dict[str, Any]:
    """The dataset record of `case_id`."""
    with open(path) as f:
        for line in f:
            case = json.loads(line)
            if case["id"] == case_id:
                return case
    raise KeyError(case_id)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _launches() -> int:
    from ..solvers import stencil_kernel

    return stencil_kernel.LAUNCHES


def run_legs(group: Group, legs: Sequence[Tuple[Callable, tuple]]) -> List[Any]:
    """[fn(group, *args) for each (fn, args)]: several checks in one launch."""
    return [fn(group, *args) for fn, args in legs]


def sharded_apply(group: Group, A_local, dofmap, ndof: int, u) -> Tuple[np.ndarray, np.ndarray]:
    """ShardedOperator's matvec of u and its diagonal."""
    from .sharded import ShardedOperator

    op = ShardedOperator(A_local, dofmap, ndof, group)
    return _host(op(torch.as_tensor(u, device=group.device))), _host(op.diagonal())


def halo_apply(group: Group, W, offsets, ncomp: int, u) -> Dict[str, Any]:
    """HaloStencilOperator's apply of the full grid u (its stripes
    gathered): `y`, and `launches`, each rank's kernel launches."""
    from .halo import HaloStencilOperator

    op = HaloStencilOperator(W, offsets, group, ncomp=ncomp, dtype=torch.as_tensor(W).dtype)
    before = _launches()
    y = op.crop_grid(op(op.pad_grid(u)))
    return {"y": _host(y), "launches": group.gather_objects(_launches() - before)}


def halo_cg_solve(group: Group, W, offsets, ncomp: int, b, mask, g, rtol: float) -> Dict[str, Any]:
    """halo_pcg on the given weights and full grids."""
    from .halo import HaloStencilOperator, halo_pcg

    op = HaloStencilOperator(W, offsets, group, ncomp=ncomp)
    x, info = halo_pcg(op, b, mask, g, rtol=rtol)
    return {"x": _host(x), "iterations": info.iterations, "residual": info.residual,
            "converged": bool(info.converged)}


def step_leg(group: Group, name: str, n: int, rtol: float = 1e-8) -> Dict[str, Any]:
    """One of the dry run's model solves: "poisson" (cell-parallel),
    "elasticity" or "stokes" (stripe-partitioned), on an n x n unit
    square; the solution (full, on the host), iterations and residual."""
    from .halo import sharded_elasticity_step, sharded_stokes_step
    from .sharded import sharded_poisson_step

    build = {"poisson": sharded_poisson_step, "elasticity": sharded_elasticity_step,
             "stokes": sharded_stokes_step}[name]
    step, args = build(n, group, rtol=rtol)
    t0 = time.perf_counter()
    x, iterations, residual = step(*args)
    return {"x": _host(x), "iterations": int(iterations), "residual": float(residual),
            "seconds": time.perf_counter() - t0}


def oracle_solve(group: Group, config: Dict[str, Any]) -> Dict[str, Any]:
    """OracleSolver(device=the rank's device).solve(config) with
    dispatch's halo route switched on (PDEBENCH_TPU_HALO=1): the grid,
    baseline_error and _time, solver_info, each rank's stencil kernel
    launches, and the device type."""
    from ..oracle import OracleSolver

    before = _launches()
    prior = os.environ.get("PDEBENCH_TPU_HALO")
    os.environ["PDEBENCH_TPU_HALO"] = "1"
    try:
        r = OracleSolver(device=group.device).solve(config)
    finally:
        if prior is None:
            os.environ.pop("PDEBENCH_TPU_HALO")
        else:
            os.environ["PDEBENCH_TPU_HALO"] = prior
    return {"grid": r.reference, "baseline_error": float(r.baseline_error),
            "baseline_time": float(r.baseline_time), "solver_info": r.solver_info,
            "launches": group.gather_objects(_launches() - before), "device": group.device.type}


def grid_rel(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| over the sites where both grids are defined;
    raises where they are NaN at different sites."""
    _check(bool((np.isnan(a) == np.isnan(b)).all()), "the grids are NaN at different sites")
    both = ~np.isnan(b)
    return float(np.linalg.norm(a[both] - b[both]) / np.linalg.norm(b[both]))


def check_halo_route(cid: str, got: Dict[str, Any], single_grid: np.ndarray, ranks: int) -> float:
    """Hold rank 0's `oracle_solve` result for case `cid` on `ranks` ranks
    to the single-device solve's grid: the route is
    jacobi+halo-sharded[ranks], the grid within HALO_GRID_TOL,
    baseline_error < 1e-2 (the reference's test), and where the ranks ran
    on a card every rank launched the stencil kernel. Returns the grid's
    relative distance; raises RuntimeError on a failed check."""
    info = got["solver_info"]
    rel = grid_rel(got["grid"], single_grid)
    _check(info["pc_used"] == f"jacobi+halo-sharded[{ranks}]",
           f"{cid} on {ranks} ranks: halo route not taken: {info.get('pc_used')}")
    _check(rel < HALO_GRID_TOL, f"{cid} on {ranks} ranks: grid {rel:.3e} from the single-device grid")
    _check(got["baseline_error"] < 1e-2, f"{cid} on {ranks} ranks: error {got['baseline_error']}")
    _check(got["device"] == "cpu" or min(got["launches"]) >= 1,
           f"{cid} on {ranks} ranks: a rank never launched the stencil kernel: {got['launches']}")
    return rel


def dryrun_legs(group: Group) -> Dict[str, Any]:
    """The five legs on this rank (see the module docstring); raises on a
    failed check. Returns each leg's iterations, residual or error."""
    out = {}
    leg = step_leg(group, "poisson", 8)
    _check(bool(np.all(np.isfinite(leg["x"]))), "cell-parallel Poisson: non-finite solution")
    _check(leg["residual"] < 1e-6, f"cell-parallel CG did not converge: residual {leg['residual']}")
    out["poisson_cells"] = {k: leg[k] for k in ("iterations", "residual", "seconds")}

    leg = step_leg(group, "elasticity", 4 * group.size)
    _check(bool(np.all(np.isfinite(leg["x"]))), "halo elasticity: non-finite solution")
    _check(leg["residual"] < 1e-6, f"halo PCG did not converge: residual {leg['residual']}")
    out["elasticity_halo"] = {k: leg[k] for k in ("iterations", "residual", "seconds")}

    for name, cid, res in (("poisson_p2", "poisson_p2", 48),
                           ("poisson_3d", "poisson_3d_smooth_trig", 16)):
        oc = load_case(cid)["oracle_config"]
        oc.setdefault("mesh", {})["resolution"] = res
        r = oracle_solve(group, oc)
        info = r["solver_info"]
        _check("halo-sharded" in info.get("pc_used", ""), f"{cid}: halo route not taken: {info}")
        _check(r["baseline_error"] < 1e-2, f"{cid}: halo-route error {r['baseline_error']}")
        out[name] = {"baseline_error": r["baseline_error"], "pc_used": info["pc_used"],
                     "iterations": info["iterations"], "launches": r["launches"],
                     "t_warm": info["t_warm"]}

    leg = step_leg(group, "stokes", 8)
    _check(bool(np.all(np.isfinite(leg["x"]))), "halo saddle: non-finite solution")
    _check(leg["residual"] < 1e-5, f"saddle MINRES did not converge: residual {leg['residual']}")
    out["stokes_halo"] = {k: leg[k] for k in ("iterations", "residual", "seconds")}
    out["backend"] = group.describe()
    out["ranks"] = group.size
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, Any]:
    """The five legs on `n_devices` ranks on `device` ("cuda": a card
    each where there are enough, else the ranks share one; "cpu": gloo
    ranks on the host). Raises on a failed check; returns rank 0's
    summary."""
    return launch(dryrun_legs, n_devices, device)
