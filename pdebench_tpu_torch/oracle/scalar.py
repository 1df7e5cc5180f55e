"""Shared scaffold for scalar-field oracle solvers.

A `ScalarContext` bundles everything a scalar PDE solver needs: the mesh,
space, quadrature batch, Dirichlet data, output-grid point location, the
device the solve runs on, and the exact-solution hooks. Per-PDE modules
only assemble their weak form and drive the solve.

Port of pdebench_tpu/oracle/scalar.py (steady scalar parts).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..fem import sampling
from ..fem.assemble import CellBatch, bc_mask_values, cell_batch, local_load, scatter_add
from ..fem.mesh import Mesh
from ..fem.spaces import FunctionSpace
from . import base
from .types import compute_rel_L2_grid


@dataclass
class ScalarContext:
    config: Dict[str, Any]
    device: torch.device
    mesh: Mesh
    space: FunctionSpace
    cb: CellBatch
    grid: Dict[str, Any]
    loc: sampling.PointLocation
    bc_dofs: np.ndarray
    bc_values: np.ndarray
    bc_value_fn: Optional[Callable]  # fn(t) for time-dependent BCs
    mask: torch.Tensor
    g: torch.Tensor
    t_setup: float

    @property
    def dim(self) -> int:
        return self.mesh.dim

    def qpts(self) -> np.ndarray:
        return self.cb.qpts

    def load_vector(self, f_q: torch.Tensor) -> torch.Tensor:
        dofmap = torch.as_tensor(
            self.space.dofmap_scalar, dtype=torch.int64, device=self.device
        )
        return scatter_add(local_load(self.cb, f_q), dofmap, self.space.ndof)

    def sample(self, u: np.ndarray) -> np.ndarray:
        return sampling.sample_on_grid(self.space, u, self.grid, loc=self.loc)


def setup_scalar(
    config: Dict[str, Any],
    device,
    t0: Optional[float] = None,
    ncomp: int = 1,
) -> ScalarContext:
    device = torch.device(device)
    t_start = time.perf_counter()
    degree = int(config.get("fem", {}).get("degree", 1))
    grid = config["output"]["grid"]

    def _build_geom():
        mesh_ = base.build_mesh(config["domain"], config.get("mesh", {}))
        nc = mesh_.dim if ncomp < 0 else ncomp
        space_ = FunctionSpace(mesh_, degree, ncomp=nc)
        pts, _ = sampling.grid_points(grid)
        loc_ = sampling.locate_points(mesh_, pts)
        return mesh_, space_, loc_

    mesh, space, loc = base.memo_geometry(
        [
            "scalar-geom", config["domain"], config.get("mesh", {}),
            degree, ncomp, grid,
        ],
        _build_geom,
    )
    bc_dofs, bc_values, bc_fn = base.dirichlet_dofs_values(
        space, config.get("bc", {}), t=t0
    )
    mask, g = bc_mask_values(space.ndof, bc_dofs, bc_values, device)
    cb = base.memo_geometry(
        ["scalar-cb", config["domain"], config.get("mesh", {}), degree],
        lambda: cell_batch(mesh, degree),
    )
    base.synchronize(device)
    return ScalarContext(
        config=config,
        device=device,
        mesh=mesh,
        space=space,
        cb=cb,
        grid=grid,
        loc=loc,
        bc_dofs=bc_dofs,
        bc_values=bc_values,
        bc_value_fn=bc_fn,
        mask=mask,
        g=g,
        t_setup=time.perf_counter() - t_start,
    )


def maybe_lattice32(ctx: ScalarContext, A_local) -> Optional[object]:
    """Stencil (f32) form of a scalar operator when dofs form a lattice
    (structured unit_square/unit_cube meshes); None otherwise.

    2-D lattices are taken everywhere. 3-D lattices stay off on the CPU,
    as in the reference's CPU branch, and raise on CUDA: their stencil
    and fused-kernel routes are not ported yet.
    """
    if ctx.mesh.dim == 3:
        if ctx.device.type == "cuda":
            raise NotImplementedError("3-D lattice routes are not ported to CUDA yet")
        return None
    from ..solvers.stencil import lattice_operator_from_local

    A_np = (
        A_local.detach().cpu().numpy()
        if isinstance(A_local, torch.Tensor)
        else np.asarray(A_local)
    )
    return lattice_operator_from_local(
        A_np,
        ctx.space.dofmap_scalar,
        ctx.space.ndof,
        ctx.space.dof_coords,
        device=ctx.device,
        dtype=torch.float32,
    )


def mms_baseline_error(
    config: Dict[str, Any],
    fem_grid: np.ndarray,
    t_end: Optional[float] = None,
) -> Optional[float]:
    """rel-L2 vs the analytically-evaluated manufactured solution."""
    mms = config.get("pde", {}).get("manufactured_solution")
    if not mms or "u" not in mms:
        return None
    u = mms["u"]
    if isinstance(u, (list, tuple)):
        exact = base.exact_grid_vector_magnitude(
            u, config["output"]["grid"], mask_from=fem_grid, t=t_end
        )
    else:
        exact = base.exact_grid_scalar(
            u, config["output"]["grid"], mask_from=fem_grid, t=t_end
        )
    return compute_rel_L2_grid(fem_grid, exact)


def override_bc_with_mms(
    config: Dict[str, Any], u_expr
) -> Dict[str, Any]:
    """MMS cases pin u = u_exact on ALL boundary facets, regardless of the
    case's literal bc block."""
    out = copy.deepcopy(config)
    out["bc"] = dict(out.get("bc", {}))
    out["bc"]["dirichlet"] = {"on": "all", "value": u_expr}
    return out


def merge_reference_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay a case's reference_config for the finer re-solve."""
    ref = config.get("reference_config", {})
    out = copy.deepcopy(config)
    out.pop("reference_config", None)
    for key, val in ref.items():
        if key == "time" and isinstance(val, dict):
            out.setdefault("pde", {}).setdefault("time", {}).update(val)
        elif isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key].update(val)
        else:
            out[key] = val
    return out
