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
from ..fem.assemble import (
    CellBatch,
    GatherSum,
    bc_mask_values,
    cell_batch,
    local_load,
    local_vector_load,
)
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

    def gather_sum(self) -> GatherSum:
        """The fixed-order sum of cell contributions into the space's dofs
        (blocked for a vector space), made once per geometry and device:
        index_add_'s atomics would vary the last bits from solve to solve
        on the card, and an iterative solve's round count with them."""
        space = self.space
        return base.memo_geometry(
            [
                "scalar-gather", self.config["domain"], self.config.get("mesh", {}),
                int(self.config.get("fem", {}).get("degree", 1)), space.ncomp, str(self.device),
            ],
            lambda: GatherSum(space.dofmap, space.ndof, self.device),
        )

    def load_vector(self, f_q) -> torch.Tensor:
        """∫ f . v: f_q (n_cells, nq) on a scalar space, or (n_cells, nq,
        d) on a vector space (interleaved components, the blocked dofmap's
        order)."""
        if self.space.ncomp == 1:
            vals = local_load(self.cb, f_q)
        else:
            vals = local_vector_load(self.cb, f_q)
        return self.gather_sum()(torch.as_tensor(vals, device=self.device))

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

    2-D and 3-D lattices are taken on every device. (The reference keeps
    3-D lattices off on its CPU branch, which leads to AMG; the port has
    no AMG, and pins the reference to the lattice route in its CPU parity
    tests with PDEBENCH_TPU_FORCE_STENCIL=1.)
    """
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


def attach_gmg(lat32, ndof: int, mask_np: np.ndarray) -> Optional[str]:
    """Attach a stencil-GMG hierarchy, coarsened from the operator's own
    constrained weights, to a 2-D or 3-D lattice operator of GMG_MIN_DOFS
    dofs or more; no-op otherwise. Returns None, or why the hierarchy
    could not be built (the coarsest level too large to invert): the
    operator then keeps no hierarchy and its solves take Jacobi, as in
    the reference, and the caller records the reason. Other exceptions
    are faults and propagate."""
    from ..solvers.dispatch import GMG_MIN_DOFS
    from ..solvers.gmg import attach_lattice_gmg

    if len(lat32.shape) not in (2, 3) or ndof < GMG_MIN_DOFS:
        return None
    try:
        attach_lattice_gmg(lat32, np.asarray(mask_np))
    except ValueError as e:
        lat32.gmg = None
        return f"{e}"
    return None


def stencil_appliers64(lat32, dofmap, *A_locals) -> Optional[list]:
    """Float64 dof-order appliers of cell-local operators that share
    lat32's lattice (a step loop's mass matrix), or None where the cells'
    node pairs reach further than the weight map takes. Returns one
    fn(v_dof) -> A v per A_local: the weights scattered once on the host
    in a fixed order, every apply one stencil kernel launch (its plain
    version on CPU tensors) from the weight map's plan."""
    from ..solvers.stencil import lattice_weight_map

    wmap = lattice_weight_map(lat32.lattice, np.asarray(dofmap))
    if wmap is None:
        return None
    lattice, inv = lat32.lattice, lat32.inv_j

    def make(A_local):
        W64 = torch.as_tensor(wmap.weights_np(A_local), device=lat32.device)

        def apply64(v: torch.Tensor) -> torch.Tensor:
            v_lat = lattice.embed(v, 0.0).reshape(wmap.shape)
            return wmap.apply_grid(W64, v_lat).reshape(-1)[inv]

        return apply64

    return [make(a) for a in A_locals]


# the reference's size gate of the bilinear weight build: its host tensor
# T has n_cells * nl^3 entries (reference reaction_diffusion.py:181,
# burgers.py:135)
BILINEAR_MAX_ENTRIES = 3e7


def bilinear_step_lattice(ctx: ScalarContext, A_const, T_fn: Callable):
    """The pieces of a per-step operator A_const + N(u), N linear in a
    nodal field u with cell tensor T (c, nl, nl, nl): (lat32, wmap, bwm),
    A_const's f32 lattice operator with the hierarchy that preconditions
    every step, the weight map of the cells' node pairs on its lattice
    (the step weights' offsets) and the bilinear map of T_fn() on it, or
    None where T would hold more than BILINEAR_MAX_ENTRIES (the reference
    then scatters each step's cell batch through the weight map).

    Returns None where the reference leaves the lattice for its
    cell-local step solve: the dofs form no lattice, no hierarchy attaches
    (fewer than GMG_MIN_DOFS dofs, or its coarsest level too large), or
    the node pairs reach beyond the weight map's pad."""
    from ..solvers.stencil import BilinearLatticeWeightMap, lattice_weight_map

    space = ctx.space
    lat32 = maybe_lattice32(ctx, A_const)
    if lat32 is None:
        return None
    attach_gmg(lat32, space.ndof, ctx.mask.cpu().numpy())
    wmap = lattice_weight_map(lat32.lattice, space.dofmap_scalar) if lat32.gmg is not None else None
    if wmap is None:
        return None
    c, nl = space.dofmap_scalar.shape
    if c * nl**3 > BILINEAR_MAX_ENTRIES:
        return lat32, wmap, None
    return lat32, wmap, BilinearLatticeWeightMap(wmap, lat32.lattice, space.dofmap_scalar, T_fn())


def maybe_block_lattice32(ctx: ScalarContext, A_local) -> Optional[object]:
    """Block-stencil (f32) form of a VECTOR operator on a node lattice
    (structured meshes); None otherwise. 3-D block lattices have no
    kernel (the reference's block levels are 2-D only): they stay off on
    the CPU and raise on CUDA."""
    if ctx.mesh.dim == 3:
        if ctx.device.type == "cuda":
            raise NotImplementedError("3-D lattice routes are not ported to CUDA yet")
        return None
    from ..solvers.stencil import block_lattice_operator_from_local

    A_np = (
        A_local.detach().cpu().numpy()
        if isinstance(A_local, torch.Tensor)
        else np.asarray(A_local)
    )
    return block_lattice_operator_from_local(
        A_np,
        ctx.space.dofmap,
        ctx.space.ndof,
        ctx.space.dof_coords,
        ctx.space.ncomp,
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


def merge_reference_config(
    config: Dict[str, Any], refine_dt: Optional[float] = None
) -> Dict[str, Any]:
    """Overlay a case's reference_config for the finer re-solve.

    refine_dt: the transient oracles pass dt * 0.5, the re-solve's step
    when reference_config carries no `time` of its own; a `time` there
    overlays pde.time key by key (the case keeps its t0 and t_end)."""
    ref = config.get("reference_config", {})
    out = copy.deepcopy(config)
    out.pop("reference_config", None)
    if refine_dt is not None and "time" not in ref:
        out.setdefault("pde", {}).setdefault("time", {})["dt"] = float(refine_dt)
    for key, val in ref.items():
        if key == "time" and isinstance(val, dict):
            out.setdefault("pde", {}).setdefault("time", {}).update(val)
        elif isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key].update(val)
        else:
            out[key] = val
    return out
