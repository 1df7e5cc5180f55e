"""Uniform-grid sampling of FEM functions (the benchmark output contract).

Conventions pinned by the reference (pdebench/oracle/common.py:320-475,
dealii grid_writer.h:11-13):
  - grids are inclusive linspaces over the case's bbox
  - 2-D output is (ny, nx) with result[j, i] = u(x[i], y[j])
  - 3-D output is (nz, ny, nx), C-order flat index iz*ny*nx + iy*nx + ix
  - points with no containing mesh cell are NaN (domain mask)
  - vector fields are sampled as Euclidean magnitude

Point location is a vectorized host-side bucket search (numpy): cells are
binned by bounding box, points joined to candidate cells through a
searchsorted range join, and barycentric/reference coordinates accepted at
-1e-10 tolerance. This replaces the per-point bb-tree loops of the
reference (common.py:337-345) with O(P·K) batched arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from . import refelem
from .mesh import Mesh
from .spaces import FunctionSpace

_TOL = 1e-10
# acceptance band for points marginally OUTSIDE every cell (domain-
# boundary grid lines vs the polygonal mesh boundary); equals the native
# locator's best_def leniency (pdebench_unstructured.hpp)
_TOL_BOUNDARY = 1e-6


@dataclass
class PointLocation:
    cells: np.ndarray  # (P,) int64, -1 where not found
    ref_coords: np.ndarray  # (P, dim)
    found: np.ndarray  # (P,) bool


def locate_points(mesh: Mesh, points: np.ndarray) -> PointLocation:
    pts = np.asarray(points, dtype=np.float64)
    P, dim = pts.shape
    verts = mesh.coords[mesh.cells]  # (C, nv, d)
    C = verts.shape[0]

    lo = verts.min(axis=1)  # (C, d)
    hi = verts.max(axis=1)
    mesh_lo = lo.min(axis=0)
    mesh_hi = hi.max(axis=0)
    span = np.maximum(mesh_hi - mesh_lo, 1e-300)

    # bins sized so a bin holds O(few) cells
    nbins = max(int(np.ceil((C / 2.0) ** (1.0 / dim))), 1)
    binsize = span / nbins

    def bin_of(x):
        b = np.floor((x - mesh_lo) / binsize).astype(np.int64)
        return np.clip(b, 0, nbins - 1)

    # (cell, bin) pairs for every bin the cell bbox overlaps
    blo = bin_of(lo + 1e-300)
    bhi = bin_of(hi)
    # expand: loop over the (small) per-axis extents
    max_ext = (bhi - blo).max(axis=0) + 1
    pair_cells = []
    pair_bins = []
    ranges = [np.arange(int(e)) for e in max_ext]
    for offs in np.stack(
        np.meshgrid(*ranges, indexing="ij"), axis=-1
    ).reshape(-1, dim):
        b = blo + offs
        ok = np.all(b <= bhi, axis=1)
        if not np.any(ok):
            continue
        flat = np.zeros(ok.sum(), dtype=np.int64)
        for d in range(dim):
            flat = flat * nbins + b[ok, d]
        pair_cells.append(np.nonzero(ok)[0])
        pair_bins.append(flat)
    pair_cells = np.concatenate(pair_cells)
    pair_bins = np.concatenate(pair_bins)
    order = np.argsort(pair_bins, kind="stable")
    pair_cells = pair_cells[order]
    pair_bins = pair_bins[order]

    # point bins
    pb = bin_of(pts)
    pflat = np.zeros(P, dtype=np.int64)
    for d in range(dim):
        pflat = pflat * nbins + pb[:, d]
    start = np.searchsorted(pair_bins, pflat, side="left")
    stop = np.searchsorted(pair_bins, pflat, side="right")
    K = int(np.max(stop - start)) if P else 0
    K = max(K, 1)
    idx = start[:, None] + np.arange(K)[None, :]
    valid = idx < stop[:, None]
    idx = np.minimum(idx, len(pair_cells) - 1 if len(pair_cells) else 0)
    cand = np.where(valid, pair_cells[idx], 0)  # (P, K)

    # reference coordinates in each candidate cell
    if refelem.is_simplex(mesh.cell_type):
        v0 = verts[cand, 0]  # (P, K, d)
        E = verts[cand, 1:] - v0[:, :, None, :]  # (P, K, d(vert-1), d) rows=edges
        # solve E^T lam = p - v0  -> lam = (p - v0) @ inv(E)^T; E[k, :] edge vecs
        A = np.swapaxes(E, -1, -2)  # columns are edge vectors
        rhs = pts[:, None, :] - v0
        # explicit Cramer solves: LAPACK's batched solve on (P, K, d, d)
        # costs ~10x the arithmetic at these sizes
        if dim == 2:
            a, b = A[..., 0, 0], A[..., 0, 1]
            c, d = A[..., 1, 0], A[..., 1, 1]
            det = a * d - b * c
            det = np.where(np.abs(det) > 1e-300, det, 1e-300)
            r0, r1 = rhs[..., 0], rhs[..., 1]
            lam = np.stack(
                [(d * r0 - b * r1) / det, (a * r1 - c * r0) / det],
                axis=-1,
            )
        elif dim == 3:
            c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
            cr12 = np.cross(c1, c2)
            det = np.einsum("...i,...i->...", c0, cr12)
            det = np.where(np.abs(det) > 1e-300, det, 1e-300)
            lam = np.stack(
                [
                    np.einsum("...i,...i->...", rhs, cr12) / det,
                    np.einsum("...i,...i->...", rhs, np.cross(c2, c0))
                    / det,
                    np.einsum("...i,...i->...", rhs, np.cross(c0, c1))
                    / det,
                ],
                axis=-1,
            )
        else:  # pragma: no cover
            lam = np.linalg.solve(
                np.broadcast_to(A, rhs.shape[:2] + (dim, dim)),
                rhs[..., None],
            )[..., 0]
        lam0 = 1.0 - lam.sum(axis=-1)
        deficit = np.maximum(-lam.min(axis=-1), -lam0)
        inside = deficit <= _TOL
        ref = lam
    elif mesh.cell_type == "quadrilateral":
        # axis-aligned rectangles (structured generator)
        v0 = verts[cand, 0]
        v2 = verts[cand, 2]
        denom = np.where(np.abs(v2 - v0) > 1e-300, v2 - v0, 1.0)
        ref = (pts[:, None, :] - v0) / denom
        deficit = np.maximum(-ref.min(axis=-1), ref.max(axis=-1) - 1.0)
        inside = deficit <= _TOL
        ref = np.clip(ref, 0.0, 1.0)
    else:  # pragma: no cover
        raise ValueError(mesh.cell_type)

    inside &= valid
    found = inside.any(axis=1)
    first = np.argmax(inside, axis=1)
    # boundary leniency, matching the native locator and the reference's
    # point_value try/catch convention (grid_writer.h:170-181 /
    # pdebench_unstructured.hpp locate_cell_unstructured): grid lines
    # that lie EXACTLY on a meshed boundary can fall ~1e-7 outside the
    # distmesh polygon (boundary nodes are SDF-projected, not snapped);
    # with only the strict _TOL=1e-10 test those true-boundary points
    # were NaN'd here but valued by the C++ backend — the entire ~2%
    # (one grid line, 1/51) mask disagreement on square_with_hole /
    # multi_hole domains (PARITY.md §2.4 adjudication, round 4).
    deficit = np.where(valid, deficit, np.inf)
    best = np.argmin(deficit, axis=1) if deficit.shape[1] else first
    best_def = deficit[np.arange(P), best]
    fallback = (~found) & (best_def <= _TOL_BOUNDARY)
    first = np.where(fallback, best, first)
    found = found | fallback
    cells_out = np.where(found, cand[np.arange(P), first], -1)
    ref_out = ref[np.arange(P), first]
    ref_out = np.where(found[:, None], ref_out, 0.0)
    return PointLocation(cells_out, ref_out, found)


def eval_function(
    space: FunctionSpace,
    u: np.ndarray,
    loc: PointLocation,
) -> np.ndarray:
    """Evaluate a FEM function at located points.

    u: (ndof,) for scalar spaces or (n_scalar_dofs * ncomp,) blocked for
    vector spaces. Returns (P,) or (P, ncomp); NaN where not found.
    """
    phi, _ = refelem.tabulate(
        space.mesh.cell_type, space.degree, loc.ref_coords
    )  # (P, nl)
    safe_cells = np.maximum(loc.cells, 0)
    dm = space.dofmap_scalar[safe_cells]  # (P, nl)
    if space.ncomp == 1:
        vals = np.einsum("pl,pl->p", phi, u[dm])
        return np.where(loc.found, vals, np.nan)
    uc = np.asarray(u).reshape(-1, space.ncomp)
    vals = np.einsum("pl,plc->pc", phi, uc[dm])
    return np.where(loc.found[:, None], vals, np.nan)


def grid_points(grid: Dict) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Flat sample points + output shape from a case's output.grid spec."""
    bbox = grid["bbox"]
    nx, ny = int(grid["nx"]), int(grid["ny"])
    xs = np.linspace(bbox[0], bbox[1], nx)
    ys = np.linspace(bbox[2], bbox[3], ny)
    if "nz" in grid and grid["nz"]:
        nz = int(grid["nz"])
        zs = np.linspace(bbox[4], bbox[5], nz)
        iz, iy, ix = np.meshgrid(
            np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
        )
        pts = np.stack(
            [xs[ix.ravel()], ys[iy.ravel()], zs[iz.ravel()]], axis=1
        )
        return pts, (nz, ny, nx)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    return pts, (ny, nx)


def sample_on_grid(
    space: FunctionSpace,
    u: np.ndarray,
    grid: Dict,
    loc: Optional[PointLocation] = None,
) -> np.ndarray:
    """Sample u on the case's uniform grid; vector fields -> magnitude."""
    pts, shape = grid_points(grid)
    if loc is None:
        loc = locate_points(space.mesh, pts)
    vals = eval_function(space, np.asarray(u), loc)
    if vals.ndim == 2:
        vals = np.linalg.norm(vals, axis=1)
    return vals.reshape(shape)
