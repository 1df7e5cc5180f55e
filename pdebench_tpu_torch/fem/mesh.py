"""Array-native meshes and structured generators.

A mesh is just two arrays — vertex coordinates and cell connectivity —
plus optional metadata (the generating geometry for domain masks, the
bounding box). Construction happens on host in numpy; compute consumes
the arrays as jnp constants.

Parity: replaces dolfinx.mesh.create_unit_square/create_unit_cube and the
pygmsh complex-domain path (reference: pdebench/oracle/common.py:21-167).
Complex 2-D domains are produced by the signed-distance mesher in
geometry.py instead of gmsh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from . import refelem


@dataclass
class Mesh:
    cell_type: str
    coords: np.ndarray  # (n_nodes, dim) float64
    cells: np.ndarray  # (n_cells, n_verts) int32
    # signed distance function of the domain (for masking), if known
    sdf: Optional[Callable[[np.ndarray], np.ndarray]] = None
    # periodic bounds [xmin, xmax, ymin, ymax] when the mesh is periodic
    periodic: Optional[Tuple[float, ...]] = None

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def bbox(self) -> np.ndarray:
        return np.stack([self.coords.min(axis=0), self.coords.max(axis=0)])

    def cell_volumes(self) -> np.ndarray:
        v = self.coords[self.cells]
        if self.cell_type == "triangle":
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            return 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        if self.cell_type == "tetrahedron":
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            e3 = v[:, 3] - v[:, 0]
            return np.abs(np.einsum("ci,ci->c", np.cross(e1, e2), e3)) / 6.0
        if self.cell_type == "quadrilateral":
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 3] - v[:, 0]
            return np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        raise ValueError(self.cell_type)

    def cell_diameters(self) -> np.ndarray:
        """Max vertex-pair distance per cell (UFL CellDiameter semantics)."""
        v = self.coords[self.cells]  # (C, nv, d)
        d = np.linalg.norm(v[:, :, None, :] - v[:, None, :, :], axis=-1)
        return d.reshape(self.n_cells, -1).max(axis=1)

    # ---- topology -------------------------------------------------------

    def facets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All unique facets and their incident cell count.

        Returns (facet_vertices (n_facets, k) sorted, cell_of_facet
        (n_facets,) one incident cell, counts (n_facets,)).
        """
        local = refelem.cell_facets(self.cell_type)
        k = len(local[0])
        nf = len(local)
        fv = np.sort(
            self.cells[:, np.array(local).reshape(-1)].reshape(-1, k), axis=1
        )  # (n_cells*nf, k)
        cell_ids = np.repeat(np.arange(self.n_cells), nf)
        uniq, idx, counts = np.unique(
            fv, axis=0, return_index=True, return_counts=True
        )
        return uniq, cell_ids[idx], counts

    def boundary_facets(self) -> Tuple[np.ndarray, np.ndarray]:
        """Facets incident to exactly one cell: (facet_vertices, cell_ids)."""
        uniq, cells, counts = self.facets()
        m = counts == 1
        return uniq[m], cells[m]

    def boundary_vertices(self) -> np.ndarray:
        bf, _ = self.boundary_facets()
        return np.unique(bf.reshape(-1))


# ---------------------------------------------------------------------------
# Structured generators
# ---------------------------------------------------------------------------


def rectangle_mesh(
    nx: int,
    ny: int,
    bounds: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0),
    cell_type: str = "triangle",
) -> Mesh:
    """Structured mesh of a rectangle; triangles split along the NE diagonal."""
    x0, x1, y0, y1 = bounds
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    v00, v10 = vid(ii, jj), vid(ii + 1, jj)
    v01, v11 = vid(ii, jj + 1), vid(ii + 1, jj + 1)
    if cell_type == "triangle":
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        cells = np.concatenate([t1, t2], axis=0)
    elif cell_type == "quadrilateral":
        cells = np.stack([v00, v10, v11, v01], axis=1)
    else:
        raise ValueError(cell_type)

    def sdf(p):
        return np.maximum.reduce(
            [x0 - p[..., 0], p[..., 0] - x1, y0 - p[..., 1], p[..., 1] - y1]
        )

    return Mesh(cell_type, coords, cells.astype(np.int32), sdf=sdf)


def unit_square_mesh(n: int, cell_type: str = "triangle") -> Mesh:
    return rectangle_mesh(n, n, (0.0, 1.0, 0.0, 1.0), cell_type)


def box_mesh(
    nx: int,
    ny: int,
    nz: int,
    bounds: Tuple[float, ...] = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0),
) -> Mesh:
    """Structured tetrahedral mesh: each cube split into 6 Kuhn tetrahedra."""
    x0, x1, y0, y1, z0, z1 = bounds
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    ii, jj, kk = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()
    c = {}
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c[(di, dj, dk)] = vid(ii + di, jj + dj, kk + dk)
    # Kuhn triangulation: 6 tets around the main diagonal (0,0,0)-(1,1,1)
    paths = [
        ((1, 0, 0), (1, 1, 0)),
        ((1, 0, 0), (1, 0, 1)),
        ((0, 1, 0), (1, 1, 0)),
        ((0, 1, 0), (0, 1, 1)),
        ((0, 0, 1), (1, 0, 1)),
        ((0, 0, 1), (0, 1, 1)),
    ]
    tets = []
    for a, b in paths:
        tets.append(
            np.stack([c[(0, 0, 0)], c[a], c[b], c[(1, 1, 1)]], axis=1)
        )
    cells = np.concatenate(tets, axis=0)

    def sdf(p):
        return np.maximum.reduce(
            [
                x0 - p[..., 0],
                p[..., 0] - x1,
                y0 - p[..., 1],
                p[..., 1] - y1,
                z0 - p[..., 2],
                p[..., 2] - z1,
            ]
        )

    return Mesh("tetrahedron", coords, cells.astype(np.int32), sdf=sdf)


def unit_cube_mesh(n: int) -> Mesh:
    return box_mesh(n, n, n)


def _aligned_axis_count(
    lo: float, hi: float, breaks, resolution: float, max_den: int = 64
) -> Optional[int]:
    """Cell count n for a uniform axis grid of pitch ~1/resolution whose
    gridlines contain every breakpoint, or None if the breakpoints are
    not small rationals of the span."""
    from fractions import Fraction
    from math import ceil, gcd

    span = hi - lo
    if span <= 0:
        return None
    L = 1
    for b in breaks:
        f = (float(b) - lo) / span
        if f <= 1e-12 or f >= 1 - 1e-12:
            continue
        fr = Fraction(f).limit_denominator(max_den)
        if abs(float(fr) - f) > 1e-9:
            return None
        L = L * fr.denominator // gcd(L, fr.denominator)
    target = span * float(resolution)
    n = max(L, int(round(target / L)) * L)
    if n < 0.8 * target:
        n += L
    return n


def rectilinear_masked_mesh(
    sdf: Callable[[np.ndarray], np.ndarray],
    bbox: Tuple[float, float, float, float],
    breaks_x,
    breaks_y,
    resolution: float,
) -> Optional[Mesh]:
    """Structured masked triangulation of an axis-aligned rectilinear
    2-D domain: a uniform per-axis lattice whose pitch divides every
    edge coordinate, keeping only the cells whose centroid is inside.

    The surviving vertices are a subset of a regular lattice, so the
    assembled operators become masked lattice stencils
    (solvers/stencil.py) — the gather-free TPU fast path — instead of
    unstructured gather/scatter operators. Returns None when the
    breakpoints don't align with any reasonable uniform pitch.
    """
    x0, x1, y0, y1 = [float(v) for v in bbox]
    nx = _aligned_axis_count(x0, x1, breaks_x, resolution)
    ny = _aligned_axis_count(y0, y1, breaks_y, resolution)
    if nx is None or ny is None or nx * ny > 4_000_000:
        return None
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    cx = x0 + (ii + 0.5) * (x1 - x0) / nx
    cy = y0 + (jj + 0.5) * (y1 - y0) / ny
    inside = sdf(np.stack([cx, cy], axis=1)) < 0.0
    if not inside.any():
        return None
    ii, jj = ii[inside], jj[inside]

    def vid(i, j):
        return i * (ny + 1) + j

    v00, v10 = vid(ii, jj), vid(ii + 1, jj)
    v01, v11 = vid(ii, jj + 1), vid(ii + 1, jj + 1)
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([t1, t2], axis=0)

    # drop unused vertices, renumber
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    used = np.unique(cells.reshape(-1))
    remap = np.full(coords.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return Mesh(
        "triangle",
        coords[used],
        remap[cells].astype(np.int32),
        sdf=sdf,
    )
