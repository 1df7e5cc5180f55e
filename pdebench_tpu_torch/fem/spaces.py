"""Function spaces as gather indices: dof maps, dof coordinates, BC dofs.

Dof numbering is entity-based (vertices, then shared edges, then faces,
then cell interiors) and computed exactly with integer topology — no
floating-point dedup. The result is a dense (n_cells, n_local) int32
gather map, which is the whole "function space" as far as device code is
concerned.

Parity: replaces dolfinx fem.functionspace + basix dof layouts
(reference: pdebench/oracle/common.py:171-221 — scalar/vector spaces and
all-boundary Dirichlet dof location; common.py:392-408 periodic map).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import refelem
from .mesh import Mesh


@lru_cache(maxsize=None)
def facet_local_nodes(cell_type: str, degree: int) -> Tuple[Tuple[int, ...], ...]:
    """Local node indices lying on each local facet (geometric test)."""
    layout = refelem.lagrange_layout(cell_type, degree)
    verts = refelem.cell_vertices(cell_type)
    out = []
    for facet in refelem.cell_facets(cell_type):
        fv = verts[list(facet)]  # (k, dim)
        origin = fv[0]
        span = (fv[1:] - origin).T  # (dim, k-1)
        nodes = []
        for i, p in enumerate(layout.points):
            # least-squares param on the facet's affine hull
            lam, res, *_ = np.linalg.lstsq(span, p - origin, rcond=None)
            proj = origin + span @ lam
            if np.linalg.norm(proj - p) < 1e-12:
                s = lam.sum()
                if np.all(lam >= -1e-12) and s <= 1 + 1e-12:
                    nodes.append(i)
        out.append(tuple(nodes))
    return tuple(out)


@dataclass
class FunctionSpace:
    """Scalar Lagrange space. Vector fields use `ncomp` blocked components.

    Global dof of (scalar dof s, component c) = s * ncomp + c.
    """

    mesh: Mesh
    degree: int
    ncomp: int = 1

    # filled by __post_init__
    dofmap_scalar: np.ndarray = field(init=False)  # (n_cells, n_local)
    dof_coords: np.ndarray = field(init=False)  # (n_scalar_dofs, dim)
    n_scalar_dofs: int = field(init=False)

    def __post_init__(self):
        self._build()

    # -- construction ------------------------------------------------------

    def _build(self) -> None:
        m = self.mesh
        p = self.degree
        layout = refelem.lagrange_layout(m.cell_type, p)
        cells = m.cells.astype(np.int64)
        n_cells = m.n_cells
        nv = m.n_vertices

        edges_local = refelem.cell_edges(m.cell_type)
        n_edge_nodes = p - 1

        # global edges
        if n_edge_nodes > 0 and edges_local:
            ev = np.stack(
                [cells[:, [a, b]] for (a, b) in edges_local], axis=1
            )  # (n_cells, n_loc_edges, 2)
            ev_sorted = np.sort(ev, axis=2)
            # packed int64 keys: np.unique(axis=0) sorts a void dtype
            # (~50x slower than the 1-D int64 fast path; 0.77 s of the
            # res-160 P2 FunctionSpace build was this one argsort)
            keys = ev_sorted[:, :, 0] * nv + ev_sorted[:, :, 1]
            uniq_keys, edge_ids = np.unique(
                keys.reshape(-1), return_inverse=True
            )
            edge_ids = edge_ids.reshape(n_cells, len(edges_local))
            n_edges = uniq_keys.shape[0]
            # orientation: True where local (a, b) is ascending in global ids
            ascending = ev[:, :, 0] < ev[:, :, 1]
        else:
            uniq_edges = np.zeros((0, 2), dtype=np.int64)
            edge_ids = np.zeros((n_cells, 0), dtype=np.int64)
            n_edges = 0
            ascending = None

        # global faces (tets, p >= 3)
        faces_local = (
            refelem.cell_facets(m.cell_type) if m.dim == 3 else ()
        )
        n_face_nodes = len(
            [e for e in layout.entities if e[0] == "f"]
        ) // max(len(faces_local), 1) if faces_local else 0
        if n_face_nodes > 0:
            if n_face_nodes > 1:
                raise NotImplementedError(
                    "face-node orientation for >1 node per face"
                )
            fv = np.stack(
                [cells[:, list(f)] for f in faces_local], axis=1
            )
            fv_sorted = np.sort(fv, axis=2)
            flat = fv_sorted.reshape(-1, fv_sorted.shape[2])
            if flat.shape[1] == 3 and nv < 2_000_000:
                # packed 1-D int64 keys (see edge build above)
                fkeys = (flat[:, 0] * nv + flat[:, 1]) * nv + flat[:, 2]
                uniq_fk, face_ids = np.unique(fkeys, return_inverse=True)
                n_faces = uniq_fk.shape[0]
            else:  # quads / giant meshes: keep the general path
                uniq_faces, face_ids = np.unique(
                    flat, axis=0, return_inverse=True
                )
                n_faces = uniq_faces.shape[0]
            face_ids = face_ids.reshape(n_cells, len(faces_local))
        else:
            face_ids = np.zeros((n_cells, 0), dtype=np.int64)
            n_faces = 0

        n_int = len([e for e in layout.entities if e[0] == "i"])

        off_e = nv
        off_f = off_e + n_edges * n_edge_nodes
        off_i = off_f + n_faces * n_face_nodes
        ndof = off_i + n_cells * n_int

        dofmap = np.zeros((n_cells, layout.n_nodes), dtype=np.int64)
        cell_range = np.arange(n_cells)
        for li, ent in enumerate(layout.entities):
            kind = ent[0]
            if kind == "v":
                dofmap[:, li] = cells[:, ent[1]]
            elif kind == "e":
                ei, k = ent[1], ent[2]
                slot = np.where(ascending[:, ei], k, p - k) - 1
                dofmap[:, li] = off_e + edge_ids[:, ei] * n_edge_nodes + slot
            elif kind == "f":
                fi, k = ent[1], ent[2]
                dofmap[:, li] = off_f + face_ids[:, fi] * n_face_nodes + k
            elif kind == "i":
                dofmap[:, li] = off_i + cell_range * n_int + ent[1]
            else:  # pragma: no cover
                raise ValueError(ent)

        # physical dof coordinates via the geometry map
        gphi, _ = refelem.tabulate(m.cell_type, 1, layout.points)  # (nl, nvert)
        phys = np.einsum("lv,cvd->cld", gphi, m.coords[m.cells])
        dof_coords = np.zeros((ndof, m.dim))
        dof_coords[dofmap.reshape(-1)] = phys.reshape(-1, m.dim)

        # periodic identification (rectangle meshes only)
        if m.periodic is not None:
            dofmap, dof_coords, ndof = _apply_periodic(
                dofmap, dof_coords, ndof, m.periodic
            )

        self.dofmap_scalar = dofmap.astype(np.int32)
        self.dof_coords = dof_coords
        self.n_scalar_dofs = ndof

    # -- derived -----------------------------------------------------------

    @property
    def ndof(self) -> int:
        return self.n_scalar_dofs * self.ncomp

    @property
    def n_local(self) -> int:
        return self.dofmap_scalar.shape[1] * self.ncomp

    @cached_property
    def dofmap(self) -> np.ndarray:
        """Blocked dofmap (n_cells, n_local_scalar * ncomp), int32.

        Local ordering interleaves components: (node0_c0, node0_c1, ...).
        """
        if self.ncomp == 1:
            return self.dofmap_scalar
        dm = self.dofmap_scalar.astype(np.int64)
        blocked = dm[:, :, None] * self.ncomp + np.arange(self.ncomp)[None, None, :]
        return blocked.reshape(dm.shape[0], -1).astype(np.int32)

    @cached_property
    def boundary_scalar_dofs(self) -> np.ndarray:
        """Scalar dofs on the domain boundary (all facets with one cell)."""
        bf, bcells = self.mesh.boundary_facets()
        if bf.shape[0] == 0:
            return np.zeros(0, dtype=np.int64)
        fln = facet_local_nodes(self.mesh.cell_type, self.degree)
        local_facets = np.array(refelem.cell_facets(self.mesh.cell_type))
        cells = self.mesh.cells.astype(np.int64)
        out = []
        # match each boundary facet to the local facet of its cell
        cell_fv = np.sort(cells[bcells][:, local_facets], axis=2)  # (nb, nf, k)
        for lf in range(local_facets.shape[0]):
            hit = np.all(cell_fv[:, lf, :] == bf, axis=1)
            if np.any(hit):
                out.append(
                    self.dofmap_scalar[bcells[hit]][:, list(fln[lf])].reshape(-1)
                )
        return np.unique(np.concatenate(out)) if out else np.zeros(0, dtype=np.int64)

    def boundary_dofs_on(self, where: str = "all") -> np.ndarray:
        """Scalar boundary dofs filtered by side selector.

        Selectors follow the reference DSL (oracle/stokes.py:40-59):
        'all', 'x0', 'x1', 'y0', 'y1', 'z0', 'z1'.
        """
        bd = self.boundary_scalar_dofs
        if where == "all":
            return bd
        axis = {"x": 0, "y": 1, "z": 2}[where[0]]
        lo, hi = self.mesh.bbox[0, axis], self.mesh.bbox[1, axis]
        target = lo if where[1] == "0" else hi
        coords = self.dof_coords[bd, axis]
        tol = 1e-10 * max(abs(hi - lo), 1.0)
        return bd[np.abs(coords - target) < tol]


def _apply_periodic(
    dofmap: np.ndarray,
    dof_coords: np.ndarray,
    ndof: int,
    bounds: Tuple[float, ...],
    direction: str = "both",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Identify dofs on max-side boundaries with their min-side partners."""
    xmin, xmax, ymin, ymax = bounds
    tol = 1e-9 * max(xmax - xmin, ymax - ymin, 1.0)
    mapped = dof_coords.copy()
    if direction in ("x", "both"):
        on = np.abs(mapped[:, 0] - xmax) < tol
        mapped[on, 0] = xmin
    if direction in ("y", "both"):
        on = np.abs(mapped[:, 1] - ymax) < tol
        mapped[on, 1] = ymin
    # match by quantized coordinates (structured meshes -> exact)
    keys = np.round(mapped / tol).astype(np.int64)
    _, first, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    # renumber: dof -> representative, then compress
    rep = first[inverse]  # representative old-dof per dof (idempotent)
    uniq_rep, new_ids = np.unique(rep, return_inverse=True)
    new_dofmap = new_ids[dofmap]
    new_coords = dof_coords[uniq_rep]
    return new_dofmap, new_coords, uniq_rep.shape[0]


def vector_space(mesh: Mesh, degree: int) -> FunctionSpace:
    return FunctionSpace(mesh, degree, ncomp=mesh.dim)
