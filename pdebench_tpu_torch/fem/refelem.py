"""Reference elements: Lagrange nodes, basis tabulation, quadrature.

TPU-first design: everything in this module produces *static* numpy tables
(basis values/gradients at quadrature points, node layouts) that are baked
as compile-time constants into jitted assembly kernels. No runtime shape
dynamism ever reaches XLA from here.

Functional parity with the basix/UFL tabulation layer used by the
reference oracle (reference: pdebench/oracle/common.py:171-195 builds
scalar/vector/Taylor-Hood spaces; deal.II mesh_factory.h:78-145 builds
FE_Q/FE_SimplexP + quadrature). Implementation is original: generic
monomial Vandermonde tabulation + Grundmann-Moller simplex cubature.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Cell topology
# ---------------------------------------------------------------------------

# Reference vertices. Simplices use the unit simplex; quads the unit square.
_REF_VERTICES: Dict[str, np.ndarray] = {
    "interval": np.array([[0.0], [1.0]]),
    "triangle": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "quadrilateral": np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
    "tetrahedron": np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
}

# Edges as local vertex pairs (used for shared edge-dof numbering).
_EDGES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "interval": (),
    "triangle": ((0, 1), (1, 2), (2, 0)),
    "quadrilateral": ((0, 1), (1, 2), (2, 3), (3, 0)),
    "tetrahedron": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
}

# Facets (codim-1 entities) as local vertex tuples.
_FACETS: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "triangle": ((0, 1), (1, 2), (2, 0)),
    "quadrilateral": ((0, 1), (1, 2), (2, 3), (3, 0)),
    "tetrahedron": ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
}

# Faces of 3-D cells (2-D entities carrying face dofs for p >= 3).
_FACES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "tetrahedron": ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
}

_SIMPLEX = ("interval", "triangle", "tetrahedron")


def cell_dim(cell_type: str) -> int:
    return _REF_VERTICES[cell_type].shape[1]


def cell_vertices(cell_type: str) -> np.ndarray:
    return _REF_VERTICES[cell_type]


def cell_edges(cell_type: str) -> Tuple[Tuple[int, int], ...]:
    return _EDGES[cell_type]


def cell_facets(cell_type: str) -> Tuple[Tuple[int, ...], ...]:
    return _FACETS[cell_type]


def is_simplex(cell_type: str) -> bool:
    return cell_type in _SIMPLEX


def reference_volume(cell_type: str) -> float:
    return {
        "interval": 1.0,
        "triangle": 0.5,
        "quadrilateral": 1.0,
        "tetrahedron": 1.0 / 6.0,
    }[cell_type]


# ---------------------------------------------------------------------------
# Lagrange node layout
# ---------------------------------------------------------------------------

# Entity tags for each local node:
#   ("v", vertex_idx)            — coincides with a cell vertex
#   ("e", edge_idx, k)           — k-th of (p-1) nodes along local edge,
#                                  ordered from the edge's first local vertex
#   ("f", face_idx, k)           — k-th face-interior node (3-D, p >= 3)
#   ("i", k)                     — k-th cell-interior node
Entity = Tuple


@dataclass(frozen=True)
class NodeLayout:
    cell_type: str
    degree: int
    points: np.ndarray  # (n_nodes, dim)
    entities: Tuple[Entity, ...]

    @property
    def n_nodes(self) -> int:
        return self.points.shape[0]


def _simplex_interior_lattice(dim: int, p: int) -> List[Tuple[int, ...]]:
    """Lattice multi-indices strictly inside the simplex (all parts >= 1)."""
    out = []
    for idx in itertools.product(range(1, p), repeat=dim):
        if sum(idx) <= p - 1:
            out.append(idx)
    return out


@lru_cache(maxsize=None)
def lagrange_layout(cell_type: str, degree: int) -> NodeLayout:
    """Equispaced Lagrange node layout, grouped vertex -> edge -> face -> cell.

    The grouping (not the geometry) is what the dof-map builder in
    spaces.py relies on for exact shared-entity numbering.
    """
    p = degree
    verts = _REF_VERTICES[cell_type]
    dim = verts.shape[1]
    pts: List[np.ndarray] = []
    ents: List[Entity] = []

    # vertices
    for v in range(verts.shape[0]):
        pts.append(verts[v])
        ents.append(("v", v))

    # edge nodes
    if p >= 2:
        for ei, (a, b) in enumerate(_EDGES[cell_type]):
            for k in range(1, p):
                pts.append(verts[a] + (verts[b] - verts[a]) * (k / p))
                ents.append(("e", ei, k))

    if cell_type in ("triangle",):
        for k, idx in enumerate(_simplex_interior_lattice(2, p)):
            pts.append(np.array([idx[0] / p, idx[1] / p]))
            ents.append(("i", k))
    elif cell_type == "tetrahedron":
        # face-interior nodes (p >= 3)
        if p >= 3:
            for fi, face in enumerate(_FACES["tetrahedron"]):
                fverts = verts[list(face)]
                k = 0
                for idx in _simplex_interior_lattice(2, p):
                    lam1, lam2 = idx[0] / p, idx[1] / p
                    lam0 = 1.0 - lam1 - lam2
                    pts.append(lam0 * fverts[0] + lam1 * fverts[1] + lam2 * fverts[2])
                    ents.append(("f", fi, k))
                    k += 1
        for k, idx in enumerate(_simplex_interior_lattice(3, p)):
            pts.append(np.array(idx) / p)
            ents.append(("i", k))
    elif cell_type == "quadrilateral":
        # interior tensor lattice
        k = 0
        for j in range(1, p):
            for i in range(1, p):
                pts.append(np.array([i / p, j / p]))
                ents.append(("i", k))
                k += 1
    elif cell_type == "interval":
        pass
    else:
        raise ValueError(f"unsupported cell type {cell_type}")

    return NodeLayout(cell_type, degree, np.array(pts, dtype=np.float64), tuple(ents))


# ---------------------------------------------------------------------------
# Monomial tabulation (generic basis via Vandermonde inversion)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _monomial_exponents(cell_type: str, degree: int) -> Tuple[Tuple[int, ...], ...]:
    dim = cell_dim(cell_type)
    if is_simplex(cell_type):
        exps = [
            e
            for e in itertools.product(range(degree + 1), repeat=dim)
            if sum(e) <= degree
        ]
    else:  # tensor-product (quad)
        exps = list(itertools.product(range(degree + 1), repeat=dim))
    return tuple(sorted(exps))


def _eval_monomials(exps, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values and gradients of monomials at points.

    Returns (vals (npts, nmono), grads (npts, nmono, dim)).
    """
    pts = np.asarray(points, dtype=np.float64)
    npts, dim = pts.shape
    nm = len(exps)
    vals = np.ones((npts, nm))
    grads = np.zeros((npts, nm, dim))
    for j, e in enumerate(exps):
        for d in range(dim):
            vals[:, j] *= pts[:, d] ** e[d]
        for d in range(dim):
            g = np.ones(npts)
            for d2 in range(dim):
                if d2 == d:
                    if e[d2] == 0:
                        g *= 0.0
                    else:
                        g *= e[d2] * pts[:, d2] ** (e[d2] - 1)
                else:
                    g *= pts[:, d2] ** e[d2]
            grads[:, j, d] = g
    return vals, grads


@lru_cache(maxsize=None)
def _basis_coeffs(cell_type: str, degree: int) -> np.ndarray:
    """C with phi_i(x) = sum_j C[j, i] * m_j(x); nodal at the Lagrange layout."""
    layout = lagrange_layout(cell_type, degree)
    exps = _monomial_exponents(cell_type, degree)
    V, _ = _eval_monomials(exps, layout.points)  # V[i, j] = m_j(node_i)
    if V.shape[0] != V.shape[1]:
        raise RuntimeError(
            f"node/monomial count mismatch for {cell_type} p={degree}: {V.shape}"
        )
    return np.linalg.solve(V, np.eye(V.shape[0]))


def tabulate(
    cell_type: str, degree: int, points: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Tabulate basis values and reference gradients at arbitrary points.

    Returns (phi (npts, nbasis), dphi (npts, nbasis, dim)).
    """
    exps = _monomial_exponents(cell_type, degree)
    C = _basis_coeffs(cell_type, degree)
    M, dM = _eval_monomials(exps, np.atleast_2d(points))
    phi = M @ C
    dphi = np.einsum("qjd,ji->qid", dM, C)
    return phi, dphi


def _eval_monomial_hess(exps, points: np.ndarray) -> np.ndarray:
    """Second derivatives of monomials: (npts, nmono, dim, dim)."""
    pts = np.asarray(points, dtype=np.float64)
    npts, dim = pts.shape
    nm = len(exps)
    hess = np.zeros((npts, nm, dim, dim))
    for j, e in enumerate(exps):
        for a in range(dim):
            for b in range(dim):
                g = np.ones(npts)
                ok = True
                for d in range(dim):
                    order = (d == a) + (d == b)
                    if e[d] < order:
                        ok = False
                        break
                    coef = 1.0
                    for k in range(order):
                        coef *= e[d] - k
                    g *= coef * pts[:, d] ** (e[d] - order)
                hess[:, j, a, b] = g if ok else 0.0
    return hess


def tabulate_hess(
    cell_type: str, degree: int, points: np.ndarray
) -> np.ndarray:
    """Reference-coordinate basis hessians: (npts, nbasis, dim, dim)."""
    exps = _monomial_exponents(cell_type, degree)
    C = _basis_coeffs(cell_type, degree)
    H = _eval_monomial_hess(exps, np.atleast_2d(points))
    return np.einsum("qjab,ji->qiab", H, C)


# ---------------------------------------------------------------------------
# Quadrature
# ---------------------------------------------------------------------------


def _gauss_legendre_01(n: int) -> Tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _compositions(total: int, parts: int):
    """All tuples of `parts` non-negative ints summing to `total`."""
    if parts == 1:
        yield (total,)
        return
    for first in range(total + 1):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest


def _grundmann_moller(dim: int, s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Grundmann-Moller cubature of degree 2s+1 on the unit simplex."""
    d = 2 * s + 1
    pts: List[List[float]] = []
    wts: List[float] = []
    for i in range(s + 1):
        denom = d + dim - 2 * i
        coef = (
            (-1.0) ** i
            * 2.0 ** (-2 * s)
            * float(denom) ** d
            / (math.factorial(i) * math.factorial(d + dim - i))
        )
        for beta in _compositions(s - i, dim + 1):
            # barycentric point; drop the 0th coordinate for cartesian
            bary = [(2 * b + 1) / denom for b in beta]
            pts.append(bary[1:])
            wts.append(coef)
    return np.array(pts, dtype=np.float64), np.array(wts, dtype=np.float64)


@lru_cache(maxsize=None)
def quadrature(cell_type: str, qdegree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quadrature points/weights on the reference cell, exact to `qdegree`.

    Weights sum to the reference cell volume.
    """
    qdegree = max(int(qdegree), 1)
    dim = cell_dim(cell_type)
    if cell_type == "interval":
        n = (qdegree + 2) // 2
        return _gauss_legendre_01(n)
    if cell_type == "quadrilateral":
        n = (qdegree + 2) // 2
        x, w = _gauss_legendre_01(n)
        px, py = np.meshgrid(x, x, indexing="ij")
        pts = np.stack([px.ravel(), py.ravel()], axis=1)
        wts = np.outer(w, w).ravel()
        return pts, wts
    if is_simplex(cell_type):
        s = max((qdegree - 1 + 1) // 2, 0)  # 2s+1 >= qdegree
        pts, wts = _grundmann_moller(dim, s)
        return pts, wts
    raise ValueError(f"unsupported cell type {cell_type}")


@dataclass(frozen=True)
class ElementTables:
    """Static tabulation of an element at a quadrature rule."""

    cell_type: str
    degree: int
    qdegree: int
    qpoints: np.ndarray  # (nq, dim)
    qweights: np.ndarray  # (nq,)
    phi: np.ndarray  # (nq, n_basis)
    dphi: np.ndarray  # (nq, n_basis, dim)
    d2phi: np.ndarray  # (nq, n_basis, dim, dim) reference hessians
    # geometry (P1/Q1) tabulation at the same points, for the coordinate map
    geom_phi: np.ndarray  # (nq, n_verts)
    geom_dphi: np.ndarray  # (nq, n_verts, dim)


@lru_cache(maxsize=None)
def element_tables(cell_type: str, degree: int, qdegree: int) -> ElementTables:
    qp, qw = quadrature(cell_type, qdegree)
    phi, dphi = tabulate(cell_type, degree, qp)
    d2phi = tabulate_hess(cell_type, degree, qp)
    gphi, gdphi = tabulate(cell_type, 1, qp)
    return ElementTables(
        cell_type, degree, qdegree, qp, qw, phi, dphi, d2phi, gphi, gdphi
    )
