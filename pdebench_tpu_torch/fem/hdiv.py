"""Raviart-Thomas (RT0 x DG0 and general RT_k x DG_k) mixed spaces on
triangles.

H(div)-conforming flux spaces for the mixed Darcy formulation
(reference: pdebench/oracle/darcy.py:46-61 builds RT_k x DG_l through
basix with configurable order; no benchmark case exercises it, but the
capability is part of the oracle inventory). RT0 uses the closed-form
edge basis below; RT_k for any k >= 1 (basix 'RT' degree k+1)
tabulates per-cell bases numerically from the standard dof functionals
(rtk_assemble), matching basix's generality for the stable pairing.
Array-native RT0 construction:

  - flux dofs = global mesh edges, oriented low->high vertex index;
    the cell-local sign sigma is +1 when the local edge agrees with
    the global orientation
  - on triangle T with vertices p0 p1 p2, the basis for the edge
    opposite vertex i is  phi_i(x) = sigma_i |e_i| / (2|T|) (x - p_i),
    with div phi_i = sigma_i |e_i| / |T|
  - pressure dofs = cells (piecewise constants)

Host numpy only. Copy of pdebench_tpu/fem/hdiv.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from . import refelem
from .mesh import Mesh


@dataclass
class RT0Space:
    mesh: Mesh
    edge_verts: np.ndarray  # (n_edges, 2) global vertex pairs, sorted
    cell_edges: np.ndarray  # (n_cells, 3) global edge ids
    signs: np.ndarray  # (n_cells, 3) +-1 orientation
    opposite: np.ndarray  # (n_cells, 3) the vertex opposite each edge
    edge_lengths: np.ndarray  # (n_edges,)
    boundary_edges: np.ndarray  # (nb,) edge ids on the boundary
    edge_midpoints: np.ndarray  # (n_edges, 2)
    edge_normals: np.ndarray  # (n_edges, 2) unit, oriented with the edge

    @property
    def n_edges(self) -> int:
        return self.edge_verts.shape[0]


def rt0_space(mesh: Mesh) -> RT0Space:
    if mesh.cell_type != "triangle":
        raise NotImplementedError("RT0 is implemented for triangles")
    cells = mesh.cells.astype(np.int64)
    # local edge i is OPPOSITE local vertex i: (i+1, i+2)
    loc = [(1, 2), (2, 0), (0, 1)]
    ev = np.stack([cells[:, list(p)] for p in loc], axis=1)  # (c, 3, 2)
    ev_sorted = np.sort(ev, axis=2)
    flat = ev_sorted.reshape(-1, 2)
    uniq, ids = np.unique(flat, axis=0, return_inverse=True)
    cell_edges = ids.reshape(-1, 3)
    signs = np.where(ev[:, :, 0] < ev[:, :, 1], 1.0, -1.0)
    opposite = np.tile(np.arange(3), (mesh.n_cells, 1))

    coords = mesh.coords
    edge_vec = coords[uniq[:, 1]] - coords[uniq[:, 0]]
    lengths = np.linalg.norm(edge_vec, axis=1)
    midpoints = 0.5 * (coords[uniq[:, 0]] + coords[uniq[:, 1]])
    # normal = edge tangent rotated -90 deg (consistent with orientation)
    normals = np.stack([edge_vec[:, 1], -edge_vec[:, 0]], axis=1)
    normals /= np.maximum(lengths, 1e-300)[:, None]

    counts = np.bincount(cell_edges.reshape(-1), minlength=len(uniq))
    boundary = np.nonzero(counts == 1)[0]

    return RT0Space(
        mesh=mesh,
        edge_verts=uniq,
        cell_edges=cell_edges,
        signs=signs,
        opposite=opposite,
        edge_lengths=lengths,
        boundary_edges=boundary,
        edge_midpoints=midpoints,
        edge_normals=normals,
    )


def _edge_gauss(space: RT0Space, npts: int = 2):
    """Gauss points along every GLOBAL edge (low->high vertex order).

    Returns (pts (ne, g, 2), s (g,) in [0,1], w (ne, g)) with
    sum_g w = |e|. Using the global orientation for the linear edge
    moment makes adjacent cells share identical dof functionals, so
    H(div) conformity needs no per-cell sign bookkeeping.
    """
    x, w = np.polynomial.legendre.leggauss(npts)
    s = 0.5 * (x + 1.0)  # [0, 1]
    a = space.mesh.coords[space.edge_verts[:, 0]]  # (ne, 2)
    b = space.mesh.coords[space.edge_verts[:, 1]]
    pts = a[:, None, :] + s[None, :, None] * (b - a)[:, None, :]
    wts = 0.5 * w[None, :] * space.edge_lengths[:, None]
    return pts, s, wts


def _monomial_exponents(k: int):
    """Exponent table for the RT_k monomial basis and DG bases.

    Vector part: (a, b, comp) for a+b <= k, both components;
    homogeneous part: x^a y^b (x, y) for a+b == k.
    dim = 2*(k+1)(k+2)/2 + (k+1) = (k+1)(k+3).
    """
    poly = [(a, b) for d in range(k + 1) for a in range(d, -1, -1)
            for b in (d - a,)]
    vec = [(a, b, comp) for comp in (0, 1) for (a, b) in poly]
    hom = [(a, b) for (a, b) in poly if a + b == k]
    return poly, vec, hom


def _legendre_01(j: int, s: np.ndarray) -> np.ndarray:
    """Legendre P_j shifted to [0, 1]."""
    c = np.zeros(j + 1)
    c[j] = 1.0
    return np.polynomial.legendre.legval(2.0 * s - 1.0, c)


def rtk_tabulate(k: int, Xl: np.ndarray):
    """(values (..., ndof, 2), divergences (..., ndof)) of the RT_k
    monomial basis at local scaled coords Xl (..., 2). Physical
    divergence needs the extra 1/h factor (d/dx = (1/h) d/dX)."""
    poly, vec, hom = _monomial_exponents(k)
    x, y = Xl[..., 0], Xl[..., 1]
    vals = np.zeros(Xl.shape[:-1] + (len(vec) + len(hom), 2))
    divs = np.zeros(Xl.shape[:-1] + (len(vec) + len(hom),))
    for j, (a, b, comp) in enumerate(vec):
        m = x**a * y**b
        vals[..., j, comp] = m
        d = a if comp == 0 else b
        if d > 0:
            divs[..., j] = d * (
                x ** (a - 1) * y**b if comp == 0 else x**a * y ** (b - 1)
            )
    for jj, (a, b) in enumerate(hom):
        j = len(vec) + jj
        m = x**a * y**b
        vals[..., j, 0] = m * x
        vals[..., j, 1] = m * y
        divs[..., j] = (a + b + 2) * m
    return vals, divs


def rtk_assemble(space: RT0Space, kappa_inv_fn, k: int = 1,
                 qdeg: int = 0):
    """RT_k x DG_k local system for any k >= 1 (basix 'RT' degree k+1;
    reference: pdebench/oracle/darcy.py:46-61 builds RT_k x DG_l
    through basix for configurable order — this is the same generality
    for the stable RT_k x DG_k pairing, triangles).

    Per-cell numerically-tabulated basis in cell-local scaled
    coordinates X=(x-xc)/h with the standard dofs — k+1 normal moments
    per edge against Legendre P_0..P_k along the GLOBAL edge
    orientation, and k(k+1) interior moments against (P_{k-1})^2.
    Inverting the ndof x ndof generalized Vandermonde per cell
    (batched host numpy) yields physical basis functions directly; no
    Piola map or reference-orientation cases needed, and conformity is
    automatic because adjacent cells share the global edge functionals.
    (Conditioning of the monomial Vandermonde degrades ~exponentially
    in k; fine through k~4, which covers every practical order.)

    Returns (M_loc (c,nd,nd), B_loc (c,npl,nd), fdofs (c,nd) global
    flux dof ids, aux). k=1 reproduces the original RT1 x DG1 path
    (same dof layout and quadrature).
    """
    mesh = space.mesh
    cells = mesh.cells.astype(np.int64)
    v = mesh.coords[cells]  # (c, 3, 2)
    nc = mesh.n_cells
    ne = space.n_edges
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    detJ = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = 0.5 * np.abs(detJ)
    xc = v.mean(axis=1)  # (c, 2)
    h = np.sqrt(area)  # local length scale (conditioning)

    poly, vec, hom = _monomial_exponents(k)
    nd = len(vec) + len(hom)  # (k+1)(k+3)
    nem = k + 1  # edge moments per edge
    psi_exp = poly  # DG_k pressure monomials, npl = (k+1)(k+2)/2
    int_exp = [(a, b) for (a, b) in poly if a + b <= k - 1]
    nint = 2 * len(int_exp)  # k(k+1)
    assert 3 * nem + nint == nd

    # --- generalized Vandermonde -----------------------------------------
    # edge integrand degree <= (k+1) + k = 2k+1 -> npts = k+1 exact
    epts, s_param, ew = _edge_gauss(space, max(2, k + 1))
    leg = np.stack(
        [_legendre_01(j, s_param) for j in range(nem)]
    )  # (nem, g)
    ce = space.cell_edges  # (c, 3)
    ep_c = epts[ce]  # (c, 3, g, 2)
    ew_c = ew[ce]
    n_c = space.edge_normals[ce]  # (c, 3, 2) global normals
    Xl_e = (ep_c - xc[:, None, None, :]) / h[:, None, None, None]
    m_e, _ = rtk_tabulate(k, Xl_e)  # (c, 3, g, nd, 2)
    mn = np.einsum("cegjd,ced->cegj", m_e, n_c)  # (c, 3, g, nd)
    mom = np.einsum("cegj,ceg,pg->cepj", mn, ew_c, leg)  # (c, 3, nem, nd)

    # interior moments: reference-triangle quadrature mapped to the cell
    if qdeg <= 0:
        qdeg = max(2 * k + 3, 2)
    rpts, rwts = refelem.quadrature("triangle", qdeg)
    xq = (
        v[:, 0][:, None, :]
        + rpts[None, :, 0:1] * e1[:, None, :]
        + rpts[None, :, 1:2] * e2[:, None, :]
    )  # (c, q, 2)
    wq = rwts[None, :] * np.abs(detJ)[:, None]  # sums to area per cell
    Xl_q = (xq - xc[:, None, :]) / h[:, None, None]
    m_q, div_q = rtk_tabulate(k, Xl_q)  # (c, q, nd, 2), (c, q, nd)

    V = np.empty((nc, nd, nd))
    V[:, : 3 * nem, :] = mom.reshape(nc, 3 * nem, nd)
    if nint:
        pint = np.stack(
            [Xl_q[..., 0] ** a * Xl_q[..., 1] ** b for (a, b) in int_exp],
            axis=-1,
        )  # (c, q, |int_exp|)
        V[:, 3 * nem :, :] = np.einsum(
            "cqjd,cqp,cq->cpdj", m_q, pint, wq
        ).reshape(nc, nint, nd)
    C = np.linalg.inv(V)  # (c, nd, nd): phi_i = sum_j C[c, j, i] m_j

    # --- local matrices ---------------------------------------------------
    kinv_q = np.asarray(kappa_inv_fn(xq))  # (c, q)
    phi = np.einsum("cqjd,cji->cqid", m_q, C)  # (c, q, nd, 2)
    M_loc = np.einsum("cqid,cqjd,cq->cij", phi, phi, wq * kinv_q)
    dphi = np.einsum("cqj,cji->cqi", div_q / h[:, None, None], C)
    psi = np.stack(
        [Xl_q[..., 0] ** a * Xl_q[..., 1] ** b for (a, b) in psi_exp],
        axis=-1,
    )  # (c, q, npl) DG_k basis in local coords
    B_loc = np.einsum("cqi,cql,cq->cli", dphi, psi, wq)  # (c, npl, nd)

    car = np.arange(nc)
    fdofs = np.empty((nc, nd), dtype=np.int64)
    fdofs[:, : 3 * nem] = (
        nem * ce[:, :, None] + np.arange(nem)[None, None, :]
    ).reshape(nc, 3 * nem)
    fdofs[:, 3 * nem :] = (
        nem * ne + nint * car[:, None] + np.arange(nint)[None, :]
    )
    aux = {
        "xq": xq, "wq": wq, "xc": xc, "h": h, "area": area,
        "psi_exp": psi_exp, "psi_dim": len(psi_exp), "k": k, "nd": nd,
        "nem": nem, "nint": nint,
    }
    return M_loc, B_loc, fdofs, aux


def rt1_assemble(space: RT0Space, kappa_inv_fn, qdeg: int = 5):
    """RT1 x DG1 (basix 'RT' degree 2): the k=1 instance of
    rtk_assemble, kept as the named entry the oracle and tests built
    against (same dof layout, quadrature and moments)."""
    return rtk_assemble(space, kappa_inv_fn, k=1, qdeg=qdeg)


def rtk_boundary_flux(space: RT0Space, u_fns, k: int = 1):
    """Essential RT_k flux BC values on boundary edges from exact u.

    Returns (dofs, values): the k+1 edge moments ∫ u·n P_j ds per
    boundary edge (Gauss with k+3 points — exact for polynomial u·n of
    degree up to k+5, ample for the MMS fields)."""
    nem = k + 1
    epts, s_param, ew = _edge_gauss(space, k + 3)
    leg = np.stack([_legendre_01(j, s_param) for j in range(nem)])
    be = space.boundary_edges
    un = (
        np.stack([f(epts[be].reshape(-1, 2)) for f in u_fns], axis=1)
        .reshape(len(be), -1, 2)
    )
    un = np.einsum("egd,ed->eg", un, space.edge_normals[be])
    gm = np.einsum("eg,eg,pg->ep", un, ew[be], leg)  # (nb, nem)
    dofs = (nem * be[:, None] + np.arange(nem)[None, :]).reshape(-1)
    return dofs, gm.reshape(-1)


def rt1_boundary_flux(space: RT0Space, u_fns):
    """Essential RT1 flux BC values on boundary edges from exact u
    (the k=1 instance of rtk_boundary_flux)."""
    return rtk_boundary_flux(space, u_fns, k=1)


def rt0_local_matrices(space: RT0Space, kappa_inv_c: np.ndarray):
    """(M_loc (c,3,3), B_loc (c,3)) for the mixed Darcy system.

    M_loc = int_T kappa^-1 phi_i . phi_j  (3-point edge-midpoint rule,
    exact for the quadratic integrand when kappa is cellwise constant);
    B_loc[i] = int_T div phi_i = sigma_i |e_i|.
    """
    mesh = space.mesh
    cells = mesh.cells.astype(np.int64)
    v = mesh.coords[cells]  # (c, 3, 2)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    lens = space.edge_lengths[space.cell_edges]  # (c, 3)

    # midpoints of the three edges (the quadrature points; weights |T|/3)
    mids = np.stack(
        [0.5 * (v[:, 1] + v[:, 2]), 0.5 * (v[:, 2] + v[:, 0]),
         0.5 * (v[:, 0] + v[:, 1])],
        axis=1,
    )  # (c, 3q, 2)
    # phi_i at quadrature point q: sigma_i |e_i|/(2|T|) (x_q - p_i)
    diff = mids[:, :, None, :] - v[:, None, :, :]  # (c, q, i, 2)
    coef = (space.signs * lens)[:, None, :, None] / (2.0 * area)[:, None, None, None]
    phi = coef * diff  # (c, q, i, 2)
    w = (area / 3.0)[:, None]  # (c, q)
    Mloc = np.einsum("cqid,cqjd,cq->cij", phi, phi, w * kappa_inv_c[:, None])
    Bloc = space.signs * lens  # (c, 3) = sigma |e|
    return Mloc, Bloc, area
