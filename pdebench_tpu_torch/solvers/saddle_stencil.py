"""Gather-free Taylor-Hood saddle apply on structured meshes.

The [[A, G], [G^T, 0]] saddle matvec is the inner-loop cost of every
device Navier-Stokes solve (the Newton FGMRES-IR). On structured meshes
the Taylor-Hood dof sets are nested lattices:

  velocity (P2 scalar nodes): the fine (r*R+1)^dim tensor lattice
  pressure (P1 nodes):        the coarse (R+1)^dim lattice, sitting at
                              every r-th fine site (r = deg_u/deg_p)

so all three blocks are stencils:

  A   — a (d x d)-block stencil on the fine lattice
        (BlockLatticeWeightMap: per-Newton-step weights)
  G   — an inter-lattice stencil: the pressure read at the fine sites
        that are coarse sites (zero elsewhere), |offsets| taps per
        velocity component
  G^T — the transpose stencil evaluated only at coarse sites

Each apply gathers all taps of a block at once through index tensors
built here on the host, then contracts: a handful of launches per apply
on the card. (The reference slices its padded planes once per tap, and
upsamples the pressure for G with `_upsample`; the G index reads the
coarse site directly where a fine site is one, and a zero elsewhere.)
Everything is dtype-polymorphic: the f32 twin runs the inner Krylov, the
f64 twin gives the refinement outer an exact operator.

`LatticeSaddleVectors` keeps a saddle solve's Krylov vectors in lattice
layout, [u_lat (nf*d); p_lat (nc)]: one embed of the rhs and one extract
of the solution per solve, no dof <-> lattice gather per iteration (the
Stokes MINRES on its 2-D lattices).

Port of pdebench_tpu/solvers/saddle_stencil.py (SaddleStencil,
LatticeSaddleVectors without the block-triangular `tri_M` of the
reference's opt-in FGMRES routes, build_saddle_stencil).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .stencil import BlockLatticeWeightMap, Lattice, _unique_offsets, detect_lattice


def _lattice_coords(lat: Lattice, flat: np.ndarray) -> np.ndarray:
    """Flat lattice indices -> integer coordinates (…, dim)."""
    out = []
    rem = flat
    for s in reversed(lat.shape):
        out.append(rem % s)
        rem = rem // s
    return np.stack(list(reversed(out)), axis=-1)


def _flat(coords: np.ndarray, shape) -> np.ndarray:
    """Integer coordinates (…, dim) -> flat indices, row-major."""
    flat = np.zeros(coords.shape[:-1], dtype=np.int64)
    for ax, n in enumerate(shape):
        flat = flat * n + coords[..., ax]
    return flat


class SaddleStencil:
    """Stencil saddle apply for one Taylor-Hood pair (V, Q).

    Built on the host once per mesh; `saddle_apply_w(WA)` returns an apply
    on the stacked flat vector [u; p] whose A-block weights can be freshly
    mapped per Newton step via `wmapA`. The G / G^T weights and the index
    tensors move to a device at their first use there.
    """

    def __init__(
        self,
        lat_u: Lattice,
        lat_p: Lattice,
        ratio: int,
        ncomp: int,
        wmapA: BlockLatticeWeightMap,
        offs_g,
        WG: np.ndarray,
        offs_gt,
        WGT: np.ndarray,
    ):
        self.lat_u = lat_u
        self.lat_p = lat_p
        self.r = int(ratio)
        self.d = int(ncomp)
        self.wmapA = wmapA
        self.fine = lat_u.shape
        self.coarse = lat_p.shape
        self.offs_g = offs_g
        self.offs_gt = offs_gt
        self.WG = np.asarray(WG)  # (Kg, *fine, d)
        self.WGT = np.asarray(WGT)  # (Kgt, *coarse, d)
        d = self.d
        # block-level (node, comp) injection for the velocity vector
        n_lat = int(np.prod(self.fine))
        n_u = lat_u.n_dof * d
        dof_nodes = np.arange(n_u) // d
        dof_comp = np.arange(n_u) % d
        lat_flat = lat_u.inv[dof_nodes] * d + dof_comp
        perm = np.full(n_lat * d, n_u, dtype=np.int64)
        perm[lat_flat] = np.arange(n_u)
        self.blat = Lattice(
            shape=self.fine + (d,), perm=perm, inv=lat_flat, n_dof=n_u, masked=lat_u.masked,
        )
        self.n_u = n_u
        # G taps: the coarse site at fine site s + off, or the sentinel n_c
        # (a zero) where s + off is outside the lattice or off the coarse
        # sites; G^T taps: the fine site c * r + off, or the sentinel n_f
        n_c = int(np.prod(self.coarse))
        fs = _lattice_coords(lat_u, np.arange(n_lat))
        cs = _lattice_coords(lat_p, np.arange(n_c))
        fine_arr = np.asarray(self.fine)
        self._g_np = np.full((len(offs_g), n_lat), n_c, dtype=np.int64)
        for k, off in enumerate(offs_g):
            t = fs + np.asarray(off)
            ok = np.all((t >= 0) & (t < fine_arr) & (t % self.r == 0), axis=-1)
            self._g_np[k, ok] = _flat(t[ok] // self.r, self.coarse)
        self._gt_np = np.full((len(offs_gt), n_c), n_lat, dtype=np.int64)
        for k, off in enumerate(offs_gt):
            t = cs * self.r + np.asarray(off)
            ok = np.all((t >= 0) & (t < fine_arr), axis=-1)
            self._gt_np[k, ok] = _flat(t[ok], self.fine)
        self._dev = {}

    def on(self, device) -> dict:
        """The weights and index tensors on `device`, made once."""
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(a, device=device)
            WG64, WGT64 = t(self.WG).to(torch.float64), t(self.WGT).to(torch.float64)
            self._dev[key] = dict(
                WG64=WG64, WG32=WG64.float(), WGT64=WGT64, WGT32=WGT64.float(),
                g=t(self._g_np), gt=t(self._gt_np),
                perm_u=t(self.blat.perm), inv_u=t(self.blat.inv),
                perm_p=t(self.lat_p.perm), inv_p=t(self.lat_p.inv),
            )
        return self._dev[key]

    # -- lattice <-> dof vectors ----------------------------------------

    def embed_u(self, u: torch.Tensor) -> torch.Tensor:
        """Velocity dof vector -> (*fine, d) lattice array (absent sites 0)."""
        perm = self.on(u.device)["perm_u"]
        if self.blat.masked:
            u = torch.cat([u, u.new_zeros(1)])
        return u[perm].reshape(self.fine + (self.d,))

    def extract_u(self, u_lat: torch.Tensor) -> torch.Tensor:
        return u_lat.reshape(-1)[self.on(u_lat.device)["inv_u"]]

    def embed_p(self, p: torch.Tensor) -> torch.Tensor:
        perm = self.on(p.device)["perm_p"]
        if self.lat_p.masked:
            p = torch.cat([p, p.new_zeros(1)])
        return p[perm].reshape(self.coarse)

    def extract_p(self, p_lat: torch.Tensor) -> torch.Tensor:
        return p_lat.reshape(-1)[self.on(p_lat.device)["inv_p"]]

    # -- block applies ---------------------------------------------------

    def applyG(self, W: torch.Tensor, p_lat: torch.Tensor) -> torch.Tensor:
        """(coarse,) pressure lattice -> (fine…, d) velocity lattice."""
        g = self.on(p_lat.device)["g"]
        p_ext = torch.cat([p_lat.reshape(-1), p_lat.new_zeros(1)])
        out = torch.einsum("kna,kn->na", W.reshape(len(self.offs_g), -1, self.d), p_ext[g])
        return out.reshape(self.fine + (self.d,))

    def applyGT(self, W: torch.Tensor, u_lat: torch.Tensor) -> torch.Tensor:
        """(fine…, d) velocity lattice -> (coarse,) pressure lattice."""
        gt = self.on(u_lat.device)["gt"]
        u_ext = torch.cat([u_lat.reshape(-1, self.d), u_lat.new_zeros(1, self.d)])
        out = torch.einsum("kna,kna->n", W.reshape(len(self.offs_gt), -1, self.d), u_ext[gt])
        return out.reshape(self.coarse)

    def saddle_apply_w(self, WA: torch.Tensor) -> Callable:
        """Matrix-free [[A, G], [G^T, 0]] on the stacked flat vector, with
        explicit (per-Newton-step) A-block weights. The G / G^T weights
        follow WA's dtype (f32 inner / f64 outer)."""
        dv = self.on(WA.device)
        f32 = WA.dtype == torch.float32
        WG = dv["WG32"] if f32 else dv["WG64"]
        WGT = dv["WGT32"] if f32 else dv["WGT64"]

        def apply(x):
            u, p = x[: self.n_u].to(WA.dtype), x[self.n_u :].to(WA.dtype)
            u_lat = self.embed_u(u)
            ru = self.wmapA.apply_grid(WA, u_lat) + self.applyG(WG, self.embed_p(p))
            rp = self.applyGT(WGT, u_lat)
            return torch.cat([self.extract_u(ru), self.extract_p(rp)]).to(x.dtype)

        return apply


class LatticeSaddleVectors:
    """Lattice-layout saddle Krylov vectors: [u_lat (nf*d); p_lat (nc)].

    The flat-dof saddle iteration pays the dof <-> lattice gathers in
    every operator and preconditioner apply; keeping every Krylov vector
    in lattice layout moves them to one embed of the rhs and one extract
    of the solution per solve. Absent masked-lattice sites and the
    constrained dofs (Dirichlet velocity, the pinned pressure) are
    constrained identity rows of `mask_lat`, so they stay exactly zero
    through the constrained-operator wrappers and contribute nothing to
    inner products.
    """

    def __init__(self, sst: SaddleStencil, mask_np: np.ndarray, device):
        self.sst = sst
        self.device = device
        nf = int(np.prod(sst.fine))
        nc = int(np.prod(sst.coarse))
        self.n_u = nf * sst.d
        self.n = nf * sst.d + nc
        m = np.asarray(mask_np, dtype=bool)
        mu = sst.blat.embed_np(m[: sst.n_u], True)
        mp = sst.lat_p.embed_np(m[sst.n_u :], True)
        self.mask_lat = torch.as_tensor(np.concatenate([mu, mp]), device=device)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """[u; p] flat dof vector -> lattice-layout vector, 0 off the dofs."""
        sst = self.sst
        u = sst.blat.embed(x[: sst.n_u], 0.0)
        p = sst.lat_p.embed(x[sst.n_u :], 0.0)
        return torch.cat([u, p])

    def extract(self, x_lat: torch.Tensor) -> torch.Tensor:
        """Lattice-layout vector -> [u; p] flat dof vector."""
        return torch.cat([self.sst.extract_u(x_lat[: self.n_u]), self.sst.extract_p(x_lat[self.n_u :])])

    def apply_w(self, WA: torch.Tensor) -> Callable:
        """Saddle apply on lattice-layout vectors, with A-block weights WA
        (one block stencil launch on CUDA tensors); the G / G^T weights
        follow WA's dtype."""
        sst = self.sst
        dv = sst.on(WA.device)
        f32 = WA.dtype == torch.float32
        WG = dv["WG32"] if f32 else dv["WG64"]
        WGT = dv["WGT32"] if f32 else dv["WGT64"]

        def apply(x):
            u_lat = x[: self.n_u].to(WA.dtype).reshape(sst.fine + (sst.d,))
            p_lat = x[self.n_u :].to(WA.dtype).reshape(sst.coarse)
            ru = sst.wmapA.apply_grid(WA, u_lat) + sst.applyG(WG, p_lat)
            rp = sst.applyGT(WGT, u_lat)
            return torch.cat([ru.reshape(-1), rp.reshape(-1)]).to(x.dtype)

        return apply

    def block_diag_M(self, Mv_grid: Callable, schur: torch.Tensor) -> Callable:
        """Block-diagonal SPD M (MINRES) on lattice-layout vectors:
        Mv_grid on the (fine..., d) velocity block, the lattice-shaped
        Schur diagonal `schur` (cast to r's dtype) on the pressure."""
        sst = self.sst
        mask_lat = self.mask_lat

        def M(r):
            zu = Mv_grid(r[: self.n_u].reshape(sst.fine + (sst.d,)))
            zp = schur.to(r.dtype) * r[self.n_u :].reshape(sst.coarse)
            return torch.where(mask_lat, r, torch.cat([zu.reshape(-1), zp.reshape(-1)]))

        return M

    def embed_plane_p(self, v_dof: np.ndarray) -> torch.Tensor:
        """Host pressure dof vector -> coarse-lattice plane on the device,
        1 off the dofs."""
        plane = self.sst.lat_p.embed_np(np.asarray(v_dof), 1.0).reshape(self.sst.coarse)
        return torch.as_tensor(plane, device=self.device)


def build_saddle_stencil(V, Q, G_loc_np: np.ndarray) -> Optional[SaddleStencil]:
    """SaddleStencil for a Taylor-Hood pair, or None when the dof sets
    aren't nested lattices (unstructured/complex domains, periodic)."""
    lat_u = detect_lattice(V.dof_coords)
    lat_p = detect_lattice(Q.dof_coords)
    if lat_u is None or lat_p is None:
        return None
    if len(lat_u.shape) != len(lat_p.shape):
        return None
    # nesting ratio: fine = (coarse - 1) * r + 1 on every axis, same r
    rs = set()
    for su, sp in zip(lat_u.shape, lat_p.shape):
        if sp < 2 or (su - 1) % (sp - 1) != 0:
            return None
        rs.add((su - 1) // (sp - 1))
    if len(rs) != 1:
        return None
    r = rs.pop()
    # both lattices must span the same box (same mesh => exact nesting)
    if not (
        np.allclose(V.dof_coords.min(0), Q.dof_coords.min(0), atol=1e-12)
        and np.allclose(V.dof_coords.max(0), Q.dof_coords.max(0), atol=1e-12)
    ):
        return None
    d = int(V.ncomp)

    wmapA = BlockLatticeWeightMap(lat_u, V.dofmap_scalar, d)
    if wmapA.pad == 0 or wmapA.pad > 4:
        return None

    # G couplings from the cell-local batch (host bincount)
    G = np.asarray(G_loc_np, dtype=np.float64)  # (c, nlu_s*d, nlp)
    dm_u = np.asarray(V.dofmap)  # blocked (c, nlu_s*d)
    dm_p = np.asarray(Q.dofmap_scalar)  # (c, nlp)
    c, nlu, nlp = G.shape
    rows = np.broadcast_to(dm_u[:, :, None], (c, nlu, nlp)).reshape(-1)
    cols = np.broadcast_to(dm_p[:, None, :], (c, nlu, nlp)).reshape(-1)
    vals = G.reshape(-1)

    node = rows // d
    comp = rows % d
    fu = lat_u.inv[node]  # fine flat site per entry
    pc = lat_p.inv[cols]  # coarse flat site per entry
    rc = _lattice_coords(lat_u, fu)
    cc = _lattice_coords(lat_p, pc)
    doff = cc * r - rc  # fine-unit offsets, velocity-row-relative
    offs_g, og_idx = _unique_offsets(doff)
    pad_g = int(np.abs(offs_g).max()) if len(offs_g) else 0
    if pad_g > 2 * r + 2:  # wrap-around (periodic) — out of scope
        return None
    n_f = int(np.prod(lat_u.shape))
    n_c = int(np.prod(lat_p.shape))
    WG = np.bincount(
        (og_idx * n_f + fu) * d + comp, weights=vals, minlength=len(offs_g) * n_f * d,
    ).reshape((len(offs_g),) + lat_u.shape + (d,))

    offs_gt, ogt_idx = _unique_offsets(-doff)
    WGT = np.bincount(
        (ogt_idx * n_c + pc) * d + comp, weights=vals, minlength=len(offs_gt) * n_c * d,
    ).reshape((len(offs_gt),) + lat_p.shape + (d,))

    return SaddleStencil(
        lat_u, lat_p, r, d, wmapA,
        [tuple(int(v) for v in o) for o in offs_g], WG,
        [tuple(int(v) for v in o) for o in offs_gt], WGT,
    )
