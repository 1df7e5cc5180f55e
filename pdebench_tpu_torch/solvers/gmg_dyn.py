"""Dynamic-weight Galerkin block-GMG hierarchies (per-Newton-step).

Per-Newton-step convected Jacobians (the Navier-Stokes velocity block)
share the mesh adjacency of the constant Stokes part, so their stencil
OFFSETS are fixed and only the weight planes change per step. The
hierarchy is rebuilt from the TRUE per-step Jacobian at every step.

Galerkin coarsening A_c = R A P with the fixed full-weighting R and
multilinear P is LINEAR and (up to boundary truncation)
TRANSLATION-INVARIANT in the stencil weight planes:

    A_c[I, I+oc] = sum_{k, a} cR(a) * cP(a + off_k - 2*oc) * W[k][2I+a]

with a in {-1,0,1}^dim, cR(a) = prod(1/4,1/2,1/4), cP(b) = prod(1,1/2,0
for |b|=0,1,>1): each coarse plane is a strided 3^dim correlation of the
fine planes with CONSTANT coefficients. Boundary truncation of R/P is
reproduced exactly by zero-padding the fine planes and by masking coarse
entries whose column I+oc falls outside the lattice (the `valid` planes).

Layouts. `build_levels` takes the per-step fine weights in the
reference's (K, *shape, d, d) layout (BlockLatticeWeightMap's) and
returns every level PLANAR: W (K, d, d, *shape), W[k, a, b] the plane
that multiplies component b into component a, and the smoother's
omega * inverse diagonal blocks (d, d, *shape). The V-cycle works on
planar vectors (d, *shape). That is the layout the fused kernel reads
(gmg_fused.build_fused_dyn_block_vcycle), so no call repacks.

The coarsening runs in float64 and is cast to the weights' type: it is
strided slices and one matrix product, so it does not depend on the
caller's TF32 settings (the reference runs one f32 stride-2 convolution
in 2-D, which cuDNN would take in TF32 by default on the card).

Port of pdebench_tpu/solvers/gmg_dyn.py. The numpy builders
(galerkin_coeffs, _valid_planes, coarsen_block_np, build_dyn_block_spec)
are copied; the per-step functions are rewritten for torch tensors.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stencil import tap_index

_CR = {-1: 0.25, 0: 0.5, 1: 0.25}

# coarsening stops once a level holds at most COARSE_SIZE values, or at
# MAX_LEVELS levels (the reference's defaults)
COARSE_SIZE = 700
MAX_LEVELS = 10


def _cp(b: int) -> float:
    if b == 0:
        return 1.0
    if abs(b) == 1:
        return 0.5
    return 0.0


def _taps(dim: int):
    return list(itertools.product((-1, 0, 1), repeat=dim))


def galerkin_coeffs(offsets: Sequence[Tuple[int, ...]], dim: int):
    """Static coarsening coefficients: (offs_c, C) with C[oc, k, a] =
    cR(a) * cP(a + off_k - 2*oc), offsets pruned to nonzero columns.

    Purely adjacency-determined (weight-independent), so one spec serves
    every per-step weight set on the same mesh."""
    taps = _taps(dim)
    pad_f = max(abs(o) for off in offsets for o in off)
    # |2 oc| <= |a + off_k| + 1 <= pad_f + 2  ->  |oc| <= ceil((pad_f+2)/2)
    pad_c = -(-(pad_f + 2) // 2)
    offs_c_all = list(itertools.product(range(-pad_c, pad_c + 1), repeat=dim))
    C = np.zeros((len(offs_c_all), len(offsets), len(taps)))
    for o_i, oc in enumerate(offs_c_all):
        for k, off in enumerate(offsets):
            for a_i, a in enumerate(taps):
                cr = 1.0
                cp = 1.0
                for ax in range(dim):
                    cr *= _CR[a[ax]]
                    cp *= _cp(a[ax] + off[ax] - 2 * oc[ax])
                C[o_i, k, a_i] = cr * cp
    keep = [i for i in range(len(offs_c_all)) if np.abs(C[i]).max() > 0]
    return [offs_c_all[i] for i in keep], C[keep]


def _valid_planes(offs_c, shape_c) -> np.ndarray:
    """(Oc,)+shape_c indicator: 1 where the column site I+oc exists."""
    dim = len(shape_c)
    grids = np.meshgrid(*[np.arange(n) for n in shape_c], indexing="ij")
    out = np.ones((len(offs_c),) + tuple(shape_c), dtype=np.float64)
    for i, oc in enumerate(offs_c):
        v = np.ones(shape_c, dtype=bool)
        for ax in range(dim):
            c = grids[ax] + oc[ax]
            v &= (c >= 0) & (c < shape_c[ax])
        out[i] = v
    return out


def coarsen_block_np(W, offsets, shape, offs_c, C, valid):
    """Numpy twin of coarsen_block_traced (spec probing + tests), in the
    reference's (K, *shape, d, d) layout."""
    dim = len(shape)
    shape_c = tuple((s - 1) // 2 + 1 for s in shape)
    pads = [(0, 0)] + [(1, 1)] * dim + [(0, 0), (0, 0)]
    Wp = np.pad(np.asarray(W, dtype=np.float64), pads)
    taps = []
    for a in _taps(dim):
        sl = (slice(None),) + tuple(
            slice(1 + ai, 1 + ai + 2 * (sc - 1) + 1, 2) for ai, sc in zip(a, shape_c)
        )
        taps.append(Wp[sl])
    S = np.stack(taps, axis=1)  # (K, A, *shape_c, d, d)
    Wc = np.einsum("oka,ka...->o...", C, S)
    return Wc * valid[(...,) + (None,) * 2], shape_c


def coarsen_block_traced(W, offs_c, C, valid, shape_c):
    """Galerkin coarsening of a PLANAR block stencil on its device.

    W: (K, d, d, *shape_f); C (Oc, K, 3^dim) and valid (Oc, *shape_c) as
    numpy or tensors. Returns (Oc, d, d, *shape_c) in W's dtype, summed in
    float64 (strided slices, then one matrix product)."""
    dim = len(shape_c)
    K, d = W.shape[0], W.shape[1]
    Oc = len(offs_c)
    f64 = dict(dtype=torch.float64, device=W.device)
    Wp = F.pad(W.to(torch.float64), (1,) * (2 * dim))
    taps = []
    for a in _taps(dim):
        sl = (slice(None),) * 3 + tuple(
            slice(1 + ai, 1 + ai + 2 * (sc - 1) + 1, 2) for ai, sc in zip(a, shape_c)
        )
        taps.append(Wp[sl])
    S = torch.stack(taps, dim=1)  # (K, A, d, d, *shape_c)
    Cm = torch.as_tensor(C, **f64).reshape(Oc, -1)
    Wc = (Cm @ S.reshape(Cm.shape[1], -1)).reshape((Oc, d, d) + tuple(shape_c))
    valid = torch.as_tensor(valid, **f64)
    return (Wc * valid[:, None, None]).to(W.dtype)


def constrain_block_weights_traced(W, offsets, keep, eye_d):
    """Dirichlet constraining of block stencil weights on their device:
    zero rows at masked nodes, zero taps with masked sources, eye(d)
    diagonal blocks at masked nodes. W (K, *shape, d, d) (the reference's
    layout); `keep` the lattice node indicator (1 = free, shape =
    spatial); eye_d the (d, d) identity."""
    pad = max(abs(o) for off in offsets for o in off)
    kp = F.pad(keep, (pad,) * (2 * keep.dim()))
    outs = []
    for k, off in enumerate(offsets):
        src = kp[tuple(slice(pad + o, pad + o + s) for o, s in zip(off, keep.shape))]
        Wk = W[k] * (keep * src)[..., None, None]
        if all(o == 0 for o in off):
            Wk = Wk + (1.0 - keep)[..., None, None] * eye_d
        outs.append(Wk)
    return torch.stack(outs)


def _block_inv_traced(D):
    """Per-point inverse of (..., 2, 2) blocks (Cramer); identity on
    near-singular blocks. d > 2 falls back to a diagonal inverse."""
    d = D.shape[-1]
    if d == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, e = D[..., 1, 0], D[..., 1, 1]
        det = a * e - b * c
        ok = torch.abs(det) > 1e-30
        ds = torch.where(ok, det, torch.ones_like(det))
        inv = torch.stack(
            [torch.stack([e / ds, -b / ds], dim=-1), torch.stack([-c / ds, a / ds], dim=-1)],
            dim=-2,
        )
        eye = torch.eye(2, dtype=D.dtype, device=D.device).expand(inv.shape)
        return torch.where(ok[..., None, None], inv, eye)
    dg = torch.diagonal(D, dim1=-2, dim2=-1)
    safe = torch.where(torch.abs(dg) > 1e-30, dg, torch.ones_like(dg))
    return torch.eye(d, dtype=D.dtype, device=D.device) / safe[..., None]


def _apply_block_w(W, taps, pad: int, u):
    """Planar block stencil apply with explicit weights: W (K, d, d,
    *shape), u (d, *shape) -> (d, *shape), zero outside the lattice;
    `taps` the (K, n) tap_index of the level on u's device."""
    d, K = u.shape[0], W.shape[0]
    up = F.pad(u, (pad,) * (2 * (u.dim() - 1)))
    t = up.reshape(d, -1)[:, taps]  # (d, K, n)
    out = torch.einsum("kabn,bkn->an", W.reshape(K, d, d, -1), t)
    return out.reshape(u.shape)


def _restrict(u):
    """Full weighting of the trailing (ny, nx) axes at even fine points,
    zero outside (the reference's _device_restrict per component), summed
    along x first, then y."""
    ny, nx = u.shape[-2:]
    up = F.pad(u, (1, 1, 1, 1))
    rx = 0.25 * up[..., 0:nx:2] + 0.5 * up[..., 1 : nx + 1 : 2] + 0.25 * up[..., 2 : nx + 2 : 2]
    return (
        0.25 * rx[..., 0:ny:2, :] + 0.5 * rx[..., 1 : ny + 1 : 2, :] + 0.25 * rx[..., 2 : ny + 2 : 2, :]
    )


def _prolong(uc, fine):
    """Bilinear interpolation of the trailing coarse axes onto `fine`
    (ny, nx): copy at even points, average the two neighbours at odd ones,
    along y first (at even x), then along x (the reference's
    _device_prolong per component)."""
    out = uc.new_zeros(uc.shape[:-2] + tuple(fine))
    out[..., ::2, ::2] = uc
    out[..., 1::2, ::2] = 0.5 * (out[..., :-1:2, ::2] + out[..., 2::2, ::2])
    out[..., :, 1::2] = 0.5 * (out[..., :, :-1:2] + out[..., :, 2::2])
    return out


class DynLevels(list):
    """[(W, Dinv)] per level, planar (build_levels). `cache` holds what a
    kernel built from these tensors (its packed level descriptor, which
    points at them), so that it lives exactly as long as they do."""

    def __init__(self, *args):
        super().__init__(*args)
        self.cache = {}


@dataclass
class DynLevelSpec:
    offsets: List[Tuple[int, ...]]
    shape: Tuple[int, ...]
    pad: int
    diag_k: int
    omega: float
    pad_to: Optional[Tuple[int, ...]] = None
    # coarsening to the next level (None on the coarsest)
    offs_c: Optional[List[Tuple[int, ...]]] = None
    C: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    # identity-pad constants (set when pad_to is not None)
    eye_pad: Optional[np.ndarray] = None
    # the constants above and the level's tap index on each device
    _dev: dict = field(default_factory=dict, repr=False)

    def on(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(a, device=device)
            c = dict(taps=t(tap_index(self.shape, self.offsets, self.pad)))
            if self.C is not None:
                c.update(C=t(self.C), valid=t(self.valid))
            if self.eye_pad is not None:
                c["eye_pad"] = t(np.moveaxis(self.eye_pad, (-2, -1), (1, 2)))
            self._dev[key] = c
        return self._dev[key]


@dataclass
class DynBlockHierarchySpec:
    levels: List[DynLevelSpec]
    d: int
    coarse_sweeps: int = 10

    def build_levels(self, W0: torch.Tensor) -> DynLevels:
        """Per-step hierarchy from the fine weights W0 (K, *shape0, d, d):
        [(W, omega * Dinv)] per level, planar (module docstring)."""
        out = DynLevels()
        W = W0.movedim((-2, -1), (1, 2)).contiguous()
        for i, sp in enumerate(self.levels):
            D = W[sp.diag_k].movedim((0, 1), (-2, -1))
            Dinv = (_block_inv_traced(D) * sp.omega).movedim((-2, -1), (0, 1)).contiguous()
            out.append((W, Dinv))
            if sp.C is None:
                break
            Wn = W
            if sp.pad_to is not None:
                pads = []
                for s, p in reversed(list(zip(sp.shape, sp.pad_to))):
                    pads += [0, p - s]
                Wn = F.pad(W, pads) + sp.on(W.device)["eye_pad"].to(W.dtype)
            c = sp.on(W.device)
            W = coarsen_block_traced(Wn, sp.offs_c, c["C"], c["valid"], self.levels[i + 1].shape)
        return out

    def apply(self, lv, i: int, u):
        """Level i's block stencil on a planar vector u (d, *shape_i)."""
        sp = self.levels[i]
        return _apply_block_w(lv[i][0], sp.on(u.device)["taps"], sp.pad, u)

    def vcycle(self, lv, r):
        """One V-cycle on levels lv = build_levels(W0); r planar (d,
        *shape0). Damped block-Jacobi smoothing, Jacobi sweeps on the
        coarsest stencil. 2-D levels (the transfers act on the last two
        axes)."""
        if len(self.levels[0].shape) != 2:
            raise NotImplementedError("the dynamic block V-cycle takes 2-D levels")
        n = len(lv)

        def smooth(i, rr):
            return torch.einsum("ab...,b...->a...", lv[i][1], rr)

        def go(i, r):
            sp = self.levels[i]
            x = smooth(i, r)
            if i == n - 1:
                for _ in range(self.coarse_sweeps - 1):
                    x = x + smooth(i, r - self.apply(lv, i, x))
                return x
            res = r - self.apply(lv, i, x)
            if sp.pad_to is not None:
                pads = []
                for s, p in reversed(list(zip(sp.shape, sp.pad_to))):
                    pads += [0, p - s]
                res = F.pad(res, pads)
            xc = go(i + 1, _restrict(res))
            xp = _prolong(xc, sp.pad_to or sp.shape)
            if sp.pad_to is not None:
                xp = xp[(slice(None),) + tuple(slice(0, s) for s in sp.shape)]
            x = x + xp
            return x + smooth(i, r - self.apply(lv, i, x))

        return go(0, r)

    def chain(self, lv, r, cycles: int):
        """z = V(r), then cycles - 1 times z += V(r - A0 z): the Richardson
        chain the fused kernel computes, linear in r (planar r)."""
        z = self.vcycle(lv, r)
        for _ in range(cycles - 1):
            z = z + self.vcycle(lv, r - self.apply(lv, 0, z))
        return z


def build_dyn_block_spec(
    offsets: Sequence[Tuple[int, ...]],
    shape: Tuple[int, ...],
    d: int,
    probe_W: np.ndarray,
) -> Optional[DynBlockHierarchySpec]:
    """Host-side static hierarchy spec from adjacency alone.

    probe_W: numpy block weights (K, *shape, d, d) of a REPRESENTATIVE
    operator (e.g. the constrained Stokes velocity block): per-level
    damping omegas come from power iteration on its numpy-twin hierarchy.
    Returns None when the fine stencil is non-compact."""
    from .gmg import _apply_block_np, _block_inv_np, _pad_identity_block

    dim = len(shape)
    offsets = [tuple(int(v) for v in o) for o in offsets]
    pad0 = max(abs(o) for off in offsets for o in off)
    if pad0 == 0 or pad0 > 4:
        return None

    levels: List[DynLevelSpec] = []
    offs_cur, shape_cur = offsets, tuple(shape)
    W_cur = np.asarray(probe_W, dtype=np.float64)
    while True:
        pad = max(abs(o) for off in offs_cur for o in off)
        diag_k = next(k for k, off in enumerate(offs_cur) if all(o == 0 for o in off))
        Dinv = _block_inv_np(W_cur[diag_k])
        rng = np.random.default_rng(0)
        x = rng.standard_normal(shape_cur + (d,))
        lam = 1.0
        for _ in range(8):
            x = np.einsum("...ab,...b->...a", Dinv, _apply_block_np(W_cur, offs_cur, x))
            nrm = np.linalg.norm(x)
            if nrm == 0:
                break
            lam = nrm
            x /= nrm
        omega = float(0.9 / max(lam, 1e-12))
        sp = DynLevelSpec(offsets=offs_cur, shape=shape_cur, pad=pad, diag_k=diag_k, omega=omega)
        done = (
            int(np.prod(shape_cur)) * d <= COARSE_SIZE
            or len(levels) + 1 >= MAX_LEVELS
            or any(s < 5 for s in shape_cur)
        )
        if done:
            levels.append(sp)
            break
        shape_pad = shape_cur
        if any((s - 1) % 2 != 0 for s in shape_cur):
            shape_pad = tuple(s + 1 if (s - 1) % 2 != 0 else s for s in shape_cur)
            sp.pad_to = shape_pad
            eye_pad = np.zeros((len(offs_cur),) + shape_pad + (d, d))
            m = np.ones(shape_pad, dtype=bool)
            m[tuple(slice(0, s) for s in shape_cur)] = False
            eye_pad[diag_k][m] = np.eye(d)
            sp.eye_pad = eye_pad
            W_cur = _pad_identity_block(W_cur, offs_cur, shape_cur, shape_pad, d)
        offs_c, C = galerkin_coeffs(offs_cur, dim)
        shape_c = tuple((s - 1) // 2 + 1 for s in shape_pad)
        valid = _valid_planes(offs_c, shape_c)
        sp.offs_c, sp.C, sp.valid = offs_c, C, valid
        levels.append(sp)
        W_cur, _ = coarsen_block_np(W_cur, offs_cur, shape_pad, offs_c, C, valid)
        offs_cur, shape_cur = offs_c, shape_c
    return DynBlockHierarchySpec(levels=levels, d=d)
