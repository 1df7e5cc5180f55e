"""Geometric multigrid on stencil lattices (scalar and block): a gather-free
V-cycle.

When the operator lives on a regular lattice (solvers/stencil.py), every
piece of a multigrid hierarchy is a stencil too:

  - restriction R: 2x full weighting (a fixed 3x3 [1/4 1/2 1/4]^2 stencil,
    evaluated at even lattice points)
  - prolongation P: bilinear interpolation (transpose of R, x4)
  - coarse operator A_c = R A P: ALSO a lattice stencil; its
    position-dependent weights are extracted numerically by comb probing
    (apply T = R.A.P to indicator combs whose spacing exceeds the stencil
    reach; read the rows off the responses)

Block (vector) lattices (elasticity) coarsen per component: the same
scalar transfers on each component plane, a block stencil probed with
per-component combs, point-block Jacobi smoothing.

The hierarchy is built on the host in numpy (copied from the reference)
and held as tensors on the solve's device; `LatticeGMG.precond` and
`BlockLatticeGMG.precond` are the V-cycle in PyTorch with a
dense-inverse coarse solve.

Port of pdebench_tpu/solvers/gmg.py.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stencil_kernel import StencilPlan

# ---------------------------------------------------------------------------
# host-side stencil ops (setup only) — numpy, as in the reference
# ---------------------------------------------------------------------------


def _apply_stencil_np(W: np.ndarray, offsets, u: np.ndarray) -> np.ndarray:
    pad = int(max(abs(o) for off in offsets for o in off)) if offsets else 0
    up = np.pad(u, pad)
    out = np.zeros_like(u)
    for k, off in enumerate(offsets):
        sl = tuple(slice(pad + o, pad + o + s) for o, s in zip(off, u.shape))
        out += W[k] * up[sl]
    return out


def _restrict_np(u: np.ndarray) -> np.ndarray:
    """Full weighting at even points; shape (m+1,)->(m/2+1,) per axis."""
    k = np.array([0.25, 0.5, 0.25])
    dim = u.ndim
    up = np.pad(u, 1)
    out = np.zeros_like(u)
    for off in itertools.product((-1, 0, 1), repeat=dim):
        w = np.prod([k[o + 1] for o in off])
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, u.shape))
        out += w * up[sl]
    return out[(slice(None, None, 2),) * dim]


def _prolong_np(uc: np.ndarray, fine_shape) -> np.ndarray:
    """Multilinear interpolation from the even-point coarse lattice.

    Axis-by-axis: inject at even points, then average odd points along
    each axis in turn (gives exact bi/tri-linear weights)."""
    dim = len(fine_shape)
    out = np.zeros(fine_shape, dtype=uc.dtype)
    out[(slice(None, None, 2),) * dim] = uc
    for ax in range(dim):
        odd = [slice(None)] * dim
        lo = [slice(None)] * dim
        hi = [slice(None)] * dim
        # previous axes are fully filled, later axes still even-only
        for later in range(ax + 1, dim):
            for sl in (odd, lo, hi):
                sl[later] = slice(None, None, 2)
        odd[ax] = slice(1, None, 2)
        lo[ax] = slice(None, -1, 2)
        hi[ax] = slice(2, None, 2)
        out[tuple(odd)] = 0.5 * (out[tuple(lo)] + out[tuple(hi)])
    return out


def _coarsen_stencil(
    W: np.ndarray, offsets, shape
) -> Tuple[np.ndarray, list, tuple]:
    """Galerkin coarse stencil A_c = R A P via comb probing (any dim)."""
    dim = len(shape)
    shape_c = tuple((s - 1) // 2 + 1 for s in shape)
    pad_f = int(max(abs(o) for off in offsets for o in off))
    # T's coarse reach: (pad_f + 2) / 2 rounded up
    pad_c = -(-(pad_f + 2) // 2)
    s = 2 * pad_c + 1  # comb spacing in coarse points

    # responses to coarse indicator combs, one per phase: resp[phase + site]
    resp = np.zeros((s,) * dim + shape_c)
    for phase in itertools.product(range(s), repeat=dim):
        e = np.zeros(shape_c)
        e[tuple(slice(p, None, s) for p in phase)] = 1.0
        resp[phase] = _restrict_np(
            _apply_stencil_np(W, offsets, _prolong_np(e, shape))
        )

    # A_c[i, i + off] is the response at i to the comb holding i + off
    offs_c = list(itertools.product(range(-pad_c, pad_c + 1), repeat=dim))
    grids = np.meshgrid(*[np.arange(n) for n in shape_c], indexing="ij")
    Wc = np.zeros((len(offs_c),) + shape_c)
    for k, off in enumerate(offs_c):
        col = [g + o for g, o in zip(grids, off)]
        valid = np.ones(shape_c, dtype=bool)
        for c, n in zip(col, shape_c):
            valid &= (c >= 0) & (c < n)
        Wc[k] = np.where(valid, resp[tuple(np.mod(c, s) for c in col) + tuple(grids)], 0.0)
    # drop all-zero offsets
    keep = [k for k in range(len(offs_c)) if np.abs(Wc[k]).max() > 0]
    return Wc[keep], [offs_c[k] for k in keep], shape_c


def _pad_identity(W, offsets, shape, shape_pad) -> np.ndarray:
    """Grow a stencil lattice with decoupled identity sites: weight
    planes zero-padded (no row couples into the new slab), diagonal
    plane = 1 at padded sites."""
    pads = [(0, p - s) for s, p in zip(shape, shape_pad)]
    Wp = np.stack([np.pad(np.asarray(W)[k], pads) for k in range(len(W))])
    for k, off in enumerate(offsets):
        if all(o == 0 for o in off):
            mask = np.ones(shape_pad, dtype=bool)
            mask[tuple(slice(0, s) for s in shape)] = False
            Wp[k][mask] = 1.0
    return Wp


def _dense_coarse_inv(A: np.ndarray) -> np.ndarray:
    """Dense coarse-level inverse: LU-based inv (the constrained coarse
    operator is nonsingular), SVD pinv only as the singular fallback."""
    if A.shape[0] > 4000:
        # a coarse level this size means halving stopped early
        raise ValueError(
            f"coarse level too large for dense inverse: {A.shape[0]}"
        )
    try:
        return np.linalg.inv(A)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(A)


def _level_np(W, offsets, shape):
    """(diag_inv, omega) of a level: inverse diagonal, and the damping
    0.9 / lambda_max(D^-1 A) from 8 power iterations."""
    diag = None
    for k, off in enumerate(offsets):
        if all(o == 0 for o in off):
            diag = W[k]
    diag = np.where(np.abs(diag) > 1e-300, diag, 1.0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape)
    lam = 1.0
    for _ in range(8):
        x = _apply_stencil_np(W, offsets, x) / diag
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        lam = nrm
        x /= nrm
    return 1.0 / diag, float(0.9 / max(lam, 1e-12))


def _apply_block_np(W, offsets, u):
    """u (..., d) -> (..., d) with block stencil W (K, ..., d, d)."""
    pad = int(max(abs(o) for off in offsets for o in off)) if offsets else 0
    spatial = u.shape[:-1]
    up = np.pad(u, [(pad, pad)] * len(spatial) + [(0, 0)])
    out = np.zeros_like(u)
    for k, off in enumerate(offsets):
        sl = tuple(
            slice(pad + o, pad + o + s) for o, s in zip(off, spatial)
        ) + (slice(None),)
        out += np.einsum("...ab,...b->...a", W[k], up[sl])
    return out


def _restrict_block_np(u):
    return np.stack(
        [_restrict_np(u[..., c]) for c in range(u.shape[-1])], axis=-1
    )


def _prolong_block_np(uc, fine_spatial):
    return np.stack(
        [_prolong_np(uc[..., c], fine_spatial) for c in range(uc.shape[-1])],
        axis=-1,
    )


def _coarsen_block_stencil(W, offsets, shape, d):
    """Galerkin coarse BLOCK stencil via per-component comb probing."""
    dim = len(shape)
    shape_c = tuple((s - 1) // 2 + 1 for s in shape)
    pad_f = int(max(abs(o) for off in offsets for o in off))
    pad_c = -(-(pad_f + 2) // 2)
    s = 2 * pad_c + 1

    resp = {}
    for phase in itertools.product(range(s), repeat=dim):
        for b in range(d):
            e = np.zeros(shape_c + (d,))
            e[tuple(slice(p, None, s) for p in phase) + (b,)] = 1.0
            resp[phase + (b,)] = _restrict_block_np(
                _apply_block_np(W, offsets, _prolong_block_np(e, shape))
            )

    offs_c = list(itertools.product(range(-pad_c, pad_c + 1), repeat=dim))
    grids = np.meshgrid(*[np.arange(n) for n in shape_c], indexing="ij")
    Wc = np.zeros((len(offs_c),) + shape_c + (d, d))
    for k, off in enumerate(offs_c):
        col = [g + o for g, o in zip(grids, off)]
        valid = np.ones(shape_c, dtype=bool)
        for c, n in zip(col, shape_c):
            valid &= (c >= 0) & (c < n)
        phases = [np.mod(c, s) for c in col]
        for phase in itertools.product(range(s), repeat=dim):
            m = valid.copy()
            for p, ph in zip(phases, phase):
                m &= p == ph
            if not m.any():
                continue
            for b in range(d):
                r = resp[phase + (b,)]
                Wc[k][m, :, b] = r[tuple(g[m] for g in grids)]
    keep = [k for k in range(len(offs_c)) if np.abs(Wc[k]).max() > 0]
    return Wc[keep], [offs_c[k] for k in keep], shape_c


def _block_inv_np(D):
    """Per-point inverse of (..., d, d) blocks."""
    d = D.shape[-1]
    if d == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, e = D[..., 1, 0], D[..., 1, 1]
        det = a * e - b * c
        det = np.where(np.abs(det) > 1e-300, det, 1.0)
        inv = np.empty_like(D)
        inv[..., 0, 0] = e / det
        inv[..., 0, 1] = -b / det
        inv[..., 1, 0] = -c / det
        inv[..., 1, 1] = a / det
        return inv
    return np.linalg.pinv(D)


def _block_level_np(W, offsets, shape, d):
    """(diag_inv, omega) of a block level: per-point inverse of the
    diagonal block, and the damping 0.9 / lambda_max(D^-1 A) from 8 power
    iterations."""
    D = None
    for k, off in enumerate(offsets):
        if all(o == 0 for o in off):
            D = W[k]
    Dinv = _block_inv_np(D)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(tuple(shape) + (d,))
    lam = 1.0
    for _ in range(8):
        x = np.einsum("...ab,...b->...a", Dinv, _apply_block_np(W, offsets, x))
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        lam = nrm
        x /= nrm
    return Dinv, float(0.9 / max(lam, 1e-12))


def _pad_identity_block(W, offsets, shape, shape_pad, d) -> np.ndarray:
    """Block analog of _pad_identity: spatial zero-pad, eye(d) diagonal
    blocks at the padded sites."""
    pads = [(0, p - s) for s, p in zip(shape, shape_pad)] + [(0, 0), (0, 0)]
    Wp = np.stack([np.pad(np.asarray(W)[k], pads) for k in range(len(W))])
    for k, off in enumerate(offsets):
        if all(o == 0 for o in off):
            mask = np.ones(shape_pad, dtype=bool)
            mask[tuple(slice(0, s) for s in shape)] = False
            Wp[k][mask] = np.eye(d)
    return Wp


# ---------------------------------------------------------------------------
# device-side V-cycle
# ---------------------------------------------------------------------------


@dataclass
class GMGLevel:
    W: torch.Tensor
    offsets: tuple
    pad: int
    shape: Tuple[int, ...]
    diag_inv: torch.Tensor
    omega: float
    # the stencil kernel's plan for W, built once
    plan: StencilPlan = field(repr=False)
    # identity-padded shape restriction goes THROUGH when an axis point
    # count is even (halving needs odd); None = direct halving
    pad_to: Optional[Tuple[int, ...]] = None


def _make_level(W, offsets, shape, diag_inv, omega, device, dtype) -> GMGLevel:
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    pad = int(max(abs(o) for off in offsets for o in off))
    return GMGLevel(
        W=torch.tensor(np.asarray(W), device=device).to(dtype),
        offsets=offsets,
        pad=pad,
        shape=tuple(shape),
        diag_inv=torch.tensor(np.asarray(diag_inv), device=device).to(dtype),
        omega=float(omega),
        plan=StencilPlan(shape, offsets, pad),
    )


def _device_apply(level: GMGLevel, u: torch.Tensor) -> torch.Tensor:
    return level.plan(level.W, u)


_FW = (0.25, 0.5, 0.25)


def _device_restrict(u: torch.Tensor) -> torch.Tensor:
    dim = u.dim()
    up = F.pad(u, (1,) * (2 * dim))
    out = torch.zeros_like(u)
    for off in itertools.product((-1, 0, 1), repeat=dim):
        w = 1.0
        for o in off:
            w *= _FW[o + 1]
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, u.shape))
        out = out + w * up[sl]
    return out[(slice(None, None, 2),) * dim]


def _device_prolong(uc: torch.Tensor, fine_shape) -> torch.Tensor:
    dim = len(fine_shape)
    out = torch.zeros(tuple(fine_shape), dtype=uc.dtype, device=uc.device)
    out[(slice(None, None, 2),) * dim] = uc
    for ax in range(dim):
        odd = [slice(None)] * dim
        lo = [slice(None)] * dim
        hi = [slice(None)] * dim
        for later in range(ax + 1, dim):
            for sl in (odd, lo, hi):
                sl[later] = slice(None, None, 2)
        odd[ax] = slice(1, None, 2)
        lo[ax] = slice(None, -1, 2)
        hi[ax] = slice(2, None, 2)
        out[tuple(odd)] = 0.5 * (out[tuple(lo)] + out[tuple(hi)])
    return out


@dataclass
class LatticeGMG:
    levels: List[GMGLevel]
    coarse_inv: torch.Tensor  # dense inverse on the coarsest lattice (flat)
    coarse_shape: Tuple[int, ...]
    # True when the hierarchy was coarsened from a DIFFERENT matrix than
    # the system operator: level-0 is then only a preconditioner
    surrogate: bool = False
    # True when any level restricts through an identity-padded shape
    # (even axis sizes mid-hierarchy); the fused inner solve assumes the
    # pure-halving layout and is not built for padded hierarchies
    padded: bool = False
    # fused inner solves built for this hierarchy, by inner_iters
    fused: Dict[int, Callable] = field(default_factory=dict, repr=False)

    def precond(self) -> Callable:
        def vcycle(i: int, r: torch.Tensor) -> torch.Tensor:
            if i == len(self.levels):
                flat = self.coarse_inv @ r.reshape(-1)
                return flat.reshape(self.coarse_shape)
            lv = self.levels[i]
            x = lv.omega * lv.diag_inv * r
            res = r - _device_apply(lv, x)
            if lv.pad_to is not None:
                pads = []
                for s, p in reversed(list(zip(lv.shape, lv.pad_to))):
                    pads += [0, p - s]
                res = F.pad(res, pads)
            xc = vcycle(i + 1, _device_restrict(res))
            xp = _device_prolong(xc, lv.pad_to or lv.shape)
            if lv.pad_to is not None:
                xp = xp[tuple(slice(0, s) for s in lv.shape)]
            x = x + xp
            x = x + lv.omega * lv.diag_inv * (r - _device_apply(lv, x))
            return x

        return lambda r2d: vcycle(0, r2d)


def lattice_gmg_from_numpy(
    levels: Sequence[dict],
    coarse_inv: np.ndarray,
    coarse_shape,
    device,
    dtype=torch.float32,
    padded: bool = False,
    surrogate: bool = False,
) -> LatticeGMG:
    """LatticeGMG from given numpy level data — dicts with W, offsets,
    shape, diag_inv, omega and optional pad_to — e.g. the reference
    package's hierarchy, so both packages run on the same one."""
    lvs = []
    for lv in levels:
        g = _make_level(
            lv["W"], lv["offsets"], lv["shape"], lv["diag_inv"], lv["omega"],
            device, dtype,
        )
        if lv.get("pad_to") is not None:
            g = dataclasses.replace(g, pad_to=tuple(lv["pad_to"]))
        lvs.append(g)
    return LatticeGMG(
        levels=lvs,
        coarse_inv=torch.tensor(np.asarray(coarse_inv), device=device).to(dtype),
        coarse_shape=tuple(coarse_shape),
        surrogate=surrogate,
        padded=padded,
    )


def setup_gmg(
    W: np.ndarray,
    offsets,
    shape: Tuple[int, ...],
    device,
    dtype=torch.float32,
    coarse_size: int = 600,
    max_levels: int = 10,
) -> LatticeGMG:
    """Build the stencil-GMG hierarchy for a (constrained) lattice
    operator. W must already encode Dirichlet rows as identity (use
    stencil weights of the constrained matrix)."""
    levels: List[dict] = []
    padded = False
    W_cur = np.asarray(W, dtype=np.float64)
    offs_cur = list(map(tuple, offsets))
    shape_cur = tuple(shape)
    while (
        int(np.prod(shape_cur)) > coarse_size
        and len(levels) < max_levels
        and all(s >= 5 for s in shape_cur)
    ):
        diag_inv, omega = _level_np(W_cur, offs_cur, shape_cur)
        lv = dict(
            W=W_cur, offsets=offs_cur, shape=shape_cur,
            diag_inv=diag_inv, omega=omega,
        )
        levels.append(lv)
        # halving needs an odd point count per axis; when an axis lands
        # EVEN mid-hierarchy, pad it by ONE decoupled identity plane and
        # keep coarsening — the V-cycle zero-pads residuals into (and
        # crops corrections out of) the padded slab
        if any((s - 1) % 2 != 0 for s in shape_cur):
            shape_pad = tuple(
                s + 1 if (s - 1) % 2 != 0 else s for s in shape_cur
            )
            lv["pad_to"] = shape_pad
            padded = True
            W_next = _pad_identity(W_cur, offs_cur, shape_cur, shape_pad)
            W_cur, offs_cur, shape_cur = _coarsen_stencil(
                W_next, offs_cur, shape_pad
            )
        else:
            W_cur, offs_cur, shape_cur = _coarsen_stencil(
                W_cur, offs_cur, shape_cur
            )
    # dense coarse inverse
    n = int(np.prod(shape_cur))
    A = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(shape_cur)
        e.flat[j] = 1.0
        A[:, j] = _apply_stencil_np(W_cur, offs_cur, e).reshape(-1)
    return lattice_gmg_from_numpy(
        levels, _dense_coarse_inv(A), shape_cur, device, dtype, padded=padded
    )


@dataclass
class BlockGMGLevel:
    W: torch.Tensor  # (K, ..., d, d)
    offsets: tuple
    pad: int
    shape: Tuple[int, ...]  # spatial
    d: int
    diag_inv: torch.Tensor  # (..., d, d) block inverse
    omega: float
    # the stencil kernel's block plan for W, built once
    plan: StencilPlan = field(repr=False)
    pad_to: Optional[Tuple[int, ...]] = None  # see GMGLevel.pad_to


def _device_apply_block(lv: BlockGMGLevel, u: torch.Tensor) -> torch.Tensor:
    return lv.plan(lv.W, u)


def _device_restrict_block(u: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [_device_restrict(u[..., c]) for c in range(u.shape[-1])], dim=-1
    )


def _device_prolong_block(uc: torch.Tensor, fine_spatial) -> torch.Tensor:
    return torch.stack(
        [_device_prolong(uc[..., c], fine_spatial) for c in range(uc.shape[-1])],
        dim=-1,
    )


@dataclass
class BlockLatticeGMG:
    levels: List[BlockGMGLevel]
    coarse_inv: torch.Tensor
    coarse_shape: Tuple[int, ...]
    d: int
    surrogate: bool = False  # see LatticeGMG.surrogate
    padded: bool = False  # see LatticeGMG.padded
    # fused inner solves built for this hierarchy
    fused: Dict[int, Callable] = field(default_factory=dict, repr=False)

    def precond(self) -> Callable:
        def vcycle(i: int, r: torch.Tensor) -> torch.Tensor:
            if i == len(self.levels):
                flat = self.coarse_inv @ r.reshape(-1)
                return flat.reshape(tuple(self.coarse_shape) + (self.d,))
            lv = self.levels[i]

            def smooth(rr):
                return lv.omega * torch.einsum("...ab,...b->...a", lv.diag_inv, rr)

            x = smooth(r)
            res = r - _device_apply_block(lv, x)
            if lv.pad_to is not None:
                pads = [0, 0]  # the component axis
                for s, p in reversed(list(zip(lv.shape, lv.pad_to))):
                    pads += [0, p - s]
                res = F.pad(res, pads)
            xc = vcycle(i + 1, _device_restrict_block(res))
            xp = _device_prolong_block(xc, lv.pad_to or lv.shape)
            if lv.pad_to is not None:
                xp = xp[tuple(slice(0, s) for s in lv.shape)]
            x = x + xp
            x = x + smooth(r - _device_apply_block(lv, x))
            return x

        return lambda r: vcycle(0, r)


def block_lattice_gmg_from_numpy(
    levels: Sequence[dict],
    coarse_inv: np.ndarray,
    coarse_shape,
    d: int,
    device,
    padded: bool = False,
) -> BlockLatticeGMG:
    """Float32 BlockLatticeGMG from given numpy level data — dicts with W
    (K, ..., d, d), offsets, shape, diag_inv (..., d, d), omega and
    optional pad_to — e.g. the reference package's hierarchy."""
    lvs = []
    for lv in levels:
        offsets = tuple(tuple(int(v) for v in o) for o in lv["offsets"])
        pad = int(max(abs(o) for off in offsets for o in off))
        lvs.append(BlockGMGLevel(
            W=torch.tensor(np.asarray(lv["W"]), device=device).float(),
            offsets=offsets,
            pad=pad,
            shape=tuple(lv["shape"]),
            d=int(d),
            diag_inv=torch.tensor(np.asarray(lv["diag_inv"]), device=device).float(),
            omega=float(lv["omega"]),
            pad_to=None if lv.get("pad_to") is None else tuple(lv["pad_to"]),
            plan=StencilPlan(lv["shape"], offsets, pad, ncomp=int(d)),
        ))
    return BlockLatticeGMG(
        levels=lvs,
        coarse_inv=torch.tensor(np.asarray(coarse_inv), device=device).float(),
        coarse_shape=tuple(coarse_shape),
        d=int(d),
        padded=padded,
    )


# the block hierarchy halves until at most this many coarse unknowns
# remain, or BLOCK_MAX_LEVELS levels are built (the reference's values)
BLOCK_COARSE_SIZE = 800
BLOCK_MAX_LEVELS = 10


def setup_block_gmg(
    W: np.ndarray,
    offsets,
    shape: Tuple[int, ...],
    d: int,
    device,
) -> BlockLatticeGMG:
    """Block-stencil GMG for vector lattice operators (elasticity), in
    float32."""
    levels: List[dict] = []
    padded = False
    W_cur = np.asarray(W, dtype=np.float64)
    offs_cur = list(map(tuple, offsets))
    shape_cur = tuple(shape)
    while (
        int(np.prod(shape_cur)) * d > BLOCK_COARSE_SIZE
        and len(levels) < BLOCK_MAX_LEVELS
        and all(s >= 5 for s in shape_cur)
    ):
        diag_inv, omega = _block_level_np(W_cur, offs_cur, shape_cur, d)
        lv = dict(
            W=W_cur, offsets=offs_cur, shape=shape_cur,
            diag_inv=diag_inv, omega=omega,
        )
        levels.append(lv)
        if any((s - 1) % 2 != 0 for s in shape_cur):
            # even axis mid-hierarchy: identity-pad and keep coarsening
            # (see setup_gmg)
            shape_pad = tuple(
                s + 1 if (s - 1) % 2 != 0 else s for s in shape_cur
            )
            lv["pad_to"] = shape_pad
            padded = True
            W_next = _pad_identity_block(W_cur, offs_cur, shape_cur, shape_pad, d)
            W_cur, offs_cur, shape_cur = _coarsen_block_stencil(
                W_next, offs_cur, shape_pad, d
            )
        else:
            W_cur, offs_cur, shape_cur = _coarsen_block_stencil(
                W_cur, offs_cur, shape_cur, d
            )
    n = int(np.prod(shape_cur)) * d
    A = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(shape_cur + (d,))
        e.reshape(-1)[j] = 1.0
        A[:, j] = _apply_block_np(W_cur, offs_cur, e).reshape(-1)
    return block_lattice_gmg_from_numpy(
        levels, _dense_coarse_inv(A), shape_cur, d, device, padded=padded
    )


def attach_lattice_gmg(lat32, mask_np, A_override=None) -> None:
    """Build and attach a GMG hierarchy (scalar or block) to a lattice
    operator, from the CONSTRAINED weights.

    Default path derives the constrained stencil directly from the
    operator's own weights (no CSR round trip); block operators constrain
    whole nodes (a node is masked when any of its components is).
    A_override provides a DIFFERENT matrix to coarsen (e.g. Helmholtz's
    shifted Laplacian), taking the CSR route: constrained, then stencilled
    in float32 as the reference does; the hierarchy is then marked
    `surrogate`.
    """
    from .amg import constrained_csr
    from .stencil import (
        BlockLatticeOperator,
        LatticeOperator,
        constrain_stencil_weights,
    )

    d = lat32.ncomp or 1
    mask_np = np.asarray(mask_np, dtype=bool)
    if A_override is not None:
        A_bc = constrained_csr(A_override, mask_np)
        if d > 1:
            lat_bc = BlockLatticeOperator(
                A_bc, lat32.lattice, d, "cpu", dtype=torch.float32
            )
        else:
            lat_bc = LatticeOperator(A_bc, lat32.lattice, "cpu", dtype=torch.float32)
        W_bc = lat_bc.W.numpy().astype(np.float64)
        offs = lat_bc.offsets
        if lat32.lattice.masked:
            # absent sites embed as all-zero rows; give them a unit
            # diagonal so smoothers never divide by zero
            absent = (lat32.lattice.perm == lat32.lattice.n_dof).reshape(lat32.shape)
            for k, off in enumerate(offs):
                if all(o == 0 for o in off):
                    W_bc[k][absent] = 1.0 if d == 1 else np.eye(d)
    else:
        # node-level mask in lattice order (the benchmark's BCs constrain
        # whole nodes)
        node_mask = mask_np.reshape(-1, d).any(axis=1) if d > 1 else mask_np
        # absent sites of masked lattices count as constrained (True)
        mask_lat = lat32.lattice.embed_np(node_mask, True).reshape(lat32.shape)
        W_bc = constrain_stencil_weights(
            lat32.W.detach().cpu().numpy().astype(np.float64),
            lat32.offsets,
            mask_lat,
            d=d,
        )
        offs = lat32.offsets
    if d > 1:
        lat32.gmg = setup_block_gmg(W_bc, offs, lat32.shape, d, lat32.device)
    else:
        lat32.gmg = setup_gmg(W_bc, offs, lat32.shape, lat32.device)
    lat32.gmg.surrogate = A_override is not None
