"""Geometric multigrid on stencil lattices (scalar): a gather-free V-cycle.

When the operator lives on a regular lattice (solvers/stencil.py), every
piece of a multigrid hierarchy is a stencil too:

  - restriction R: 2x full weighting (a fixed 3x3 [1/4 1/2 1/4]^2 stencil,
    evaluated at even lattice points)
  - prolongation P: bilinear interpolation (transpose of R, x4)
  - coarse operator A_c = R A P: ALSO a lattice stencil; its
    position-dependent weights are extracted numerically by comb probing
    (apply T = R.A.P to indicator combs whose spacing exceeds the stencil
    reach; read the rows off the responses)

The hierarchy is built on the host in numpy (copied from the reference)
and held as tensors on the solve's device; `LatticeGMG.precond` is the
V-cycle in PyTorch with a dense-inverse coarse solve.

Port of the scalar half of pdebench_tpu/solvers/gmg.py.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stencil import apply_stencil

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

    # responses to coarse indicator combs, one per phase
    resp = {}
    for phase in itertools.product(range(s), repeat=dim):
        e = np.zeros(shape_c)
        e[tuple(slice(p, None, s) for p in phase)] = 1.0
        resp[phase] = _restrict_np(
            _apply_stencil_np(W, offsets, _prolong_np(e, shape))
        )

    offs_c = list(itertools.product(range(-pad_c, pad_c + 1), repeat=dim))
    grids = np.meshgrid(*[np.arange(n) for n in shape_c], indexing="ij")
    Wc = np.zeros((len(offs_c),) + shape_c)
    for k, off in enumerate(offs_c):
        col = [g + o for g, o in zip(grids, off)]
        valid = np.ones(shape_c, dtype=bool)
        for c, n in zip(col, shape_c):
            valid &= (c >= 0) & (c < n)
        phases = [np.mod(c, s) for c in col]
        vals = np.zeros(shape_c)
        for phase in itertools.product(range(s), repeat=dim):
            m = valid.copy()
            for p, ph in zip(phases, phase):
                m &= p == ph
            if m.any():
                vals[m] = resp[phase][tuple(g[m] for g in grids)]
        Wc[k] = vals
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
    # identity-padded shape restriction goes THROUGH when an axis point
    # count is even (halving needs odd); None = direct halving
    pad_to: Optional[Tuple[int, ...]] = None


def _make_level(W, offsets, shape, diag_inv, omega, device, dtype) -> GMGLevel:
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    return GMGLevel(
        W=torch.tensor(np.asarray(W), device=device).to(dtype),
        offsets=offsets,
        pad=int(max(abs(o) for off in offsets for o in off)),
        shape=tuple(shape),
        diag_inv=torch.tensor(np.asarray(diag_inv), device=device).to(dtype),
        omega=float(omega),
    )


def _device_apply(level: GMGLevel, u: torch.Tensor) -> torch.Tensor:
    return apply_stencil(level.W, level.offsets, level.pad, u)


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


def attach_lattice_gmg(lat32, mask_np) -> None:
    """Build and attach a scalar GMG hierarchy to a lattice operator,
    from the CONSTRAINED weights derived directly from the operator's
    own stencil (no CSR round trip)."""
    from .stencil import constrain_stencil_weights

    mask_np = np.asarray(mask_np, dtype=bool)
    # absent sites of masked lattices count as constrained (True)
    mask_lat = lat32.lattice.embed_np(mask_np, True).reshape(lat32.shape)
    W_bc = constrain_stencil_weights(
        lat32.W.detach().cpu().numpy().astype(np.float64),
        lat32.offsets,
        mask_lat,
    )
    lat32.gmg = setup_gmg(W_bc, lat32.offsets, lat32.shape, lat32.device)
