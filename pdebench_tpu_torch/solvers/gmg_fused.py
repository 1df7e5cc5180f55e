"""Fused GMG-preconditioned inner CG: one CUDA launch per inner solve.

The mixed-precision refinement's inner loop (krylov.refined_solve) runs
`inner_iters` PCG steps, each a fine-level stencil apply plus a full
V-cycle. `build_fused_inner_cg` runs the whole inner solve as ONE kernel
(csrc/gmg_fused_cg.cu, a cooperative persistent launch whose hierarchy
stays in L2) on CUDA tensors, and as its plain PyTorch version on CPU
tensors. Both hold the math of the Pallas kernel this replaces
(pdebench_tpu/solvers/gmg_fused.py::build_fused_inner_cg, mode "cg"):

  - stencil taps read zero outside each level
  - restriction / prolongation: the truncated [1/4, 1/2, 1/4] band and
    its bilinear transpose (banded matmuls in the plain version, direct
    3x3 stencils in the kernel)
  - coarsest solve: an extra level probed one below the GMG's last,
    smoothed by COARSE_SWEEPS damped-Jacobi sweeps (a slightly weaker
    coarse solve than LatticeGMG.precond's dense inverse)
  - CG recurrence with the |denominator| > 0 guards

The numpy hierarchy builders are copied from the reference, without its
(8, 128) TPU tile padding. Scope: scalar 2-D lattices whose hierarchy
halves at every level (not `padded`), float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .stencil_kernel import stencil_apply_2d_torch

COARSE_SWEEPS = 10

# kernel launches in this process (the plain version is not counted)
LAUNCHES = 0

# limits of csrc/gmg_fused_cg.cu (kMaxLevels, kMaxTaps)
_MAX_LEVELS = 8
_MAX_TAPS = 64


def _restrict_band(n_f: int) -> np.ndarray:
    """(n_c, n_f) full-weighting band: rows [1/4, 1/2, 1/4] at even
    fine points (boundary-truncated, matching gmg._restrict_np)."""
    n_c = (n_f - 1) // 2 + 1
    B = np.zeros((n_c, n_f))
    for i in range(n_c):
        j = 2 * i
        B[i, j] = 0.5
        if j - 1 >= 0:
            B[i, j - 1] = 0.25
        if j + 1 < n_f:
            B[i, j + 1] = 0.25
    return B


def _prolong_band(n_f: int) -> np.ndarray:
    """(n_f, n_c) linear-interpolation band (matching _prolong_np)."""
    n_c = (n_f - 1) // 2 + 1
    B = np.zeros((n_f, n_c))
    for j in range(n_f):
        if j % 2 == 0:
            B[j, j // 2] = 1.0
        else:
            B[j, (j - 1) // 2] = 0.5
            B[j, (j + 1) // 2] = 0.5
    return B


class _Level:
    """A 2-D level as the fused inner solve takes it: float32 weight
    planes (K, ny, nx) and omega * inverse diagonal (ny, nx), unpadded."""

    def __init__(self, W, offsets, pad, shape, diag_inv, omega):
        ny, nx = shape
        self.ny, self.nx = ny, nx
        self.pad = pad
        self.offsets = offsets
        self.W = np.asarray(W, np.float32)
        self.dinv = omega * np.asarray(diag_inv, np.float32)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _probe_extra_coarse(levels):
    """Re-probe one level below the GMG's last, numpy-only. Returns
    (W, offsets, pad, shape, diag_inv, omega) or None when the last level
    isn't halvable."""
    from .gmg import _apply_stencil_np, _coarsen_stencil

    if not all((s - 1) % 2 == 0 and s >= 5 for s in levels[-1].shape):
        return None
    Wc, offs_c, shape_c = _coarsen_stencil(
        _host(levels[-1].W).astype(np.float64),
        [tuple(o) for o in levels[-1].offsets],
        levels[-1].shape,
    )
    diag_c = None
    for k, off in enumerate(offs_c):
        if all(o == 0 for o in off):
            diag_c = Wc[k]
    diag_c = np.where(np.abs(diag_c) > 1e-300, diag_c, 1.0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape_c)
    lam = 1.0
    for _ in range(8):
        x = _apply_stencil_np(Wc, offs_c, x) / diag_c
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        lam = nrm
        x /= nrm
    pad_c = int(max(abs(o) for off in offs_c for o in off))
    return (
        Wc, [tuple(o) for o in offs_c], pad_c, shape_c,
        1.0 / diag_c, float(0.9 / max(lam, 1e-12)),
    )


def _scalar_hierarchy(gmg):
    """Scalar 2-D hierarchy for the fused inner solve: the GMG's levels,
    an extra probed coarsest level (smoothed on its stencil instead of a
    dense inverse), and the per-level-pair transfer bands.
    Returns (lv, Bry, Brx, Bpy, Bpx, static_bytes), or None for padded
    or non-2-D hierarchies."""
    levels = getattr(gmg, "levels", None)
    if getattr(gmg, "padded", False):
        # identity-padded restriction shapes (even mid-hierarchy axes)
        # break the pure-halving transfer layout assumed here
        return None
    if not levels or len(levels[0].shape) != 2:
        return None
    lv = [
        _Level(
            _host(l.W), [tuple(o) for o in l.offsets], l.pad,
            l.shape, _host(l.diag_inv), l.omega,
        )
        for l in levels
    ]
    extra = _probe_extra_coarse(levels)
    if extra is not None:
        lv.append(_Level(*extra))

    Bry, Brx, Bpy, Bpx = [], [], [], []
    for f in lv[:-1]:
        Bry.append(_restrict_band(f.ny).astype(np.float32))
        Brx.append(_restrict_band(f.nx).astype(np.float32))
        Bpy.append(_prolong_band(f.ny).astype(np.float32))
        Bpx.append(_prolong_band(f.nx).astype(np.float32))
    static = sum(l.W.nbytes + l.dinv.nbytes for l in lv) + sum(
        b.nbytes for bl in (Bry, Brx, Bpy, Bpx) for b in bl
    )
    return lv, Bry, Brx, Bpy, Bpx, static


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gmg_fused_cg")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gmg_fused_cg_desc_bytes.argtypes = []
    lib.gmg_fused_cg_desc_bytes.restype = i
    lib.gmg_fused_cg_grid.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.gmg_fused_cg_grid.restype = i
    # out, nlev, ptrs (int64 x 5 per level), dims (int32 x 3 per level),
    # offsets (int32 x 2 per tap), p, Ap, partial
    lib.gmg_fused_cg_pack.argtypes = [
        vp, i, vp, vp, vp, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong,
    ]
    lib.gmg_fused_cg_pack.restype = i
    # desc, r, z, iters, blocks, stream
    lib.gmg_fused_cg_launch.argtypes = [vp, vp, vp, i, i, vp]
    lib.gmg_fused_cg_launch.restype = i
    return lib


class FusedInnerCG:
    """fn(r_lat_flat_f32) -> z_lat_flat_f32: `inner_iters` GMG-PCG steps.

    The hierarchy lives on `device`. A CPU tensor runs `plain` (PyTorch);
    a CUDA tensor runs `launch` (the kernel). Calls on one object must
    not overlap on different streams: the kernel's work vectors are
    allocated once, with the hierarchy.
    """

    def __init__(self, lv: List[_Level], bands, inner_iters: int, device):
        self.inner_iters = int(inner_iters)
        self.shape = (lv[0].ny, lv[0].nx)

        def t(a):
            return torch.as_tensor(a, device=device)

        self.W = [t(l.W) for l in lv]
        # the concrete device ("cuda:0" for "cuda"), as tensors report it
        self.device = self.W[0].device
        self.D = [t(l.dinv) for l in lv]
        self.offsets = [[tuple(int(v) for v in o) for o in l.offsets] for l in lv]
        self.pads = [int(l.pad) for l in lv]
        self.bands = [[t(b) for b in bl] for bl in bands]  # Bry, Brx, Bpy, Bpx
        self._cuda = None

    # -- plain PyTorch version ------------------------------------------

    def _apply(self, l: int, u: torch.Tensor) -> torch.Tensor:
        p = self.pads[l]
        return stencil_apply_2d_torch(
            F.pad(u, (p, p, p, p)), self.W[l], self.offsets[l], p
        )

    def _vcycle(self, l: int, r: torch.Tensor) -> torch.Tensor:
        D = self.D[l]
        x = D * r
        if l == len(self.W) - 1:
            for _ in range(COARSE_SWEEPS - 1):
                x = x + D * (r - self._apply(l, x))
            return x
        By, Bx, Py, Px = (b[l] for b in self.bands)
        res = r - self._apply(l, x)
        xc = self._vcycle(l + 1, By @ (res @ Bx.T))
        x = x + Py @ (xc @ Px.T)
        return x + D * (r - self._apply(l, x))

    def plain(self, r_flat: torch.Tensor) -> torch.Tensor:
        """The inner solve in PyTorch ops, on the hierarchy's device."""
        self._check(r_flat)
        r0 = r_flat.reshape(self.shape)
        p = self._vcycle(0, r0)
        rz = torch.sum(r0 * p)
        z = torch.zeros_like(r0)
        res = r0
        for _ in range(self.inner_iters):
            Ap = self._apply(0, p)
            denom = torch.sum(p * Ap)
            alpha = rz / torch.where(torch.abs(denom) > 0, denom, 1.0)
            z = z + alpha * p
            res = res - alpha * Ap
            s = self._vcycle(0, res)
            rz_new = torch.sum(res * s)
            beta = rz_new / torch.where(torch.abs(rz) > 0, rz, 1.0)
            p = s + beta * p
            rz = rz_new
        return z.reshape(-1)

    # -- CUDA kernel ----------------------------------------------------

    def _setup_cuda(self):
        lib = _lib()
        n = [W.shape[1] * W.shape[2] for W in self.W]
        dev = self.device
        work = [torch.zeros((3, m), dtype=torch.float32, device=dev) for m in n]
        p = torch.zeros(n[0], dtype=torch.float32, device=dev)
        Ap = torch.zeros_like(p)
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check(lib, lib.gmg_fused_cg_grid(n[0], ctypes.byref(blocks)),
                         "gmg_fused_cg_grid")
        partial = torch.zeros(2 * blocks.value, dtype=torch.float64, device=dev)
        ptrs = np.array(
            [
                [W.data_ptr(), D.data_ptr()] + [w[j].data_ptr() for j in range(3)]
                for W, D, w in zip(self.W, self.D, work)
            ],
            dtype=np.int64,
        )
        dims = np.array(
            [[W.shape[1], W.shape[2], W.shape[0]] for W in self.W], dtype=np.int32
        )
        offs = np.array(
            [o for lvl in self.offsets for o in lvl], dtype=np.int32
        ).reshape(-1)
        desc = np.zeros(lib.gmg_fused_cg_desc_bytes(), dtype=np.uint8)
        code = lib.gmg_fused_cg_pack(
            desc.ctypes.data_as(ctypes.c_void_p), len(self.W),
            ptrs.ctypes.data_as(ctypes.c_void_p),
            dims.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p),
            p.data_ptr(), Ap.data_ptr(), partial.data_ptr(),
        )
        _build.check(lib, code, "gmg_fused_cg_pack")
        # the buffers live as long as this object: the descriptor holds
        # their addresses
        self._cuda = dict(
            lib=lib, work=work, p=p, Ap=Ap, partial=partial,
            blocks=blocks.value, desc=torch.from_numpy(desc).to(dev),
        )

    def launch(self, r_flat: torch.Tensor) -> torch.Tensor:
        """The inner solve as one cooperative kernel launch."""
        global LAUNCHES
        self._check(r_flat)
        if self.device.type != "cuda":
            raise ValueError(f"the kernel runs on CUDA tensors, not {self.device}")
        if self._cuda is None:
            self._setup_cuda()
        c = self._cuda
        r = r_flat.contiguous()
        z = torch.empty_like(r)
        code = c["lib"].gmg_fused_cg_launch(
            ctypes.c_void_p(c["desc"].data_ptr()),
            ctypes.c_void_p(r.data_ptr()),
            ctypes.c_void_p(z.data_ptr()),
            self.inner_iters, c["blocks"],
            _build.current_stream(self.device),
        )
        _build.check(c["lib"], code, "gmg_fused_cg_launch")
        LAUNCHES += 1
        return z

    def _check(self, r_flat: torch.Tensor) -> None:
        if r_flat.device != self.device:
            raise ValueError(f"r on {r_flat.device}, hierarchy on {self.device}")
        if r_flat.dtype != torch.float32 or r_flat.numel() != self.shape[0] * self.shape[1]:
            raise ValueError(
                f"expected {self.shape[0] * self.shape[1]} float32 values, got "
                f"{r_flat.numel()} {r_flat.dtype}"
            )

    def __call__(self, r_flat: torch.Tensor) -> torch.Tensor:
        if r_flat.device.type == "cpu":
            return self.plain(r_flat)
        if r_flat.device.type == "cuda":
            return self.launch(r_flat)
        raise ValueError(f"unsupported device {r_flat.device}")


def build_fused_inner_cg(gmg, inner_iters: int, device) -> Optional[FusedInnerCG]:
    """The fused inner solve for `gmg`'s hierarchy on `device`, or None
    out of scope (padded or non-2-D hierarchies)."""
    built = _scalar_hierarchy(gmg)
    if built is None:
        return None
    lv, Bry, Brx, Bpy, Bpx, _ = built
    if not 2 <= len(lv) <= _MAX_LEVELS or any(l.W.shape[0] > _MAX_TAPS for l in lv):
        raise ValueError(
            f"hierarchy beyond the kernel's limits: {len(lv)} levels "
            f"(2 to {_MAX_LEVELS}), taps {[l.W.shape[0] for l in lv]} "
            f"(max {_MAX_TAPS})"
        )
    return FusedInnerCG(lv, (Bry, Brx, Bpy, Bpx), inner_iters, device)
