"""Fused GMG kernels of the refinement's inner solve: one CUDA launch each.

The mixed-precision refinement's inner step (krylov.refined_solve) runs
multigrid V-cycles on a 2-D or 3-D stencil hierarchy. Each builder here
wraps one hand-written kernel (one launch of one thread-block cluster
whose hierarchy stays in L2) for CUDA tensors, and its plain PyTorch
version for CPU tensors; each holds the math of the Pallas kernel it
replaces (pdebench_tpu/solvers/gmg_fused.py):

  build_fused_inner_cg     mode "cg": `inner_iters` GMG-PCG steps, the
                           whole SPD inner solve (csrc/gmg_fused_cg.cu)
  build_fused_richardson   mode "richardson" of the same kernel: a chain
                           of V-cycles z += V(r - A0 z), linear in r, the
                           GMRES inner's preconditioner
  build_fused_inner_gmres  one m-step left-preconditioned Arnoldi cycle
                           with a per-call operator stencil
                           (csrc/gmg_fused_gmres.cu)
  build_fused_block_inner_cg
                           the block (d = 2, elasticity) GMG-PCG inner
                           solve, and its Richardson mode
                           (csrc/gmg_fused_block_cg.cu)
  build_fused_dyn_block_vcycle
                           a chain of block V-cycles on a hierarchy whose
                           weights are the call's (rebuilt at every
                           Navier-Stokes Newton step, gmg_dyn), the
                           saddle preconditioner's velocity solve
                           (csrc/gmg_fused_dyn_block.cu)

Shared math: stencil taps read zero outside each level; restriction /
prolongation are the truncated [1/4, 1/2, 1/4] band per axis and its
bi- or trilinear transpose (banded matmuls in the plain versions, direct
3x3 or 3x3x3 stencils in the kernels); the coarsest solve is an extra
level probed one below the GMG's last, smoothed by COARSE_SWEEPS
damped-Jacobi sweeps (a slightly weaker coarse solve than
LatticeGMG.precond's dense inverse).

Block hierarchies apply 2 x 2 tap blocks over two component planes,
smooth with the 2 x 2 point-block inverse diagonal, transfer each
component with the scalar bands and sweep the probed level with damped
block-Jacobi. The dynamic-weight block chain sweeps the spec's own last
level (no probed one) and its plain version is gmg_dyn's V-cycle chain.

The numpy hierarchy builders are copied from the reference, without its
(8, 128) TPU tile padding; 3-D levels keep their (nz, ny, nx) layout,
where the reference flattens them into slab-packed planes (`_Level3`)
for the TPU's 2-D rolls and banded matmuls. Scope: lattices whose
hierarchy halves at every level (not `padded`): scalar 2-D or 3-D, or
2-D d = 2 blocks; float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .krylov import lstsq_hessenberg
from .stencil_kernel import stencil_plain

COARSE_SWEEPS = 10
# the Arnoldi cycle's preconditioner: chained V-cycles per step
PRECOND_CYCLES = 2
# happy-breakdown freeze of the Arnoldi cycle: hn <= FREEZE * ||u||
FREEZE = 1e-5
EPS = 1e-30
_MODES = {"cg": 0, "richardson": 1}  # kModeCG, kModeRichardson

# kernel launches in this process, one count per kernel (the plain
# versions are not counted): gmg_fused_cg in mode cg, in mode richardson,
# gmg_fused_gmres, gmg_fused_block_cg in its two modes, and
# gmg_fused_dyn_block
LAUNCHES = 0
LAUNCHES_RICHARDSON = 0
LAUNCHES_GMRES = 0
LAUNCHES_BLOCK = 0
LAUNCHES_BLOCK_RICHARDSON = 0
LAUNCHES_DYN_BLOCK = 0

# limits of csrc/gmg_vcycle.cuh (kMaxLevels, kMaxTaps): a 3-D P2 fine
# level has 65 taps
_MAX_LEVELS = 8
_MAX_TAPS = 128


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
    """A scalar level as the fused inner solve takes it, unpadded: float32
    weight planes (K,) + shape and omega * inverse diagonal of `shape`,
    (ny, nx) or (nz, ny, nx) (the port's counterpart of the reference's
    _Level and _Level3; a 2-D level has nz = 1)."""

    def __init__(self, W, offsets, pad, shape, diag_inv, omega):
        self.shape = tuple(int(s) for s in shape)
        self.ny, self.nx = self.shape[-2:]
        self.nz = self.shape[0] if len(self.shape) == 3 else 1
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
    """Scalar 2-D or 3-D hierarchy for the fused inner solve: the GMG's
    levels, an extra probed coarsest level (smoothed on its stencil
    instead of a dense inverse), and the per-level-pair transfer bands.
    Returns (lv, Bry, Brx, Bpy, Bpx, Brz, Bpz) (the z bands empty in
    2-D), or None for padded or block hierarchies."""
    levels = getattr(gmg, "levels", None)
    if getattr(gmg, "padded", False):
        # identity-padded restriction shapes (even mid-hierarchy axes)
        # break the pure-halving transfer layout assumed here
        return None
    if not levels or len(levels[0].shape) not in (2, 3) or getattr(gmg, "d", 1) != 1:
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
    return (lv,) + _bands(lv)


def _bands(lv):
    """The transfer bands of each level pair, one restriction and one
    prolongation band per axis: (Bry, Brx, Bpy, Bpx, Brz, Bpz), the z
    lists empty for 2-D levels. Applied to a (nz, ny, nx) level they
    compute what the reference's kron(Bz, By) row band and Bx column band
    compute on its slab-packed planes (gmg_fused.py:242-265)."""
    Bry, Brx, Bpy, Bpx, Brz, Bpz = [], [], [], [], [], []
    for f in lv[:-1]:
        Bry.append(_restrict_band(f.ny).astype(np.float32))
        Brx.append(_restrict_band(f.nx).astype(np.float32))
        Bpy.append(_prolong_band(f.ny).astype(np.float32))
        Bpx.append(_prolong_band(f.nx).astype(np.float32))
        if len(f.shape) == 3:
            Brz.append(_restrict_band(f.nz).astype(np.float32))
            Bpz.append(_prolong_band(f.nz).astype(np.float32))
    return Bry, Brx, Bpy, Bpx, Brz, Bpz


class _BlockLevel:
    """A 2-D block level as the fused inner solve takes it: float32
    weight planes (K, d, d, ny, nx), W[k, a, b] the (a <- b) plane, and
    omega * the point-block inverse diagonal (d, d, ny, nx), unpadded."""

    def __init__(self, W, offsets, pad, shape, diag_inv, omega):
        ny, nx = shape
        self.shape = (ny, nx)
        self.nz, self.ny, self.nx = 1, ny, nx
        self.pad = pad
        self.offsets = offsets
        Wn = np.asarray(W, np.float32)  # (K, ny, nx, d, d)
        self.W = np.ascontiguousarray(np.moveaxis(Wn, (3, 4), (1, 2)))
        Dn = omega * np.asarray(diag_inv, np.float32)  # (ny, nx, d, d)
        self.dinv = np.ascontiguousarray(np.moveaxis(Dn, (2, 3), (0, 1)))


def _probe_extra_coarse_block(last, d):
    """Re-probe one block level below the GMG's last, numpy-only: the
    block stencil, its point-block inverse diagonal and the damping from
    8 power steps (gmg._block_level_np). Returns (W, offsets, pad, shape,
    diag_inv, omega) or None when the last level isn't halvable."""
    from .gmg import _block_level_np, _coarsen_block_stencil

    if not all((s - 1) % 2 == 0 and s >= 5 for s in last.shape):
        return None
    Wc, offs_c, shape_c = _coarsen_block_stencil(
        _host(last.W).astype(np.float64),
        [tuple(int(v) for v in o) for o in last.offsets],
        last.shape,
        d,
    )
    Dinv_c, omega = _block_level_np(Wc, offs_c, shape_c, d)
    pad_c = int(max(abs(o) for off in offs_c for o in off))
    return Wc, [tuple(int(v) for v in o) for o in offs_c], pad_c, shape_c, Dinv_c, omega


def _block_hierarchy(gmg):
    """Block 2-D hierarchy for the fused inner solve: the block GMG's
    levels, an extra probed coarsest level (block-Jacobi swept instead of
    a dense inverse), and the per-level-pair transfer bands. Returns (lv,
    Bry, Brx, Bpy, Bpx), or None for padded, non-2-D or d != 2
    hierarchies."""
    levels = getattr(gmg, "levels", None)
    d = getattr(gmg, "d", 0)
    if getattr(gmg, "padded", False):
        return None
    if not levels or len(levels[0].shape) != 2 or d != 2:
        return None
    lv = [
        _BlockLevel(
            _host(l.W), [tuple(int(v) for v in o) for o in l.offsets], l.pad,
            l.shape, _host(l.diag_inv), l.omega,
        )
        for l in levels
    ]
    extra = _probe_extra_coarse_block(levels[-1], d)
    if extra is not None:
        lv.append(_BlockLevel(*extra))
    return (lv,) + _bands(lv)[:4]


@functools.lru_cache(maxsize=None)
def _lib_cg() -> ctypes.CDLL:
    """The library of the scalar CG-and-Richardson kernel (#2 / #3), one
    thread-block cluster per launch."""
    lib = _build.load("gmg_fused_cg")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _bind_cluster(lib, "gmg_fused_cg")
    lib.gmg_fused_cg_lstar.argtypes = [vp]
    lib.gmg_fused_cg_lstar.restype = i
    # out, nlev, ptrs (int64 x 5 per level), dims (int32 x 4 per level),
    # offsets (int32 x 3 per tap), p0, p1, Ap, most levels in one CTA
    lib.gmg_fused_cg_pack.argtypes = [vp, i, vp, vp, vp, ll, ll, ll, i]
    lib.gmg_fused_cg_pack.restype = i
    # desc, r, z, iters, mode, cluster, smem, stream
    lib.gmg_fused_cg_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.gmg_fused_cg_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib_block_cg() -> ctypes.CDLL:
    """The library of the block (d = 2) CG-and-Richardson kernel (#4),
    one thread-block cluster per launch."""
    lib = _build.load("gmg_fused_block_cg")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _bind_cluster(lib, "gmg_fused_block_cg")
    lib.gmg_fused_block_cg_lstar.argtypes = [vp]
    lib.gmg_fused_block_cg_lstar.restype = i
    # out, nlev, ptrs (int64 x 5 per level), dims (int32 x 4 per level),
    # offsets (int32 x 3 per tap), p0, p1, Ap, r1, zp, most levels in one
    # CTA
    lib.gmg_fused_block_cg_pack.argtypes = [vp, i, vp, vp, vp, ll, ll, ll, ll, ll, i]
    lib.gmg_fused_block_cg_pack.restype = i
    # desc, r, z, iters, mode, cluster, smem, stream
    lib.gmg_fused_block_cg_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.gmg_fused_block_cg_launch.restype = i
    return lib


def _bind_cluster(lib, name: str) -> None:
    """Argument types of a cluster kernel's desc_bytes and config entries."""
    getattr(lib, f"{name}_desc_bytes").argtypes = []
    getattr(lib, f"{name}_desc_bytes").restype = ctypes.c_int
    # host descriptor, cluster size out, dynamic shared memory bytes out
    getattr(lib, f"{name}_config").argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
    ]
    getattr(lib, f"{name}_config").restype = ctypes.c_int


def _cluster_config(lib, name: str, desc: np.ndarray, device):
    """(cluster size, dynamic shared memory bytes) of a packed host
    descriptor on `device`; raises if no cluster can be resident."""
    cluster, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = getattr(lib, f"{name}_config")(
            desc.ctypes.data_as(ctypes.c_void_p), ctypes.byref(cluster), ctypes.byref(smem)
        )
    _build.check(lib, code, f"{name}_config")
    return cluster.value, smem.value


@functools.lru_cache(maxsize=None)
def _lib_gmres() -> ctypes.CDLL:
    lib = _build.load("gmg_fused_gmres")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _bind_cluster(lib, "gmg_fused_gmres")
    lib.gmg_fused_gmres_lstar.argtypes = [vp]
    lib.gmg_fused_gmres_lstar.restype = i
    # out, nlev, ptrs, dims, offs, op_K, op_offs, Av, z1
    lib.gmg_fused_gmres_pack.argtypes = [vp, i, vp, vp, vp, i, vp, ll, ll]
    lib.gmg_fused_gmres_pack.restype = i
    # desc, r, W_op, V, Hc, beta, m, cycles, cluster, smem, stream
    lib.gmg_fused_gmres_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.gmg_fused_gmres_launch.restype = i
    return lib


def _vp(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _taps3(offsets) -> np.ndarray:
    """Flat int32 (dz, dy, dx) per tap, as the kernels take taps; a 2-D
    tap (dy, dx) has dz = 0."""
    return np.array([(0,) * (3 - len(o)) + tuple(o) for o in offsets], dtype=np.int32).reshape(-1)


def _apply_taps(W: torch.Tensor, offsets, pad: int, u: torch.Tensor) -> torch.Tensor:
    """The plain stencil apply of a 2-D or 3-D level, zero outside it."""
    return stencil_plain(u, W, offsets, pad)


def _transfer(Bz, By, Bx, u: torch.Tensor) -> torch.Tensor:
    """A transfer band per axis applied to a level vector: By @ (u @ Bx^T)
    on each z-plane, then Bz along z (None on 2-D levels)."""
    out = By @ (u @ Bx.T)
    return out if Bz is None else torch.tensordot(Bz, out, dims=1)


class _FusedHierarchy:
    """The hierarchy of a fused kernel on `device`, with the plain
    PyTorch V-cycle and V-cycle chain that the kernels' plain versions
    share. Calls on one object must not overlap on different streams:
    a kernel's work vectors are allocated once, with the hierarchy.

    The plain versions hold a level vector as component planes: (ny, nx)
    or (nz, ny, nx) for scalar hierarchies, (ncomp, ny, nx) for block
    ones; `_to_planes` and `_from_planes` convert from and to the flat
    lattice vector."""

    ncomp = 1  # components per lattice site

    def __init__(self, lv, bands, device):
        self.shape = lv[0].shape  # (ny, nx) or (nz, ny, nx)
        self.sites = int(np.prod(self.shape))
        self.dims = [(l.nz, l.ny, l.nx) for l in lv]

        def t(a):
            return torch.as_tensor(a, device=device)

        self.W = [t(l.W) for l in lv]
        # the concrete device ("cuda:0" for "cuda"), as tensors report it
        self.device = self.W[0].device
        self.D = [t(l.dinv) for l in lv]
        self.offsets = [[tuple(int(v) for v in o) for o in l.offsets] for l in lv]
        self.pads = [int(l.pad) for l in lv]
        # Bry, Brx, Bpy, Bpx, and for 3-D levels Brz, Bpz
        self.bands = [[t(b) for b in bl] for bl in bands]
        self._cuda = None

    # -- plain PyTorch version ------------------------------------------

    def _to_planes(self, r_flat: torch.Tensor) -> torch.Tensor:
        return r_flat.reshape(self.shape)

    def _from_planes(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(-1)

    def _apply(self, l: int, u: torch.Tensor) -> torch.Tensor:
        return _apply_taps(self.W[l], self.offsets[l], self.pads[l], u)

    def _diag(self, l: int, r: torch.Tensor) -> torch.Tensor:
        """omega D^-1 r, the smoother's step."""
        return self.D[l] * r

    def _vcycle(self, l: int, r: torch.Tensor) -> torch.Tensor:
        x = self._diag(l, r)
        if l == len(self.W) - 1:
            for _ in range(COARSE_SWEEPS - 1):
                x = x + self._diag(l, r - self._apply(l, x))
            return x
        By, Bx, Py, Px = (b[l] for b in self.bands[:4])
        Bz, Pz = (b[l] for b in self.bands[4:]) if len(self.shape) == 3 else (None, None)
        res = r - self._apply(l, x)
        xc = self._vcycle(l + 1, _transfer(Bz, By, Bx, res))
        x = x + _transfer(Pz, Py, Px, xc)
        return x + self._diag(l, r - self._apply(l, x))

    def _chain(self, v: torch.Tensor, cycles: int) -> torch.Tensor:
        """z = V(v), then cycles - 1 times z += V(v - A0 z): linear in v."""
        z = self._vcycle(0, v)
        for _ in range(cycles - 1):
            z = z + self._vcycle(0, v - self._apply(0, z))
        return z

    # -- CUDA side ------------------------------------------------------

    def _level_arrays(self):
        """Work vectors (3, ncomp * n_l) per level and the flat level
        arrays that pack_levels (csrc/gmg_vcycle.cuh) takes: pointers,
        dims (nz, ny, nx, K), taps (dz, dy, dx); a 2-D level has nz = 1
        and dz = 0."""
        work = [
            torch.zeros((3, self.ncomp * nz * ny * nx), dtype=torch.float32, device=self.device)
            for nz, ny, nx in self.dims
        ]
        ptrs = np.array(
            [
                [W.data_ptr(), D.data_ptr()] + [w[j].data_ptr() for j in range(3)]
                for W, D, w in zip(self.W, self.D, work)
            ],
            dtype=np.int64,
        )
        dims = np.array(
            [list(d) + [len(o)] for d, o in zip(self.dims, self.offsets)], dtype=np.int32
        )
        offs = _taps3(o for lvl in self.offsets for o in lvl)
        return work, ptrs, dims, offs

    def _check(self, r_flat: torch.Tensor) -> None:
        if r_flat.device != self.device:
            raise ValueError(f"r on {r_flat.device}, hierarchy on {self.device}")
        n = self.ncomp * self.sites
        if r_flat.dtype != torch.float32 or r_flat.numel() != n:
            raise ValueError(
                f"expected {n} float32 values, got {r_flat.numel()} {r_flat.dtype}"
            )

    def _check_cuda(self) -> None:
        if self.device.type != "cuda":
            raise ValueError(f"the kernel runs on CUDA tensors, not {self.device}")


class FusedInnerCG(_FusedHierarchy):
    """fn(r_lat_flat_f32) -> z_lat_flat_f32, one kernel launch per call.

    mode "cg": `inner_iters` GMG-PCG steps (nonlinear in r: only valid
    as a whole inner solve under iterative refinement). mode
    "richardson": a chain of `inner_iters` V-cycles z += V(r - A0 z),
    linear in r, the preconditioner of the GMRES inner. A CPU tensor
    runs `plain` (PyTorch); a CUDA tensor runs `launch` (the kernel).
    `cta_levels` sets how many coarse levels the kernel's CTA 0 solves in
    shared memory, as many as fit up to it (0: the kernel's default, the
    coarsest alone in 2-D and as many as fit in 3-D; 1: the coarsest
    alone); the result is the same bit for bit.
    """

    _kernel = "gmg_fused_cg"

    def __init__(self, lv, bands, inner_iters: int, device, mode: str = "cg",
                 cta_levels: int = 0):
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "richardson" and inner_iters < 1:
            raise ValueError("a Richardson chain takes at least one V-cycle")
        super().__init__(lv, bands, device)
        self.inner_iters = int(inner_iters)
        self.mode = mode
        self.cta_levels = int(cta_levels)

    def plain(self, r_flat: torch.Tensor) -> torch.Tensor:
        """The inner solve in PyTorch ops, on the hierarchy's device."""
        self._check(r_flat)
        r0 = self._to_planes(r_flat)
        if self.mode == "richardson":
            return self._from_planes(self._chain(r0, self.inner_iters))
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
        return self._from_planes(z)

    def _entry(self, lib, suffix: str):
        return getattr(lib, f"{self._kernel}_{suffix}")

    def _setup_cuda(self):
        lib = _lib_cg()
        work, ptrs, dims, offs = self._level_arrays()
        vecs = torch.zeros((3, self.sites), dtype=torch.float32, device=self.device)  # p0, p1, Ap
        desc = np.zeros(lib.gmg_fused_cg_desc_bytes(), dtype=np.uint8)
        code = lib.gmg_fused_cg_pack(
            desc.ctypes.data_as(ctypes.c_void_p), len(self.W),
            ptrs.ctypes.data_as(ctypes.c_void_p),
            dims.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p),
            vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(), self.cta_levels,
        )
        _build.check(lib, code, "gmg_fused_cg_pack")
        cluster, smem = _cluster_config(lib, "gmg_fused_cg", desc, self.device)
        # the buffers live as long as this object: the descriptor holds
        # their addresses
        self._cuda = dict(
            lib=lib, work=work, vecs=vecs, cluster=cluster, smem=smem,
            lstar=lib.gmg_fused_cg_lstar(desc.ctypes.data_as(ctypes.c_void_p)),
            desc=torch.from_numpy(desc).to(self.device),
        )

    def _count(self) -> None:
        global LAUNCHES, LAUNCHES_RICHARDSON
        if self.mode == "richardson":
            LAUNCHES_RICHARDSON += 1
        else:
            LAUNCHES += 1

    def launch(self, r_flat: torch.Tensor) -> torch.Tensor:
        """The inner solve as one kernel launch."""
        self._check(r_flat)
        self._check_cuda()
        if self._cuda is None:
            self._setup_cuda()
        c = self._cuda
        # the kernels read r and write z in the lattice's flat layout
        r = r_flat.contiguous()
        z = torch.empty_like(r)
        code = self._entry(c["lib"], "launch")(
            _vp(c["desc"]), _vp(r), _vp(z), self.inner_iters, _MODES[self.mode],
            c["cluster"], c["smem"], _build.current_stream(self.device),
        )
        _build.check(c["lib"], code, f"{self._kernel}_launch")
        self._count()
        return z

    def __call__(self, r_flat: torch.Tensor) -> torch.Tensor:
        if r_flat.device.type == "cpu":
            return self.plain(r_flat)
        if r_flat.device.type == "cuda":
            return self.launch(r_flat)
        raise ValueError(f"unsupported device {r_flat.device}")


class FusedBlockInnerCG(FusedInnerCG):
    """The block (d = 2) inner solve: fn(r_lat_flat_f32) ->
    z_lat_flat_f32 on the block lattice's flat layout (site-major,
    component-minor: stencil.BlockLatticeOperator's embedding), one
    thread-block-cluster launch of csrc/gmg_fused_block_cg.cu per call,
    which reads r and writes z in that layout. Modes and `cta_levels` as
    FusedInnerCG's, the default (0) every coarse level that fits CTA 0's
    shared memory."""

    ncomp = 2
    _kernel = "gmg_fused_block_cg"

    def _setup_cuda(self):
        lib = _lib_block_cg()
        work, ptrs, dims, offs = self._level_arrays()
        # p0, p1, Ap, level 0's second right-hand side, the chain's running
        # sum: planar (2, ny, nx) each
        vecs = torch.zeros((5, self.ncomp * self.sites), dtype=torch.float32, device=self.device)
        desc = np.zeros(lib.gmg_fused_block_cg_desc_bytes(), dtype=np.uint8)
        code = lib.gmg_fused_block_cg_pack(
            desc.ctypes.data_as(ctypes.c_void_p), len(self.W),
            ptrs.ctypes.data_as(ctypes.c_void_p),
            dims.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p),
            *(v.data_ptr() for v in vecs), self.cta_levels,
        )
        _build.check(lib, code, "gmg_fused_block_cg_pack")
        cluster, smem = _cluster_config(lib, "gmg_fused_block_cg", desc, self.device)
        # the buffers live as long as this object: the descriptor holds
        # their addresses
        self._cuda = dict(
            lib=lib, work=work, vecs=vecs, cluster=cluster, smem=smem,
            lstar=lib.gmg_fused_block_cg_lstar(desc.ctypes.data_as(ctypes.c_void_p)),
            desc=torch.from_numpy(desc).to(self.device),
        )

    def _to_planes(self, r_flat: torch.Tensor) -> torch.Tensor:
        return r_flat.reshape(self.shape + (2,)).permute(2, 0, 1)

    def _from_planes(self, z: torch.Tensor) -> torch.Tensor:
        return z.permute(1, 2, 0).reshape(-1)

    def _apply(self, l: int, u: torch.Tensor) -> torch.Tensor:
        """Block taps on component planes: out_a = sum_k sum_b W[k, a, b]
        shift(u_b), zero outside the level, summed as the Pallas kernel."""
        p = self.pads[l]
        W = self.W[l]
        ny, nx = u.shape[-2:]
        up = F.pad(u, (p, p, p, p))
        o0 = o1 = None
        for k, (dy, dx) in enumerate(self.offsets[l]):
            t0 = up[0, p + dy : p + dy + ny, p + dx : p + dx + nx]
            t1 = up[1, p + dy : p + dy + ny, p + dx : p + dx + nx]
            c0 = W[k, 0, 0] * t0 + W[k, 0, 1] * t1
            c1 = W[k, 1, 0] * t0 + W[k, 1, 1] * t1
            o0 = c0 if o0 is None else o0 + c0
            o1 = c1 if o1 is None else o1 + c1
        return torch.stack([o0, o1])

    def _diag(self, l: int, r: torch.Tensor) -> torch.Tensor:
        D = self.D[l]  # (2, 2, ny, nx), omega folded in
        return torch.stack([D[0, 0] * r[0] + D[0, 1] * r[1], D[1, 0] * r[0] + D[1, 1] * r[1]])

    def _count(self) -> None:
        global LAUNCHES_BLOCK, LAUNCHES_BLOCK_RICHARDSON
        if self.mode == "richardson":
            LAUNCHES_BLOCK_RICHARDSON += 1
        else:
            LAUNCHES_BLOCK += 1


class FusedInnerGMRES(_FusedHierarchy):
    """fn(r_lat_flat_f32, W_op) -> z_lat_flat_f32: one m-step
    left-preconditioned Arnoldi cycle, the preconditioner a chain of
    PRECOND_CYCLES V-cycles on the hierarchy, the operator the stencil
    W_op (K_op,) + level-0 shape with the taps `op_offsets` given at build
    (for a surrogate hierarchy the TRUE constrained system, never level 0).

    `raw` returns the cycle's basis V (m+1, n), Hessenberg matrix H
    (m+1, m) and beta: `plain_raw` (PyTorch) for a CPU tensor, one kernel
    launch (`launch_raw`) for a CUDA tensor. The call then solves the
    least squares and forms z = sum_i y_i V[i] in PyTorch on the device,
    as the reference's wrapper does.
    """

    def __init__(self, lv: List[_Level], bands, m: int, device, op_offsets):
        if m < 1:
            raise ValueError("an Arnoldi cycle takes at least one step")
        super().__init__(lv, bands, device)
        self.m = int(m)
        self.op_offsets = [tuple(int(v) for v in o) for o in op_offsets]
        self.op_pad = int(max(abs(v) for o in self.op_offsets for v in o))

    def _check_op(self, W_op: torch.Tensor) -> None:
        want = (len(self.op_offsets),) + self.shape
        if W_op.device != self.device or W_op.dtype != torch.float32 or tuple(W_op.shape) != want:
            raise ValueError(
                f"W_op: expected float32 {want} on {self.device}, got "
                f"{W_op.dtype} {tuple(W_op.shape)} on {W_op.device}"
            )

    def plain_raw(self, r_flat: torch.Tensor, W_op: torch.Tensor):
        """(V, H, beta) of the Arnoldi cycle in PyTorch ops: modified
        Gram-Schmidt with the happy-breakdown freeze, as the kernel."""
        self._check(r_flat)
        self._check_op(W_op)
        m, p = self.m, self.op_pad
        f32 = dict(dtype=torch.float32, device=self.device)
        eps = torch.tensor(EPS, **f32)
        V = torch.zeros((m + 1,) + self.shape, **f32)
        H = torch.zeros((m + 1, m), **f32)
        g0 = self._chain(r_flat.reshape(self.shape), PRECOND_CYCLES)
        beta = torch.sqrt(torch.sum(g0 * g0))
        V[0] = g0 / torch.maximum(beta, eps)
        alive = torch.ones((), **f32)
        for j in range(m):
            Av = _apply_taps(W_op, self.op_offsets, p, V[j])
            u = alive * self._chain(Av, PRECOND_CYCLES)
            w = u
            for i in range(j + 1):
                h = torch.sum(V[i] * w)
                w = w - h * V[i]
                H[i, j] = h
            hn = torch.sqrt(torch.sum(w * w))
            unorm = torch.sqrt(torch.sum(u * u))
            alive = alive * (hn > FREEZE * unorm).to(torch.float32)
            H[j + 1, j] = alive * hn
            V[j + 1] = alive * w / torch.maximum(hn, eps)
        return V.reshape(m + 1, -1), H, beta

    def _setup_cuda(self):
        lib = _lib_gmres()
        work, ptrs, dims, offs = self._level_arrays()
        vecs = torch.zeros((2, self.sites), dtype=torch.float32, device=self.device)  # Av, z1
        op_offs = _taps3(self.op_offsets)
        desc = np.zeros(lib.gmg_fused_gmres_desc_bytes(), dtype=np.uint8)
        code = lib.gmg_fused_gmres_pack(
            desc.ctypes.data_as(ctypes.c_void_p), len(self.W),
            ptrs.ctypes.data_as(ctypes.c_void_p),
            dims.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p),
            len(self.op_offsets), op_offs.ctypes.data_as(ctypes.c_void_p),
            vecs[0].data_ptr(), vecs[1].data_ptr(),
        )
        _build.check(lib, code, "gmg_fused_gmres_pack")
        cluster, smem = _cluster_config(lib, "gmg_fused_gmres", desc, self.device)
        self._cuda = dict(
            lib=lib, work=work, vecs=vecs, cluster=cluster, smem=smem,
            lstar=lib.gmg_fused_gmres_lstar(desc.ctypes.data_as(ctypes.c_void_p)),
            desc=torch.from_numpy(desc).to(self.device),
        )

    def launch_raw(self, r_flat: torch.Tensor, W_op: torch.Tensor):
        """(V, H, beta) of the Arnoldi cycle as one cluster launch."""
        global LAUNCHES_GMRES
        self._check(r_flat)
        self._check_op(W_op)
        self._check_cuda()
        if self._cuda is None:
            self._setup_cuda()
        c = self._cuda
        m = self.m
        r, Wc = r_flat.contiguous(), W_op.contiguous()
        V = torch.empty((m + 1, r.numel()), dtype=torch.float32, device=self.device)
        Hc = torch.empty((m, m + 1), dtype=torch.float32, device=self.device)
        beta = torch.empty((), dtype=torch.float32, device=self.device)
        code = c["lib"].gmg_fused_gmres_launch(
            _vp(c["desc"]), _vp(r), _vp(Wc), _vp(V), _vp(Hc), _vp(beta),
            m, PRECOND_CYCLES, c["cluster"], c["smem"], _build.current_stream(self.device),
        )
        _build.check(c["lib"], code, "gmg_fused_gmres_launch")
        LAUNCHES_GMRES += 1
        return V, Hc.T, beta

    def raw(self, r_flat: torch.Tensor, W_op: torch.Tensor):
        if r_flat.device.type == "cpu":
            return self.plain_raw(r_flat, W_op)
        if r_flat.device.type == "cuda":
            return self.launch_raw(r_flat, W_op)
        raise ValueError(f"unsupported device {r_flat.device}")

    def _correction(self, V, H, beta) -> torch.Tensor:
        """z = sum_i y_i V[i], y the cycle's least-squares solution."""
        return lstsq_hessenberg(H, beta) @ V[: self.m]

    def __call__(self, r_flat: torch.Tensor, W_op: torch.Tensor) -> torch.Tensor:
        return self._correction(*self.raw(r_flat, W_op))

    def plain(self, r_flat: torch.Tensor, W_op: torch.Tensor) -> torch.Tensor:
        """The whole inner solve through the plain version."""
        return self._correction(*self.plain_raw(r_flat, W_op))


def _in_scope(gmg, hierarchy=_scalar_hierarchy):
    """The hierarchy the fused kernels take as (levels, bands), or None
    out of scope (padded hierarchies, or the other kind of hierarchy);
    raises beyond the kernels' limits."""
    built = hierarchy(gmg)
    if built is None:
        return None
    lv, bands = built[0], built[1:]
    if not 2 <= len(lv) <= _MAX_LEVELS or any(l.W.shape[0] > _MAX_TAPS for l in lv):
        raise ValueError(
            f"hierarchy beyond the kernel's limits: {len(lv)} levels "
            f"(2 to {_MAX_LEVELS}), taps {[l.W.shape[0] for l in lv]} "
            f"(max {_MAX_TAPS})"
        )
    return lv, bands


def build_fused_inner_cg(
    gmg, inner_iters: int, device, mode: str = "cg", cta_levels: int = 0
) -> Optional[FusedInnerCG]:
    """The fused inner solve for `gmg`'s hierarchy on `device`, or None
    out of scope (padded or block hierarchies)."""
    built = _in_scope(gmg)
    if built is None:
        return None
    return FusedInnerCG(*built, inner_iters, device, mode=mode, cta_levels=cta_levels)


def build_fused_richardson(gmg, n_cycles: int, device) -> Optional[FusedInnerCG]:
    """Fused chain of n V-cycles as one kernel launch: z_{k+1} = z_k +
    V(r - A0 z_k). Linear in r, so it preconditions the non-flexible
    GMRES inner; None out of scope."""
    return build_fused_inner_cg(gmg, n_cycles, device, mode="richardson")


def build_fused_block_inner_cg(
    gmg, inner_iters: int, device, mode: str = "cg", cta_levels: int = 0,
) -> Optional[FusedBlockInnerCG]:
    """The fused block (d = 2) inner solve for a BlockLatticeGMG on
    `device`, mode "cg" or "richardson" as build_fused_inner_cg; None out
    of scope (padded, non-2-D or d != 2 hierarchies). `cta_levels` as
    FusedBlockInnerCG takes it."""
    built = _in_scope(gmg, _block_hierarchy)
    if built is None:
        return None
    return FusedBlockInnerCG(*built, inner_iters, device, mode=mode, cta_levels=cta_levels)


def build_fused_inner_gmres(gmg, m: int, device, op_offsets) -> Optional[FusedInnerGMRES]:
    """The fused m-step Arnoldi cycle for `gmg`'s hierarchy on `device`,
    its operator a per-call stencil with taps `op_offsets`; None out of
    scope (padded or block hierarchies)."""
    built = _in_scope(gmg)
    if built is None:
        return None
    if len(op_offsets) > _MAX_TAPS:
        raise ValueError(f"{len(op_offsets)} operator taps, the kernel takes {_MAX_TAPS}")
    return FusedInnerGMRES(*built, m, device, op_offsets)


# ---------------------------------------------------------------------------
# dynamic-weight block V-cycle chain — per-Newton-step convected hierarchies
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib_dyn() -> ctypes.CDLL:
    lib = _build.load("gmg_fused_dyn_block")
    vp, i = ctypes.c_void_p, ctypes.c_int
    _bind_cluster(lib, "gmg_fused_dyn_block")
    # out, nlev, ptrs (int64 x 5 per level), dims (int32 x 4 per level),
    # offsets (int32 x 3 per tap), zp
    lib.gmg_fused_dyn_block_pack.argtypes = [vp, i, vp, vp, vp, ctypes.c_longlong]
    lib.gmg_fused_dyn_block_pack.restype = i
    # desc, r, z, cycles, cluster, smem, stream
    lib.gmg_fused_dyn_block_launch.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.gmg_fused_dyn_block_launch.restype = i
    return lib


class FusedDynBlockVCycle:
    """fn(r_flat, levels) -> z_flat: z = V(r), then n_cycles - 1 times z +=
    V(r - A0 z), on the block hierarchy levels = spec.build_levels(W0) (a
    gmg_dyn.DynLevels of planar (W, omega Dinv) per level, made at each
    Newton step). r_flat and z_flat are the (ny * nx * 2) block-lattice
    vectors, site-major and component-minor.

    A CPU tensor runs `plain` (gmg_dyn's V-cycle chain in PyTorch); a CUDA
    tensor runs `launch`, one thread-block-cluster launch of
    csrc/gmg_fused_dyn_block.cu. The kernel's level descriptor points at
    the weight set's tensors: it is packed at the first launch on a weight
    set and kept in that set's `cache`, so it lives exactly as long as the
    tensors do. Calls on one object must not overlap on different streams
    (the work vectors are the object's).
    """

    def __init__(self, spec, n_cycles: int, device):
        self.spec = spec
        self.n_cycles = int(n_cycles)
        # the concrete device ("cuda:0" for "cuda"), as tensors report it
        self.device = torch.empty(0, device=device).device
        self.shape = tuple(spec.levels[0].shape)
        self.sites = int(np.prod(self.shape))
        self._cuda = None

    def _check(self, r_flat: torch.Tensor, levels) -> None:
        if r_flat.dtype != torch.float32 or r_flat.numel() != 2 * self.sites:
            raise ValueError(
                f"expected {2 * self.sites} float32 values, got {r_flat.numel()} {r_flat.dtype}"
            )
        if len(levels) != len(self.spec.levels):
            raise ValueError(f"{len(levels)} levels, the spec has {len(self.spec.levels)}")
        for (W, D), sp in zip(levels, self.spec.levels):
            want_w = (len(sp.offsets), 2, 2) + tuple(sp.shape)
            want_d = (2, 2) + tuple(sp.shape)
            for t, want in ((W, want_w), (D, want_d)):
                if (
                    t.device != r_flat.device or t.dtype != torch.float32
                    or tuple(t.shape) != want or not t.is_contiguous()
                ):
                    raise ValueError(
                        f"level weights: expected contiguous float32 {want} on "
                        f"{r_flat.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                    )

    def plain(self, r_flat: torch.Tensor, levels) -> torch.Tensor:
        """The chain in PyTorch ops, on the tensors' device."""
        self._check(r_flat, levels)
        r = r_flat.reshape(self.shape + (2,)).permute(2, 0, 1)
        z = self.spec.chain(levels, r, self.n_cycles)
        return z.permute(1, 2, 0).reshape(-1)

    def _setup_cuda(self):
        lib = _lib_dyn()
        work = [
            torch.zeros((3, 2 * int(np.prod(sp.shape))), dtype=torch.float32, device=self.device)
            for sp in self.spec.levels
        ]
        zp = torch.zeros(2 * self.sites, dtype=torch.float32, device=self.device)
        dims = np.array(
            [[1, *sp.shape, len(sp.offsets)] for sp in self.spec.levels], dtype=np.int32
        )
        offs = _taps3(o for sp in self.spec.levels for o in sp.offsets)
        # cluster and smem: from the first descriptor packed (the same for
        # every weight set of the spec)
        self._cuda = dict(lib=lib, work=work, zp=zp, dims=dims, offs=offs, cluster=None, smem=None)

    def _descriptor(self, levels) -> torch.Tensor:
        """The packed level descriptor of this weight set, on the device."""
        desc_t = levels.cache.get(self)
        if desc_t is None:
            c = self._cuda
            ptrs = np.array(
                [
                    [W.data_ptr(), D.data_ptr()] + [w[j].data_ptr() for j in range(3)]
                    for (W, D), w in zip(levels, c["work"])
                ],
                dtype=np.int64,
            )
            desc = np.zeros(c["lib"].gmg_fused_dyn_block_desc_bytes(), dtype=np.uint8)
            code = c["lib"].gmg_fused_dyn_block_pack(
                desc.ctypes.data_as(ctypes.c_void_p), len(levels),
                ptrs.ctypes.data_as(ctypes.c_void_p),
                c["dims"].ctypes.data_as(ctypes.c_void_p),
                c["offs"].ctypes.data_as(ctypes.c_void_p), c["zp"].data_ptr(),
            )
            _build.check(c["lib"], code, "gmg_fused_dyn_block_pack")
            if c["cluster"] is None:
                c["cluster"], c["smem"] = _cluster_config(
                    c["lib"], "gmg_fused_dyn_block", desc, self.device
                )
            desc_t = torch.from_numpy(desc).to(self.device)
            levels.cache[self] = desc_t
        return desc_t

    def launch(self, r_flat: torch.Tensor, levels) -> torch.Tensor:
        """The chain as one cluster launch of the kernel."""
        global LAUNCHES_DYN_BLOCK
        self._check(r_flat, levels)
        if r_flat.device != self.device or self.device.type != "cuda":
            raise ValueError(f"the kernel runs on CUDA tensors on {self.device}, not on {r_flat.device}")
        if self._cuda is None:
            self._setup_cuda()
        desc = self._descriptor(levels)
        r = r_flat.contiguous()
        z = torch.empty_like(r)
        c = self._cuda
        code = c["lib"].gmg_fused_dyn_block_launch(
            _vp(desc), _vp(r), _vp(z), self.n_cycles, c["cluster"], c["smem"],
            _build.current_stream(self.device),
        )
        _build.check(c["lib"], code, "gmg_fused_dyn_block_launch")
        LAUNCHES_DYN_BLOCK += 1
        return z

    def __call__(self, r_flat: torch.Tensor, levels) -> torch.Tensor:
        if r_flat.device.type == "cpu":
            return self.plain(r_flat, levels)
        if r_flat.device.type == "cuda":
            return self.launch(r_flat, levels)
        raise ValueError(f"unsupported device {r_flat.device}")


def build_fused_dyn_block_vcycle(spec, n_cycles: int, device) -> Optional[FusedDynBlockVCycle]:
    """The fused chain of `n_cycles` block V-cycles for a gmg_dyn spec on
    `device`, its weights call-time inputs; None out of scope (d != 2, not
    2-D, or an identity-padded level), decided from the spec alone; raises
    beyond the kernel's limits."""
    if spec is None or spec.d != 2:
        return None
    if any(sp.pad_to is not None for sp in spec.levels):
        return None
    if any(len(sp.shape) != 2 for sp in spec.levels):
        return None
    if (
        len(spec.levels) > _MAX_LEVELS
        or any(len(sp.offsets) > _MAX_TAPS for sp in spec.levels)
        or spec.coarse_sweeps != COARSE_SWEEPS
        or n_cycles < 1
    ):
        raise ValueError(
            f"spec beyond the kernel's limits: {len(spec.levels)} levels (max "
            f"{_MAX_LEVELS}), taps {[len(sp.offsets) for sp in spec.levels]} (max "
            f"{_MAX_TAPS}), {spec.coarse_sweeps} coarse sweeps ({COARSE_SWEEPS}), "
            f"{n_cycles} cycles"
        )
    return FusedDynBlockVCycle(spec, n_cycles, device)
