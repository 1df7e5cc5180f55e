"""Multi-tap stencil apply on 2-D and 3-D lattices, scalar and d x d block:
the CUDA kernel's wrapper and its plain versions.

    scalar: y[s]    = sum_k W[k, s] * u[s + offsets[k]]
    block:  y[s, a] = sum_b sum_k W[k, s, a, b] * u[s + offsets[k], b]

zero outside the lattice, with u and y of the lattice's own shape ((ny,
nx) or (nz, ny, nx), then (d,) for a block stencil) and W of (K,) + that
shape (+ (d, d)). A `StencilPlan` is built once per operator or level: it
checks the offsets and packs the taps for csrc/stencil_apply.cu. Calling
it checks shapes, device and dtype; on a CPU tensor it runs the plain
PyTorch version, on a CUDA tensor it launches the kernel (float32 or
float64; block stencils with d = 2 or 3) and counts the launch in
`LAUNCHES`: one launch per apply, scalar or block.

`stencil_apply_2d` keeps the signature of the Pallas kernel it replaces
(pdebench_tpu/solvers/stencil_pallas.py::stencil_apply_2d), a zero-padded
u_pad, and applies a plan to its interior. The reference applies 3-D and
block stencils in XLA (pdebench_tpu/solvers/stencil.py:744-753, :857-869,
:658-669), not in a Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build

# kernel launches in this process (the plain versions are not counted)
LAUNCHES = 0

MAX_TAPS = 128  # kMaxTaps of csrc/stencil_apply.cu; a 3-D P2 stencil has 65
# int32 words of the kernel's Plan: n, nz, ny, nx, K, pz, py, px, the
# flat offsets, then (dz, dy, dx) as MAX_TAPS bytes each
_PLAN_HEAD = 8
_PLAN_INTS = _PLAN_HEAD + MAX_TAPS + 3 * MAX_TAPS // 4
# the kernel of each kind of plan, by dtype: the flat scalar kernel (2-D,
# and 3-D taps reaching more than TILE_REACH), the tiled one (3-D taps
# reaching at most TILE_REACH), the d = 2 and the d = 3 block ones
TILE_REACH = 2  # kReach of csrc/stencil_apply.cu
_ENTRY = {
    ("flat", torch.float32): "stencil_apply_f32",
    ("flat", torch.float64): "stencil_apply_f64",
    ("tiled", torch.float32): "stencil_apply_3d_f32",
    ("tiled", torch.float64): "stencil_apply_3d_f64",
    ("block", torch.float32): "stencil_apply_block2_f32",
    ("block", torch.float64): "stencil_apply_block2_f64",
    ("block3", torch.float32): "stencil_apply_block3_f32",
    ("block3", torch.float64): "stencil_apply_block3_f64",
}


def _shifted(up: torch.Tensor, off, pad: int, shape) -> torch.Tensor:
    return up[tuple(slice(pad + o, pad + o + s) for o, s in zip(off, shape))]


def stencil_plain(
    u: torch.Tensor, W: torch.Tensor, offsets: Sequence[Tuple[int, ...]], pad: int
) -> torch.Tensor:
    """Plain PyTorch version of the scalar apply on the unpadded field u:
    one shifted multiply-add per tap, in order k = 0..K-1."""
    up = F.pad(u, (pad,) * (2 * u.dim()))
    out = torch.zeros(u.shape, dtype=W.dtype, device=W.device)
    for k, off in enumerate(offsets):
        out = out + W[k] * _shifted(up, off, pad, u.shape)
    return out


def block_stencil_plain(
    u: torch.Tensor, W: torch.Tensor, offsets: Sequence[Tuple[int, ...]], pad: int
) -> torch.Tensor:
    """Plain PyTorch version of the block apply on the unpadded field u
    (shape + (d,)): for each b the taps summed in order k = 0..K-1, then
    the d sums added in order b = 0..d-1, the kernel's order."""
    shape, d = u.shape[:-1], u.shape[-1]
    up = F.pad(u.movedim(-1, 0), (pad,) * (2 * len(shape)))  # (d, padded...)
    out = None
    for b in range(d):
        acc = torch.zeros(u.shape, dtype=W.dtype, device=W.device)
        for k, off in enumerate(offsets):
            acc = acc + W[k][..., b] * _shifted(up[b], off, pad, shape)[..., None]
        out = acc if out is None else out + acc
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil_apply")
    vp = ctypes.c_void_p
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp]  # u, W, y, plan (host), stream
        fn.restype = ctypes.c_int
    lib.stencil_plan_bytes.argtypes = []
    lib.stencil_plan_bytes.restype = ctypes.c_int
    if lib.stencil_plan_bytes() != 4 * _PLAN_INTS:
        raise RuntimeError("stencil_apply.cu's Plan does not match StencilPlan's buffer")
    return lib


class StencilPlan:
    """One lattice stencil, checked and packed once: `plan(W, u)` applies
    it with weights W (K,) + shape (scalar, ncomp None) or (K,) + shape +
    (d, d) (block, ncomp d) to u of the lattice's shape (+ (d,)).

    The constructor checks the offsets (dimension, within `pad`, at most
    MAX_TAPS of them) and packs the kernel's Plan; a call checks W's and
    u's shapes, device and dtype, and then runs the plain version (CPU
    tensors) or allocates y and launches the kernel once (CUDA tensors).
    """

    def __init__(self, shape, offsets, pad: int, ncomp: Optional[int] = None):
        shape = tuple(int(s) for s in shape)
        offsets = [tuple(int(v) for v in o) for o in offsets]
        dim, K = len(shape), len(offsets)
        if dim not in (2, 3) or min(shape) < 1:
            raise ValueError(f"expected a 2-D or 3-D lattice shape, got {shape}")
        if any(len(o) != dim for o in offsets):
            raise ValueError(f"need one {dim}-D offset per tap, got {offsets}")
        if not 0 <= pad <= 127 or any(abs(v) > pad for o in offsets for v in o):
            raise ValueError(f"every offset must lie within pad {pad} (at most 127)")
        if K > MAX_TAPS:
            raise ValueError(f"the kernel takes at most {MAX_TAPS} taps, got {K}")
        if ncomp is not None and ncomp < 1:
            raise ValueError(f"a block stencil needs ncomp >= 1, got {ncomp}")
        self.shape, self.offsets, self.pad, self.ncomp = shape, offsets, int(pad), ncomp
        block = () if ncomp is None else (ncomp,)
        self.u_shape = shape + block
        self.w_shape = (K,) + shape + block * 2
        self._plain = stencil_plain if ncomp is None else block_stencil_plain
        # the kernel's Plan (csrc/stencil_apply.cu)
        nz, ny, nx = (1,) * (3 - dim) + shape
        o3 = np.zeros((K, 3), dtype=np.int64)
        if K:
            o3[:, 3 - dim:] = offsets
        reach = np.abs(o3).max(axis=0) if K else np.zeros(3, np.int64)
        buf = np.zeros(_PLAN_INTS, dtype=np.int32)
        buf[:_PLAN_HEAD] = [nz * ny * nx, nz, ny, nx, K, *reach]
        buf[_PLAN_HEAD:_PLAN_HEAD + K] = (o3[:, 0] * ny + o3[:, 1]) * nx + o3[:, 2]
        taps = buf[_PLAN_HEAD + MAX_TAPS:].view(np.int8).reshape(3, MAX_TAPS)
        taps[:, :K] = o3.T
        self._buf = buf  # owned: the launch reads it through _plan_ptr
        self._plan_ptr = buf.ctypes.data
        self._kind = (
            "block" if ncomp == 2
            else "block3" if ncomp == 3
            else "tiled" if ncomp is None and dim == 3 and max(reach) <= TILE_REACH
            else "flat"
        )
        # what the kernels do not take; raised at the first CUDA call
        self._refused = (
            f"the block kernels take d = 2 or 3, not {ncomp}" if ncomp not in (None, 2, 3) else None
        )

    def __call__(self, W: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        if W.shape != self.w_shape or u.shape != self.u_shape:
            raise ValueError(
                f"expected W {self.w_shape} and u {self.u_shape}, got "
                f"{tuple(W.shape)} and {tuple(u.shape)}"
            )
        if W.dtype != u.dtype or W.device != u.device:
            raise ValueError("W and u must share device and dtype")
        if W.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the stencil apply takes float32 or float64, not {W.dtype}")
        if W.device.type == "cpu":
            return self._plain(u, W, self.offsets, self.pad)
        if W.device.type != "cuda":
            raise ValueError(f"unsupported device {W.device}")
        return self._launch(W, u)

    def _launch(self, W: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        global LAUNCHES
        if self._refused:
            raise ValueError(self._refused)
        W, u = W.contiguous(), u.contiguous()
        y = torch.empty(self.u_shape, dtype=W.dtype, device=W.device)
        ptrs = (u.data_ptr(), W.data_ptr(), y.data_ptr())
        if self.ncomp == 2 and (ptrs[0] | ptrs[1]) % 16:
            raise ValueError("the d = 2 block kernel needs W and u aligned to 16 bytes")
        lib = _lib()
        code = getattr(lib, _ENTRY[self._kind, W.dtype])(
            *ptrs, self._plan_ptr, torch._C._cuda_getCurrentRawStream(W.device.index)
        )
        if code:
            _build.check(lib, code, "stencil_apply")
        LAUNCHES += 1
        return y


def stencil_apply_2d(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, int]],
    pad: int,
) -> torch.Tensor:
    """The scalar apply with the Pallas kernel's signature: u_pad (ny + 2
    pad, nx + 2 pad) zero-padded, W (K, ny, nx); returns (ny, nx). The
    plan is applied to u_pad's interior (a copy: this is the comparison
    path, not the solvers')."""
    if u_pad.dim() != 2 or W.dim() != 3:
        raise ValueError(f"expected a 2-D u_pad and W (K, ny, nx), got {tuple(u_pad.shape)}, {tuple(W.shape)}")
    ny, nx = W.shape[1:]
    if tuple(u_pad.shape) != (ny + 2 * pad, nx + 2 * pad):
        raise ValueError(f"u_pad {tuple(u_pad.shape)} does not match W {tuple(W.shape)} with pad {pad}")
    plan = StencilPlan((ny, nx), offsets, pad)
    return plan(W, u_pad[pad:pad + ny, pad:pad + nx].contiguous())
