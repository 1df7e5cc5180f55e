"""Fused multi-tap stencil apply on 2-D and 3-D lattices: the CUDA
kernel's wrapper and its plain version.

    y[p] = sum_k W[k, p] * u_pad[p + pad + offsets[k]]

`stencil_apply` takes u_pad, the zero-padded field ((ny, nx) or (nz, ny,
nx), each axis padded by `pad`), W the weight planes (K,) + the field's
shape, and one (dy, dx) or (dz, dy, dx) offset per plane. On a CPU tensor
it runs the plain PyTorch version; on a CUDA tensor it launches
csrc/stencil_apply.cu (float32 or float64; a 2-D lattice is the kernel's
nz = 1 case) and counts the launch in `LAUNCHES`. `stencil_apply_2d` keeps
the signature of the Pallas kernel it replaces
(pdebench_tpu/solvers/stencil_pallas.py::stencil_apply_2d). The reference
applies 3-D stencils in XLA (pdebench_tpu/solvers/stencil.py:744-753),
not in a Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build

# kernel launches in this process (the plain version is not counted)
LAUNCHES = 0

_MAX_TAPS = 128  # kMaxTaps of csrc/stencil_apply.cu; a 3-D P2 stencil has 65
_ENTRY = {torch.float32: "stencil_apply_f32", torch.float64: "stencil_apply_f64"}


def stencil_apply_torch(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, ...]],
    pad: int,
) -> torch.Tensor:
    """Plain PyTorch version: one shifted multiply-add per tap, in order."""
    shape = W.shape[1:]
    out = torch.zeros(shape, dtype=W.dtype, device=W.device)
    for k, off in enumerate(offsets):
        out = out + W[k] * u_pad[tuple(slice(pad + o, pad + o + s) for o, s in zip(off, shape))]
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil_apply")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        # u_pad, W, y, nz, ny, nx, pad, pad_z, K, offsets (host int32), stream
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp]
        fn.restype = i
    return lib


def stencil_apply_cuda(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, ...]],
    pad: int,
) -> torch.Tensor:
    """Launch the CUDA kernel; inputs must be checked by the caller."""
    global LAUNCHES
    K, *shape = W.shape
    three_d = len(shape) == 3
    nz, ny, nx = shape if three_d else [1] + shape
    lib = _lib()
    offs = np.zeros((K, 3), dtype=np.int32)  # (dz, dy, dx) per tap, dz = 0 in 2-D
    offs[:, 3 - len(shape):] = offsets
    y = torch.empty(shape, dtype=W.dtype, device=W.device)
    code = getattr(lib, _ENTRY[W.dtype])(
        ctypes.c_void_p(u_pad.data_ptr()),
        ctypes.c_void_p(W.data_ptr()),
        ctypes.c_void_p(y.data_ptr()),
        nz, ny, nx, pad, pad if three_d else 0, K,
        offs.ctypes.data_as(ctypes.c_void_p),
        _build.current_stream(W.device),
    )
    _build.check(lib, code, "stencil_apply")
    LAUNCHES += 1
    return y


def stencil_apply(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, ...]],
    pad: int,
) -> torch.Tensor:
    """Fused stencil apply on a 2-D or 3-D lattice; returns W.shape[1:].
    CPU tensors take the plain version, CUDA tensors the kernel (float32
    or float64 only)."""
    offsets = [tuple(int(v) for v in o) for o in offsets]
    dim = u_pad.dim()
    if dim not in (2, 3) or W.dim() != dim + 1:
        raise ValueError(f"expected W (K,) + u_pad's 2-D or 3-D shape, got {tuple(W.shape)}, {tuple(u_pad.shape)}")
    K, *shape = W.shape
    if list(u_pad.shape) != [s + 2 * pad for s in shape]:
        raise ValueError(f"u_pad {tuple(u_pad.shape)} does not match W {tuple(W.shape)} with pad {pad}")
    if (
        len(offsets) != K
        or any(len(o) != dim for o in offsets)
        or max(map(abs, itertools.chain.from_iterable(offsets)), default=0) > pad
    ):
        raise ValueError(f"need one {dim}-D offset per weight plane, each within pad")
    if u_pad.device != W.device or u_pad.dtype != W.dtype:
        raise ValueError("u_pad and W must share device and dtype")
    if W.device.type == "cpu":
        return stencil_apply_torch(u_pad, W, offsets, pad)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if W.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or float64, not {W.dtype}")
    if K > _MAX_TAPS:
        raise ValueError(f"the kernel takes at most {_MAX_TAPS} taps, got {K}")
    return stencil_apply_cuda(u_pad.contiguous(), W.contiguous(), offsets, pad)


def stencil_apply_2d(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, int]],
    pad: int,
) -> torch.Tensor:
    """`stencil_apply` with the Pallas kernel's signature: u_pad (ny + 2
    pad, nx + 2 pad), W (K, ny, nx); returns (ny, nx)."""
    if u_pad.dim() != 2:
        raise ValueError(f"expected a 2-D u_pad, got {tuple(u_pad.shape)}")
    return stencil_apply(u_pad, W, offsets, pad)
