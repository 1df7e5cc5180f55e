"""Fused multi-tap 2-D stencil apply: CUDA kernel wrapper and plain version.

    y[r, c] = sum_k W[k, r, c] * u_pad[r + pad + dy_k, c + pad + dx_k]

`stencil_apply_2d` keeps the signature of the Pallas kernel it replaces
(pdebench_tpu/solvers/stencil_pallas.py::stencil_apply_2d): u_pad is the
zero-padded field (ny + 2 pad, nx + 2 pad), W the weight planes (K, ny,
nx), offsets one (dy, dx) per plane. On a CPU tensor it runs the plain
PyTorch version; on a CUDA tensor it launches csrc/stencil_apply.cu
(float32 or float64) and counts the launch in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build

# kernel launches in this process (the plain version is not counted)
LAUNCHES = 0

_MAX_TAPS = 64
_ENTRY = {torch.float32: "stencil_apply_2d_f32", torch.float64: "stencil_apply_2d_f64"}


def stencil_apply_2d_torch(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, int]],
    pad: int,
) -> torch.Tensor:
    """Plain PyTorch version: one shifted multiply-add per tap, in order."""
    _, ny, nx = W.shape
    out = torch.zeros((ny, nx), dtype=W.dtype, device=W.device)
    for k, (dy, dx) in enumerate(offsets):
        out = out + W[k] * u_pad[pad + dy : pad + dy + ny, pad + dx : pad + dx + nx]
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil_apply")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        # u_pad, W, y, ny, nx, pad, K, offsets (host int32), stream
        fn.argtypes = [vp, vp, vp, i, i, i, i, vp, vp]
        fn.restype = i
    return lib


def stencil_apply_2d_cuda(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, int]],
    pad: int,
) -> torch.Tensor:
    """Launch the CUDA kernel; inputs must be checked by the caller."""
    global LAUNCHES
    K, ny, nx = W.shape
    lib = _lib()
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1))
    y = torch.empty((ny, nx), dtype=W.dtype, device=W.device)
    code = getattr(lib, _ENTRY[W.dtype])(
        ctypes.c_void_p(u_pad.data_ptr()),
        ctypes.c_void_p(W.data_ptr()),
        ctypes.c_void_p(y.data_ptr()),
        ny, nx, pad, K,
        offs.ctypes.data_as(ctypes.c_void_p),
        _build.current_stream(W.device),
    )
    _build.check(lib, code, "stencil_apply_2d")
    LAUNCHES += 1
    return y


def stencil_apply_2d(
    u_pad: torch.Tensor,
    W: torch.Tensor,
    offsets: Sequence[Tuple[int, int]],
    pad: int,
) -> torch.Tensor:
    """Fused stencil apply; returns (ny, nx). CPU tensors take the plain
    version, CUDA tensors the kernel (float32 or float64 only)."""
    offsets = [tuple(int(v) for v in o) for o in offsets]
    if W.dim() != 3 or u_pad.dim() != 2:
        raise ValueError(f"expected W (K, ny, nx) and u_pad 2-D, got {tuple(W.shape)}, {tuple(u_pad.shape)}")
    K, ny, nx = W.shape
    if tuple(u_pad.shape) != (ny + 2 * pad, nx + 2 * pad):
        raise ValueError(f"u_pad {tuple(u_pad.shape)} does not match W {tuple(W.shape)} with pad {pad}")
    if len(offsets) != K or any(max(abs(dy), abs(dx)) > pad for dy, dx in offsets):
        raise ValueError("need one (dy, dx) per weight plane, each within pad")
    if u_pad.device != W.device or u_pad.dtype != W.dtype:
        raise ValueError("u_pad and W must share device and dtype")
    if W.device.type == "cpu":
        return stencil_apply_2d_torch(u_pad, W, offsets, pad)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if W.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or float64, not {W.dtype}")
    if K > _MAX_TAPS:
        raise ValueError(f"the kernel takes at most {_MAX_TAPS} taps, got {K}")
    return stencil_apply_2d_cuda(u_pad.contiguous(), W.contiguous(), offsets, pad)
