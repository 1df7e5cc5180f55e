"""Lattice stencil operators: gather-free SpMV for structured meshes (scalar).

On the structured unit_square / unit_cube meshes the scalar P1/P2/P3 dof
set IS a regular lattice — the (p*n+1)^d tensor grid — so the assembled
operator is a position-dependent STENCIL:

    y[p] = sum_o W_o[p] * u[p + o]

with a fixed, small offset set o. The apply becomes |o| shifted
multiply-adds over dense planes: no gathers, no scatters. This module
builds the weight planes from an assembled CSR matrix whose dof
coordinates form a lattice and applies them on lattice-shaped tensors.
The 2-D apply goes through `stencil_kernel.stencil_apply_2d`: the CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors.

Port of the scalar half of pdebench_tpu/solvers/stencil.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sps
import torch
import torch.nn.functional as F

from . import stencil_kernel


@dataclass
class Lattice:
    """Injection of dofs onto an integer lattice.

    Full lattices (structured rectangles/boxes) have n_dof == prod(shape)
    and `perm` a permutation. Masked lattices fill only a subset of
    sites: absent entries of `perm` hold the sentinel n_dof, and `embed`
    pads with a fill value. Absent sites are treated downstream exactly
    like Dirichlet-constrained points.
    """

    shape: Tuple[int, ...]  # (ny, nx) or (nz, ny, nx), row-major last-x
    perm: np.ndarray  # lattice flat site -> dof index (or n_dof sentinel)
    inv: np.ndarray  # dof index -> lattice flat site
    n_dof: int = 0
    masked: bool = False

    def embed(self, v: torch.Tensor, fill) -> torch.Tensor:
        """Dof vector -> flat lattice vector (absent sites = fill)."""
        perm = torch.as_tensor(self.perm, device=v.device)
        if not self.masked:
            return v[perm]
        pad = torch.full((1,), fill, dtype=v.dtype, device=v.device)
        return torch.cat([v, pad])[perm]

    def embed_np(self, v: np.ndarray, fill) -> np.ndarray:
        v = np.asarray(v)
        if not self.masked:
            return v[self.perm]
        return np.concatenate([v, np.asarray([fill], dtype=v.dtype)])[
            self.perm
        ]


def detect_lattice(
    dof_coords: np.ndarray, allow_masked: bool = True
) -> Optional[Lattice]:
    """Map dof coordinates onto an integer lattice.

    With allow_masked, dof sets that injectively fill >= 40% of a lattice
    (masked rectilinear domains) are accepted too, with sentinel-padded
    `perm`.
    """
    x = np.asarray(dof_coords)
    n, dim = x.shape
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    span = hi - lo
    if np.any(span <= 0):
        return None
    ij = np.empty((n, dim), dtype=np.int64)
    sizes = []
    for d in range(dim):
        # infer per-axis count from unique coordinates
        uniq = np.unique(np.round((x[:, d] - lo[d]) / span[d] * (10**9)))
        m = len(uniq)
        sizes.append(m)
        step = span[d] / (m - 1)
        idx = np.round((x[:, d] - lo[d]) / step)
        if not np.allclose(idx * step + lo[d], x[:, d], atol=1e-8 * max(span)):
            return None
        ij[:, d] = idx.astype(np.int64)
    n_lat = int(np.prod(sizes))
    masked = n_lat != n
    if masked and (not allow_masked or n < 0.4 * n_lat or n_lat > 2**31):
        return None
    # flat index: x fastest (row-major with axes reversed: z, y, x)
    flat = np.zeros(n, dtype=np.int64)
    for d in reversed(range(dim)):
        flat = flat * sizes[d] + ij[:, d]
    if len(np.unique(flat)) != n:
        return None
    shape = tuple(int(s) for s in reversed(sizes))  # (…, ny, nx)
    perm = np.full(n_lat, n, dtype=np.int64)
    perm[flat] = np.arange(n)
    return Lattice(shape=shape, perm=perm, inv=flat, n_dof=n, masked=masked)


def _unique_offsets(d: np.ndarray):
    """Unique offset rows via 1-D integer keys (np.unique(axis=0) on
    10^7 rows costs minutes; this is seconds)."""
    B = int(np.abs(d).max()) + 1 if d.size else 1
    key = np.zeros(len(d), dtype=np.int64)
    for k in range(d.shape[1]):
        key = key * (2 * B + 1) + (d[:, k] + B)
    uk, o_idx = np.unique(key, return_inverse=True)
    # decode keys back to offset tuples
    offs = np.empty((len(uk), d.shape[1]), dtype=np.int64)
    rem = uk.copy()
    for k in reversed(range(d.shape[1])):
        offs[:, k] = rem % (2 * B + 1) - B
        rem = rem // (2 * B + 1)
    return offs, o_idx


def apply_stencil(
    W: torch.Tensor, offsets: Sequence[Tuple[int, ...]], pad: int, u: torch.Tensor
) -> torch.Tensor:
    """y[p] = sum_k W[k, p] * u[p + offsets[k]], zero outside the lattice,
    through the fused stencil kernel's wrapper (CUDA kernel on CUDA
    tensors, plain version on CPU tensors). 2-D only so far."""
    if u.dim() != 2:
        raise NotImplementedError("3-D lattice stencils are not ported yet")
    up = F.pad(u, (pad, pad, pad, pad))
    return stencil_kernel.stencil_apply_2d(up, W, offsets, pad)


class LatticeOperator:
    """Stencil form of a lattice-structured sparse matrix."""

    def __init__(
        self,
        A: sps.spmatrix,
        lattice: Lattice,
        device,
        dtype=torch.float64,
    ):
        shape = lattice.shape
        coo = A.tocoo()
        # lattice site of each entry's row/col dof
        lr = lattice.inv[coo.row]
        lc = lattice.inv[coo.col]

        # offsets per entry in lattice coordinates
        def unflatten(f):
            out = []
            rem = f
            for s in reversed(shape):  # x first
                out.append(rem % s)
                rem = rem // s
            return np.stack(list(reversed(out)), axis=1)  # (…, y, x)

        d = unflatten(lc) - unflatten(lr)  # (nnz, dim)
        offs, o_idx = _unique_offsets(d)
        # bincount accumulation (np.add.at is ~100x slower at 10^7 nnz)
        n_lat = int(np.prod(shape))
        W = np.bincount(
            o_idx * n_lat + lr, weights=coo.data, minlength=len(offs) * n_lat
        ).reshape((len(offs),) + shape)
        self._init(W, [tuple(int(v) for v in o) for o in offs], lattice, device, dtype)

    @classmethod
    def from_numpy(
        cls, W: np.ndarray, offsets, lattice: Lattice, device, dtype=torch.float64
    ) -> "LatticeOperator":
        """Operator from given float64 weight planes (K,)+shape, e.g. the
        reference package's, so both packages run on the same stencil."""
        op = cls.__new__(cls)
        op._init(
            np.asarray(W, dtype=np.float64),
            [tuple(int(v) for v in o) for o in offsets],
            lattice, device, dtype,
        )
        return op

    def _init(self, W: np.ndarray, offsets, lattice: Lattice, device, dtype):
        self.lattice = lattice
        self.offsets = offsets
        self.pad = int(max(abs(o) for off in offsets for o in off)) if offsets else 0
        self.W = torch.tensor(W, device=device).to(dtype)
        self.device = self.W.device
        # keep the f64 weights: mixed-precision refinement needs an EXACT
        # f64 outer operator
        self.W_f64 = torch.tensor(W, dtype=torch.float64, device=self.device)
        self.dtype = dtype
        self.inv_j = torch.as_tensor(lattice.inv, device=self.device)
        self.shape = lattice.shape
        self.grid_shape = lattice.shape
        self.gmg = None

    @property
    def embedding(self) -> Lattice:
        """The dof <-> flat-grid-vector injection for this operator."""
        return self.lattice

    def apply_grid(self, u: torch.Tensor) -> torch.Tensor:
        """Stencil apply on the lattice-shaped array."""
        return self.apply_grid_w(self.W, u)

    def apply_grid_w(self, W: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Stencil apply with explicit weights (e.g. W_f64)."""
        return apply_stencil(W, self.offsets, self.pad, u)

    def __call__(self, u_flat: torch.Tensor) -> torch.Tensor:
        """Apply on a flat dof vector (any dof ordering handled)."""
        u_lat = self.lattice.embed(u_flat.to(self.W.dtype), 0).reshape(self.shape)
        y = self.apply_grid(u_lat).reshape(-1)
        return y[self.inv_j].to(u_flat.dtype)


def constrain_stencil_weights(
    W: np.ndarray, offsets, mask_lat: np.ndarray
) -> np.ndarray:
    """Dirichlet-constrain scalar stencil weights directly (no CSR round
    trip): zero rows at masked points, zero taps whose source is masked,
    unit diagonal at masked points. W: (K, *shape); mask_lat: node mask
    in lattice shape."""
    W = np.array(W, dtype=np.float64, copy=True)
    shape = mask_lat.shape
    pad = int(max(abs(o) for off in offsets for o in off)) if offsets else 0
    mp = np.pad(mask_lat, pad, constant_values=True)
    diag_k = None
    for k, off in enumerate(offsets):
        if all(o == 0 for o in off):
            diag_k = k
        # source point p+off masked -> zero the tap
        sl = tuple(slice(pad + o, pad + o + s) for o, s in zip(off, shape))
        W[k][mask_lat] = 0.0
        W[k][mp[sl]] = 0.0
    if diag_k is not None:
        W[diag_k][mask_lat] = 1.0
    return W


def lattice_operator_from_local(
    A_local: np.ndarray,
    dofmap: np.ndarray,
    ndof: int,
    dof_coords: np.ndarray,
    device,
    dtype=torch.float64,
) -> Optional[LatticeOperator]:
    """Build a LatticeOperator from host cell-local matrices, or None if
    the dofs don't form a lattice (complex domains, mixed spaces)."""
    lat = detect_lattice(dof_coords)
    if lat is None:
        return None
    nl = A_local.shape[1]
    dm = np.asarray(dofmap, dtype=np.int64)
    rows = np.repeat(dm, nl, axis=1).reshape(-1)
    cols = np.tile(dm, (1, nl)).reshape(-1)
    A = sps.coo_matrix(
        (np.asarray(A_local).reshape(-1), (rows, cols)), shape=(ndof, ndof)
    ).tocsr()
    op = LatticeOperator(A, lat, device, dtype=dtype)
    # periodic identifications create wrap-around offsets (pad ~ n); the
    # stencil/GMG machinery assumes compact stencils
    if op.pad > 8:
        return None
    return op
