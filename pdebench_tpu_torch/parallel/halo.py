"""Stripe-partitioned stencil solves with a halo exchange of boundary rows.

The lattice's leading axis (y in 2-D, z in 3-D) is split into contiguous
stripes, one a rank (parallel/group.py), so

  - each rank holds its stripe's weight planes and solution rows (dofs are
    partitioned, not replicated);
  - one apply exchanges the `pad` boundary rows with each neighbour
    (Group.exchange_rows) and runs the stencil kernel (#1,
    csrc/stencil_apply.cu) once on the stripe extended by those rows: the
    extended rows' weights are zero and their outputs are cropped, and the
    kernel reads zeros outside the extended stripe, which is what the
    reference's zero padding gives (pdebench_tpu/parallel/halo.py:101-125,
    dynamic_slice taps in XLA);
  - Krylov vectors stay stripe-local end to end; each dot product is a
    local sum and one Group.allreduce_sum (krylov's `reduce`).

Scalar lattices in 2-D and 3-D and block (vector) lattices, and the
Taylor-Hood saddle with the pressure embedded on the velocity lattice.
Dirichlet conditions and the rows that pad the leading axis to a multiple
of the ranks are identity rows through the same constrained-operator
wrappers as the single-device route, so the apply equals the
whole-lattice apply bit for bit.

Port of pdebench_tpu/parallel/halo.py.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.assemble import constrained_operator, constrained_rhs
from ..solvers.krylov import cg, jacobi_preconditioner, minres
from ..solvers.stencil_kernel import StencilPlan
from .group import Group


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (in `dtype`)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


class _Stripes:
    """The row split of a lattice over a group: `rows` owned rows padded
    to `rows_pad` (a multiple of the ranks), `local` rows a rank, and
    `halo` rows exchanged with each neighbour."""

    def __init__(self, rows: int, halo: int, group: Group, what: str):
        self.group = group
        self.halo = int(halo)
        self.rows_orig = int(rows)
        self.rows_pad = -(-self.rows_orig // group.size) * group.size
        self.local = self.rows_pad // group.size
        if self.local < max(self.halo, 1):
            raise ValueError(
                f"stripe of {self.local} rows < {what} halo {self.halo}: "
                f"lattice too small for {group.size} devices"
            )
        self.lo = group.rank * self.local

    def extended(self, W: torch.Tensor) -> torch.Tensor:
        """This rank's rows of weight planes W (K, rows, ...) (its owned,
        unpadded rows), placed in zero planes of the extended stripe's
        length."""
        p = self.halo
        out = W.new_zeros((W.shape[0], self.local + 2 * p) + tuple(W.shape[2:]))
        hi = min(self.lo + self.local, self.rows_orig)
        if hi > self.lo:
            out[:, p:p + hi - self.lo] = W[:, self.lo:hi]
        return out

    def pad_grid(self, u, fill, device, dtype=None) -> torch.Tensor:
        """This rank's stripe of the full grid u (host or device), the
        padding rows holding `fill`."""
        u = _as_tensor(u, device, dtype)
        hi = min(self.lo + self.local, self.rows_orig)
        out = torch.full((self.local,) + tuple(u.shape[1:]), fill, dtype=u.dtype, device=device)
        if hi > self.lo:
            out[: hi - self.lo] = u[self.lo:hi]
        return out

    def extend(self, u_blk: torch.Tensor) -> torch.Tensor:
        """The stripe with its neighbours' `halo` rows above and below
        (zeros past the first and last rank): a fresh contiguous array."""
        p = self.halo
        above, below = self.group.exchange_rows(u_blk[:p], u_blk[-p:])
        return torch.cat([above, u_blk, below])

    def gather(self, x_blk: torch.Tensor) -> torch.Tensor:
        """Every rank's stripe stacked: the full grid, cropped to the
        lattice's rows (the same on every rank)."""
        return self.group.gather_rows(x_blk)[: self.rows_orig]


class HaloStencilOperator:
    """Stencil operator with the leading lattice axis split in stripes.

    W: (K, *shape) scalar or (K, *shape, d, d) block weight planes (numpy
    or tensor, the full lattice: every rank keeps only its stripe's rows,
    extended by `pad` zero rows above and below); offsets: K tuples of
    per-axis taps; ncomp 1 (or None) for a scalar stencil. The row axis is padded to a multiple of the ranks; the
    padded rows must be constrained by the caller (`pad_mask`), which
    makes them identity rows under `fem.assemble.constrained_operator`.
    Grids passed to `__call__` and returned are this rank's stripes.
    """

    def __init__(
        self,
        W,
        offsets: Sequence[Tuple[int, ...]],
        group: Group,
        ncomp: int = 1,
        dtype=torch.float64,
    ):
        offsets = [tuple(int(v) for v in o) for o in offsets]
        dim = len(offsets[0]) if offsets else 1
        shape = tuple(W.shape[1:1 + dim])
        d = int(ncomp or 1)
        if d > 1 and tuple(W.shape[1 + dim:]) != (d, d):
            raise ValueError(f"block weights need trailing ({d}, {d}), got {tuple(W.shape)}")
        pad = int(max(abs(v) for o in offsets for v in o)) if offsets else 0
        self.stripes = _Stripes(shape[0], pad, group, "stencil")
        self.group = group
        self.offsets = offsets
        self.pad = pad
        self.ncomp = d
        self.dim = dim
        self.rows_orig = shape[0]
        self.shape = (self.stripes.rows_pad,) + shape[1:]
        self.grid_shape = self.shape + ((d,) if d > 1 else ())
        self.local_shape = (self.stripes.local,) + self.grid_shape[1:]
        self.W = self.stripes.extended(_as_tensor(W, group.device, dtype))  # (K, local + 2 pad, ...)
        self.W_own = self.W[:, pad:pad + self.stripes.local]
        ext = (self.stripes.local + 2 * pad,) + shape[1:]
        self.plan = StencilPlan(ext, offsets, pad, ncomp=d if d > 1 else None)

    def __call__(self, u_blk: torch.Tensor) -> torch.Tensor:
        """The apply on this rank's stripe: one exchange, one kernel launch
        (CUDA tensors) on the extended stripe, its owned rows."""
        p = self.pad
        y = self.plan(self.W, self.stripes.extend(u_blk.to(self.W.dtype)))
        return y[p:p + self.stripes.local]

    def diagonal(self) -> torch.Tensor:
        """This rank's stripe of the operator's diagonal."""
        k0 = next((k for k, o in enumerate(self.offsets) if all(v == 0 for v in o)), None)
        if k0 is None:
            return torch.ones(self.local_shape, dtype=self.W.dtype, device=self.W.device)
        if self.ncomp > 1:
            return torch.diagonal(self.W_own[k0], dim1=-2, dim2=-1).contiguous()
        return self.W_own[k0].contiguous()

    # -- grid plumbing ---------------------------------------------------

    def pad_grid(self, u, fill=0.0) -> torch.Tensor:
        """This rank's stripe of the full (unpadded) grid u, in the
        operator's dtype; the padded rows hold `fill`."""
        return self.stripes.pad_grid(u, fill, self.W.device, self.W.dtype)

    def pad_mask(self, mask) -> torch.Tensor:
        """This rank's stripe of a constraint mask, True on padded rows."""
        return self.stripes.pad_grid(mask, True, self.W.device, torch.bool)

    def crop_grid(self, u_blk: torch.Tensor) -> torch.Tensor:
        """The full grid from every rank's stripe, cropped to the
        lattice's rows (the same on every rank)."""
        return self.stripes.gather(u_blk)

    @classmethod
    def from_lattice_operator(cls, op, group: Group, use_f64: bool = True) -> "HaloStencilOperator":
        """Build from a LatticeOperator / BlockLatticeOperator."""
        W = op.W_f64 if use_f64 else op.W
        return cls(W, op.offsets, group, ncomp=getattr(op, "ncomp", None), dtype=W.dtype)


def halo_pcg(
    op: HaloStencilOperator,
    b,
    mask,
    g,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10000,
):
    """Jacobi-PCG on stripe-local grids.

    b / mask / g are unpadded full grids (host or device). Dirichlet and
    padded rows become identity rows via the same constrained-operator
    wrappers as the single-device route; each dot product is summed over
    the ranks. Returns (x, info): the full grid, the same on every rank."""
    b_s, g_s, mask_s = op.pad_grid(b), op.pad_grid(g), op.pad_mask(mask)
    A = constrained_operator(op, mask_s)
    rhs = constrained_rhs(op, b_s, mask_s, g_s)
    M = jacobi_preconditioner(torch.where(mask_s, 1.0, op.diagonal()))
    x0 = torch.where(mask_s, g_s, 0.0)
    x, info = cg(A, rhs, x0=x0, M=M, rtol=rtol, atol=atol, maxiter=maxiter,
                 reduce=op.group.allreduce_sum)
    return op.crop_grid(x), info


def sharded_elasticity_step(
    n: int, group: Group, rtol: float = 1e-8
) -> Tuple[Callable, Tuple]:
    """Stripe-partitioned 2-D linear elasticity on an n x n unit square
    (block stencil, halo-exchange apply, Jacobi-PCG). Returns (step,
    example_args); step(b, mask, g) -> (x, iterations, residual)."""
    from ..fem import symbolic
    from ..fem.assemble import GatherSum, cell_batch, local_elasticity, local_vector_load
    from ..fem.mesh import unit_square_mesh
    from ..fem.spaces import FunctionSpace
    from ..solvers.stencil import block_lattice_operator_from_local

    lam, mu = 1.0, 1.0
    fmesh = unit_square_mesh(n)
    space = FunctionSpace(fmesh, 1, ncomp=2)
    cb = cell_batch(fmesh, 1)
    K = np.asarray(local_elasticity(cb, mu, lam))
    lat_op = block_lattice_operator_from_local(
        K, space.dofmap, space.ndof, space.dof_coords, 2, "cpu"
    )
    if lat_op is None:
        raise ValueError("the unit square's nodes form no lattice")
    op = HaloStencilOperator.from_lattice_operator(lat_op, group)

    # MMS body force for u = (sin(pi x) sin(pi y), x y (1-x)(1-y))
    fx = symbolic.lambdify_spatial(f"{2 * mu + lam} * 2*pi**2*sin(pi*x)*sin(pi*y)", 2, "cpu")
    fy = symbolic.lambdify_spatial("x*(1-x) + y*(1-y)", 2, "cpu")
    f_q = torch.stack([fx(cb.qpts), fy(cb.qpts)], dim=-1)
    loads = torch.as_tensor(np.asarray(local_vector_load(cb, f_q)))
    b_dof = GatherSum(space.dofmap, space.ndof, "cpu")(loads).numpy()
    mask_dof = np.zeros(space.ndof, dtype=bool)
    bs = space.boundary_scalar_dofs
    mask_dof[(bs[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)] = True
    g_dof = np.zeros(space.ndof)

    emb = lat_op.embedding  # dof <-> (lattice, comp) flat injection
    gs = lat_op.grid_shape
    args = tuple(
        torch.as_tensor(emb.embed_np(v, fill).reshape(gs), device=group.device)
        for v, fill in ((b_dof, 0.0), (mask_dof, True), (g_dof, 0.0))
    )

    def step(b_arr, mask_arr, g_arr):
        x, info = halo_pcg(op, b_arr, mask_arr, g_arr, rtol=rtol)
        return x, info.iterations, info.residual

    return step, args


def _taps(x_ext: torch.Tensor, offsets, p: int, core: Tuple[int, ...]):
    """Each offset's shifted view of the extended stripe x_ext (leading
    axis already extended by p rows; the other lattice axes zero-padded
    here by p), of the owned `core` lattice shape."""
    dim = len(core)
    xp = F.pad(x_ext, (0, 0) * (x_ext.dim() - dim) + (p, p) * (dim - 1))
    for off in offsets:
        yield xp[tuple(slice(p + o, p + o + s) for o, s in zip(off, core))]


class HaloSaddleOperator:
    """Stripe-partitioned Taylor-Hood saddle apply [[A, G], [G^T, 0]].

    The pressure is embedded on the fine velocity lattice (its value at
    every r-th site, zeros elsewhere) and the saddle vector is one
    (fine..., d + 1) grid, split in stripes like HaloStencilOperator's:

      x[..., :d] = velocity components      x[..., d] = embedded pressure

    A is the d x d block stencil on the fine lattice (kernel #1's block
    form on the extended stripe); G taps the embedded pressure at its
    fine-unit offsets; G^T is a stencil whose weights are the coarse WGT
    planes embedded at the r-strided sites. One exchange of
    max(pad_A, pad_G, pad_GT, 1) rows an apply serves all three. Sites
    that are not coarse pressure sites are constrained identity rows with
    zero data, so MINRES on the embedded vector is MINRES on the compact
    one.
    """

    def __init__(self, sst, WA, group: Group):
        d = sst.d
        dim = len(sst.fine)
        fine = tuple(sst.fine)
        r = sst.r
        dev = group.device
        WA = _as_tensor(WA, dev, torch.float64)  # (KA, *fine, d, d)
        WG = torch.as_tensor(np.asarray(sst.WG, dtype=np.float64), device=dev)  # (KG, *fine, d)
        WGTc = np.asarray(sst.WGT, dtype=np.float64)  # (KGT, *coarse, d)
        WGT_np = np.zeros((WGTc.shape[0],) + fine + (d,))
        WGT_np[(slice(None),) + tuple(slice(0, None, r) for _ in range(dim))] = WGTc
        WGT = torch.as_tensor(WGT_np, device=dev)
        self.offs_a = [tuple(int(v) for v in o) for o in sst.wmapA.offsets]
        self.offs_g = [tuple(int(v) for v in o) for o in sst.offs_g]
        self.offs_gt = [tuple(int(v) for v in o) for o in sst.offs_gt]
        reach = lambda offs: int(max((abs(v) for o in offs for v in o), default=0))
        pad = max(sst.wmapA.pad, reach(self.offs_g), reach(self.offs_gt), 1)
        self.stripes = _Stripes(fine[0], pad, group, "saddle")
        self.group = group
        self.sst = sst
        self.d = d
        self.dim = dim
        self.r = r
        self.pad = pad
        self.rows_orig = fine[0]
        self.shape = (self.stripes.rows_pad,) + fine[1:]
        self.grid_shape = self.shape + (d + 1,)
        self.WA = self.stripes.extended(WA)
        p, L = pad, self.stripes.local
        self.WG = self.stripes.extended(WG)[:, p:p + L]
        self.WGT = self.stripes.extended(WGT)[:, p:p + L]
        self.core = (L,) + fine[1:]
        self.plan_a = StencilPlan((L + 2 * p,) + fine[1:], self.offs_a, sst.wmapA.pad, ncomp=d)

    def __call__(self, x_blk: torch.Tensor) -> torch.Tensor:
        p, d, L = self.pad, self.d, self.stripes.local
        x_ext = self.stripes.extend(x_blk.to(torch.float64))
        ru = self.plan_a(self.WA, x_ext[..., :d].contiguous())[p:p + L]
        for k, tap in enumerate(_taps(x_ext[..., d], self.offs_g, p, self.core)):
            ru = ru + self.WG[k] * tap[..., None]
        rp = torch.zeros(self.core, dtype=x_ext.dtype, device=x_ext.device)
        for k, tap in enumerate(_taps(x_ext[..., :d], self.offs_gt, p, self.core)):
            rp = rp + (self.WGT[k] * tap).sum(dim=-1)
        return torch.cat([ru, rp[..., None]], dim=-1)

    def pad_grid(self, x, fill=0.0) -> torch.Tensor:
        return self.stripes.pad_grid(x, fill, self.group.device, torch.float64)

    def pad_mask(self, mask) -> torch.Tensor:
        return self.stripes.pad_grid(mask, True, self.group.device, torch.bool)

    def crop_grid(self, x_blk: torch.Tensor) -> torch.Tensor:
        return self.stripes.gather(x_blk)

    # -- dof <-> embedded-grid plumbing (host side) ----------------------

    def embed_np(self, x_dof: np.ndarray, fill=0.0) -> np.ndarray:
        """[u; p] flat dof vector -> (fine..., d + 1) embedded grid."""
        sst, d = self.sst, self.d
        x_dof = np.asarray(x_dof)
        u = sst.blat.embed_np(x_dof[: sst.n_u], fill).reshape(tuple(sst.fine) + (d,))
        pc = sst.lat_p.embed_np(x_dof[sst.n_u:], fill).reshape(sst.coarse)
        p = np.full(sst.fine, fill, dtype=pc.dtype)
        p[tuple(slice(0, None, self.r) for _ in range(self.dim))] = pc
        return np.concatenate([u, p[..., None]], axis=-1)

    def extract_np(self, x_grid: np.ndarray) -> np.ndarray:
        """(fine..., d + 1) embedded grid -> [u; p] flat dof vector."""
        sst = self.sst
        x_grid = np.asarray(x_grid)
        u = x_grid[..., : self.d].reshape(-1)[sst.blat.inv]
        strided = tuple(slice(0, None, self.r) for _ in range(self.dim)) + (self.d,)
        pc = x_grid[strided].reshape(-1)[sst.lat_p.inv]
        return np.concatenate([u, pc])


def halo_saddle_minres(
    op: HaloSaddleOperator,
    b,
    mask,
    g,
    rtol: float = 1e-9,
    atol: float = 1e-14,
    maxiter: int = 20000,
):
    """MINRES on the stripe-partitioned embedded saddle grid.

    b / mask / g are unpadded (fine..., d + 1) grids (sites off the coarse
    pressure lattice masked True with zero data: embed_np with fill does
    this). Returns (x, info): the full grid, the same on every rank."""
    b_s, g_s, mask_s = op.pad_grid(b), op.pad_grid(g), op.pad_mask(mask)
    A = constrained_operator(op, mask_s)
    rhs = constrained_rhs(op, b_s, mask_s, g_s)
    x0 = torch.where(mask_s, g_s, 0.0)
    x, info = minres(A, rhs, x0=x0, rtol=rtol, atol=atol, maxiter=maxiter,
                     reduce=op.group.allreduce_sum)
    return op.crop_grid(x), info


def sharded_stokes_step(
    n: int, group: Group, rtol: float = 1e-8
) -> Tuple[Callable, Tuple]:
    """Stripe-partitioned Taylor-Hood Stokes on an n x n unit square: the
    whole [[A, G], [G^T, 0]] saddle as fine-lattice stencils with a halo
    exchange, MINRES. Returns (step, example_args); step(b, mask, g) ->
    (x, iterations, residual)."""
    from ..fem import symbolic
    from ..fem.assemble import (
        GatherSum,
        cell_batch,
        local_divergence,
        local_vector_laplacian,
        local_vector_load,
    )
    from ..fem.mesh import unit_square_mesh
    from ..fem.spaces import FunctionSpace
    from ..solvers.saddle_stencil import build_saddle_stencil

    fmesh = unit_square_mesh(n)
    V = FunctionSpace(fmesh, 2, ncomp=2)
    Q = FunctionSpace(fmesh, 1)
    # P1 pressure basis at the velocity quadrature points: a degree-1 cell
    # batch on the same quadrature rule
    cb1 = cell_batch(fmesh, 1, qdegree=4)
    cb2 = cell_batch(fmesh, 2, qdegree=4)
    A_loc = np.asarray(local_vector_laplacian(cb2, 1.0))
    G_loc = np.asarray(local_divergence(cb2, np.asarray(cb1.phi)))
    sst = build_saddle_stencil(V, Q, G_loc)
    if sst is None:
        raise ValueError("the unit square's Taylor-Hood dofs form no nested lattices")
    op = HaloSaddleOperator(sst, sst.wmapA.weights_np(A_loc), group)

    fx = symbolic.lambdify_spatial("2*pi**2*sin(pi*x)*sin(pi*y)", 2, "cpu")
    fy = symbolic.lambdify_spatial("x*(1-x) + y*(1-y)", 2, "cpu")
    f_q = torch.stack([fx(cb2.qpts), fy(cb2.qpts)], dim=-1)
    loads = torch.as_tensor(np.asarray(local_vector_load(cb2, f_q)))
    b_u = GatherSum(V.dofmap, V.ndof, "cpu")(loads).numpy()
    n_u, n_p = V.ndof, Q.ndof
    b_dof = np.concatenate([b_u, np.zeros(n_p)])
    mask_dof = np.zeros(n_u + n_p, dtype=bool)
    bs = V.boundary_scalar_dofs
    mask_dof[(bs[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)] = True
    mask_dof[n_u] = True  # pin one pressure dof
    g_dof = np.zeros(n_u + n_p)

    args = (
        torch.as_tensor(op.embed_np(b_dof, 0.0), device=group.device),
        torch.as_tensor(op.embed_np(mask_dof, True).astype(bool), device=group.device),
        torch.as_tensor(op.embed_np(g_dof, 0.0), device=group.device),
    )

    def step(b_arr, mask_arr, g_arr):
        x, info = halo_saddle_minres(op, b_arr, mask_arr, g_arr, rtol=rtol)
        return x, info.iterations, info.residual

    return step, args
