"""Cell-parallel domain decomposition: cells split over ranks.

The reference's only distribution mechanism is MPI domain decomposition
inside DOLFINx/PETSc (pdebench/oracle/common.py:52,352-365: COMM_WORLD
meshes and an MPI.SUM reduction of the sampled grids). Here:

  - cells (and their dense local matrices) are split into contiguous
    blocks, one a rank (parallel/group.py);
  - the solution vector is replicated; each rank computes the partial
    global matvec of its cell block (gather -> batched matvec -> the
    fixed-order sum of fem.assemble.GatherSum) and one
    Group.allreduce_sum of the ndof vector merges the shared dofs'
    contributions (the role of PETSc's ghost updates);
  - Krylov iterations run on the replicated vectors, so dot products
    need no collective.

Port of pdebench_tpu/parallel/sharded.py (shard_map over a `cells` mesh
axis, one psum a matvec).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..fem.assemble import GatherSum, constrained_operator, constrained_rhs
from ..solvers.krylov import cg, jacobi_preconditioner
from .group import Group


def partition_cells(
    A_local: np.ndarray, dofmap: np.ndarray, n_devices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad cell-local matrices and dofmap so n_cells % n_devices == 0.

    Padding cells carry zero matrices and point at dof 0: they add exact
    zeros to its sum, so results are unchanged.
    """
    A_local = np.asarray(A_local)
    dofmap = np.asarray(dofmap)
    rem = (-A_local.shape[0]) % n_devices
    if rem:
        A_local = np.concatenate([A_local, np.zeros((rem,) + A_local.shape[1:], A_local.dtype)])
        dofmap = np.concatenate([dofmap, np.zeros((rem, dofmap.shape[1]), dofmap.dtype)])
    return A_local, dofmap


class ShardedOperator:
    """Global FEM operator with its cells split over the ranks of `group`.

    apply(u) = allreduce_sum(GatherSum(A_c @ u[dofmap_c]) over this rank's
    cells), u replicated: the same operator as fem.assemble.LocalOperator,
    its sums in another order.
    """

    def __init__(self, A_local: np.ndarray, dofmap: np.ndarray, ndof: int, group: Group):
        A_pad, d_pad = partition_cells(A_local, dofmap, group.size)
        per = A_pad.shape[0] // group.size
        own = slice(group.rank * per, (group.rank + 1) * per)
        self.group = group
        self.ndof = int(ndof)
        self.A = torch.as_tensor(A_pad[own], device=group.device)
        self.dofmap = torch.as_tensor(d_pad[own], dtype=torch.int64, device=group.device)
        self._sum = GatherSum(d_pad[own], self.ndof, group.device)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        ve = torch.einsum("cij,cj->ci", self.A, u[self.dofmap])
        # a sum of a few values staged through the host stays there
        return self.group.allreduce_sum(self._sum(ve)).to(u.device)

    def diagonal(self) -> torch.Tensor:
        d = self._sum(torch.einsum("cii->ci", self.A))
        return self.group.allreduce_sum(d).to(d.device)


def sharded_cg(
    op: ShardedOperator,
    b: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10000,
):
    """Jacobi-PCG over the sharded operator with Dirichlet elimination.

    Vectors are replicated; the only collective is the sum inside the
    operator's apply. Mirrors the single-device Jacobi CG."""
    A = constrained_operator(op, mask)
    rhs = constrained_rhs(op, b, mask, g)
    M = jacobi_preconditioner(torch.where(mask, 1.0, op.diagonal()))
    x0 = torch.where(mask, g, 0.0)
    return cg(A, rhs, x0=x0, M=M, rtol=rtol, atol=atol, maxiter=maxiter)


def sharded_poisson_step(
    n: int, group: Group, rtol: float = 1e-8
) -> Tuple[Callable, Tuple]:
    """A whole solve of -Δu = f on an n x n unit square, cells split over
    the ranks of `group`. Returns (step, example_args); step(b, mask, g)
    -> (x, iterations, residual)."""
    from ..fem import symbolic
    from ..fem.assemble import cell_batch, local_load, local_stiffness
    from ..fem.mesh import unit_square_mesh
    from ..fem.spaces import FunctionSpace

    fmesh = unit_square_mesh(n)
    space = FunctionSpace(fmesh, 1)
    cb = cell_batch(fmesh, 1)
    K = np.asarray(local_stiffness(cb))
    f_fn = symbolic.lambdify_spatial("2*pi**2*sin(pi*x)*sin(pi*y)", 2, "cpu")
    loads = torch.as_tensor(np.asarray(local_load(cb, f_fn(cb.qpts))))
    b = GatherSum(space.dofmap_scalar, space.ndof, "cpu")(loads)
    mask = np.zeros(space.ndof, dtype=bool)
    mask[space.boundary_scalar_dofs] = True

    op = ShardedOperator(K, space.dofmap_scalar, space.ndof, group)

    def step(b_arr, mask_arr, g_arr):
        x, info = sharded_cg(op, b_arr, mask_arr, g_arr, rtol=rtol)
        return x, info.iterations, info.residual

    dev = group.device
    example = (b.to(dev), torch.as_tensor(mask, device=dev),
               torch.zeros(space.ndof, dtype=torch.float64, device=dev))
    return step, example
