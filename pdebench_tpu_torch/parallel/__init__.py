"""Multi-device solves over torch.distributed ranks: cell-parallel domain
decomposition (sharded.py: cells split, vectors replicated, one sum over
ranks a matvec) and stripe partitioning of structured lattices (halo.py:
dofs split along the lattice's leading axis, a halo exchange of boundary
rows an apply; scalar 2-D and 3-D lattices, block lattices and the
Taylor-Hood saddle). group.py holds the ranks, their collectives and the
launcher that runs a function of the port on n ranks; dryrun.py the
multi-device dry run.

Port of pdebench_tpu/parallel/ (a jax.sharding.Mesh with ppermute and psum
there).
"""

from .group import Group, launch
from .halo import (
    HaloSaddleOperator,
    HaloStencilOperator,
    halo_pcg,
    halo_saddle_minres,
    sharded_elasticity_step,
    sharded_stokes_step,
)
from .sharded import (
    ShardedOperator,
    partition_cells,
    sharded_cg,
    sharded_poisson_step,
)

__all__ = [
    "HaloStencilOperator",
    "halo_pcg",
    "sharded_elasticity_step",
    "ShardedOperator",
    "partition_cells",
    "sharded_cg",
    "sharded_poisson_step",
    "HaloSaddleOperator",
    "halo_saddle_minres",
    "sharded_stokes_step",
    "Group",
    "launch",
]
