"""Oracle dispatcher: case pde type -> solver on an explicit device.

Port of pdebench_tpu/oracle/oracle.py. Poisson is ported; the other 13
PDE types of the reference raise NotImplementedError until their slice
lands.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from .types import OracleResult

_SOLVERS = {
    "poisson": ("poisson", "PoissonSolver"),
}

_NOT_PORTED = (
    "heat", "wave", "helmholtz", "convection_diffusion",
    "reaction_diffusion", "burgers", "linear_elasticity", "biharmonic",
    "stokes", "navier_stokes", "darcy", "hyperelasticity", "cahn_hilliard",
)


class OracleSolver:
    """Ground-truth solver front end.

    `device` is required ("cpu", "cuda", "cuda:1", ...): the solve runs
    there and nowhere else. On a CUDA device the lattice route runs the
    CUDA kernels; on the CPU it runs their plain PyTorch versions.
    """

    def __init__(self, device):
        self.device = torch.device(device)

    def solve(self, oracle_config: Dict[str, Any]) -> OracleResult:
        pde_type = oracle_config["pde"]["type"]
        if pde_type in _NOT_PORTED:
            raise NotImplementedError(
                f"pde type {pde_type!r} is not ported to pdebench_tpu_torch yet"
            )
        if pde_type not in _SOLVERS:
            raise ValueError(f"unsupported pde type: {pde_type}")
        mod_name, cls_name = _SOLVERS[pde_type]
        mod = importlib.import_module(f".{mod_name}", package=__package__)
        return getattr(mod, cls_name)(self.device).solve(oracle_config)
