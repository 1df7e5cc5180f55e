"""Oracle dispatcher: case pde type -> solver on an explicit device.

Port of pdebench_tpu/oracle/oracle.py: all 14 PDE types of the
reference.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from .types import OracleResult

_SOLVERS = {
    "poisson": ("poisson", "PoissonSolver"),
    "helmholtz": ("helmholtz", "HelmholtzSolver"),
    "linear_elasticity": ("linear_elasticity", "LinearElasticitySolver"),
    "navier_stokes": ("navier_stokes", "NavierStokesSolver"),
    "stokes": ("stokes", "StokesSolver"),
    "heat": ("heat", "HeatSolver"),
    "biharmonic": ("biharmonic", "BiharmonicSolver"),
    "convection_diffusion": ("convection_diffusion", "ConvectionDiffusionSolver"),
    "reaction_diffusion": ("reaction_diffusion", "ReactionDiffusionSolver"),
    "burgers": ("burgers", "BurgersSolver"),
    "wave": ("wave", "WaveSolver"),
    "darcy": ("darcy", "DarcySolver"),
    "hyperelasticity": ("hyperelasticity", "HyperelasticitySolver"),
    "cahn_hilliard": ("cahn_hilliard", "CahnHilliardSolver"),
}


class OracleSolver:
    """Ground-truth solver front end.

    `device` ("cuda" unless the caller asks for another: "cpu", "cuda:1",
    ...): the solve runs there and nowhere else. On a CUDA device the
    lattice route runs the CUDA kernels; on the CPU it runs their plain
    PyTorch versions. Constructing one touches no device.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def solve(self, oracle_config: Dict[str, Any]) -> OracleResult:
        pde_type = oracle_config["pde"]["type"]
        if pde_type not in _SOLVERS:
            raise ValueError(f"unsupported pde type: {pde_type}")
        mod_name, cls_name = _SOLVERS[pde_type]
        mod = importlib.import_module(f".{mod_name}", package=__package__)
        return getattr(mod, cls_name)(self.device).solve(oracle_config)
