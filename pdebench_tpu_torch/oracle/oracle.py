"""Oracle dispatcher: case pde type -> solver on an explicit device.

Port of pdebench_tpu/oracle/oracle.py: all 14 PDE types of the
reference, and its `solve(oracle_config, solver_library, use_docker,
docker_image)` signature: "cpp" goes to the out-of-process C++ backend
(cpp_backend.py), every other library to the in-process port on the
solver's device.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

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

    def solve(
        self,
        oracle_config: Dict[str, Any],
        solver_library: str = "torch",
        use_docker: bool = False,  # interface parity; no containers needed
        docker_image: Optional[str] = None,
    ) -> OracleResult:
        del use_docker, docker_image
        if (solver_library or "torch").lower() == "cpp":
            from .cpp_backend import solve_via_cpp

            return solve_via_cpp(oracle_config)

        pde_type = oracle_config["pde"]["type"]
        if pde_type not in _SOLVERS:
            raise ValueError(f"unsupported pde type: {pde_type}")
        mod_name, cls_name = _SOLVERS[pde_type]
        mod = importlib.import_module(f".{mod_name}", package=__package__)
        return getattr(mod, cls_name)(self.device).solve(oracle_config)
