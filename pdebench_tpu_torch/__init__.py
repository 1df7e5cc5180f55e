"""pdebench_tpu_torch — the FEM oracle library on PyTorch and CUDA.

A port of `pdebench_tpu` (the JAX reference, which stays beside it) to
PyTorch, with its TPU kernels rewritten by hand as CUDA C++ for Hopper
(`sm_90a`). The package imports torch and never jax; the reference's
numpy-only modules are copied, not imported, because importing anything
from `pdebench_tpu` imports jax.

Layout
------
fem/      meshes, reference elements, dof maps (numpy copies), symbolic
          layer (sympy -> numpy -> torch), scalar host assembly
solvers/  lattice stencil operators, stencil GMG, Krylov + mixed-
          precision refinement, dispatch, host LU; each CUDA kernel's
          wrapper sits beside its plain PyTorch version
oracle/   OracleSolver front end and the Poisson oracle
csrc/     CUDA sources, compiled with nvcc at first use (_build.py)

Every entry point takes an explicit `device`; f64 for the outer solve and
f32 for the inner solve. A wrapper runs its plain PyTorch version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
