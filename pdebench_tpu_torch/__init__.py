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
oracle/   OracleSolver front end and the ported oracles (all 14 PDE
          types), the out-of-process runner and the native (C++) backend
csrc/     CUDA sources, compiled with nvcc at first use (_build.py)
core/     prompt builder, LLM client (offline `mock`), feedback prompts
agents/   agent registry + wrappers
sandbox/  sandboxed execution of agent-generated solvers (Python, C++)
metrics/  universal + specialized metrics, scoring, tier levels
analysis/ gate analyzer, error classifier
docs/     the library guides injected into agents' prompts

The harness modules (core, agents, sandbox, metrics, analysis) are copies
of the reference's host-only code; scripts/torch_run_benchmark.py drives
them on this package.

Every entry point runs on `device`, the card ("cuda") unless the caller
asks for the CPU; f64 for the outer solve and
f32 for the inner solve. A wrapper runs its plain PyTorch version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
