"""Does a Navier-Stokes case's device Newton fall back to the host LU?

    JAX_PLATFORMS=cpu python scripts/ns_device_fallback.py [case_id ...]

For each dataset case: the JAX reference on the CPU, pinned to its
whole-device Newton with the convected-hierarchy preconditioner
(PDEBENCH_TPU_NS_DEVICE_NEWTON=1, PDEBENCH_TPU_NS_CONV_M=hier, the route
pdebench_tpu_torch takes by default), and the port on the CPU tensors
(kernel #5's plain version). The reference falls back to its host-LU
Newton without saying so when a device linear solve does not converge
(oracle/navier_stokes.py:759-769); this counts its host LU factorisations
(direct.ConstrainedLU constructions) during the solve. The port records
the failure in solver_info["iterative_failed"]. Prints per case both
packages' outcome, their linear solves and Krylov iterations, and the
largest difference between their grids.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT = ("navier_stokes_high_re", "navier_stokes_exponential_stream")


def main(argv) -> int:
    from pdebench_tpu.oracle.navier_stokes import NavierStokesSolver as RefSolver
    from pdebench_tpu.solvers import direct as ref_direct
    from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesSolver

    os.environ["PDEBENCH_TPU_NS_DEVICE_NEWTON"] = "1"
    os.environ["PDEBENCH_TPU_NS_CONV_M"] = "hier"
    factorisations = []
    lu = ref_direct.ConstrainedLU

    class CountingLU(lu):
        def __init__(self, *args, **kwargs):
            factorisations.append(1)
            super().__init__(*args, **kwargs)

    ref_direct.ConstrainedLU = CountingLU
    ids = argv or list(DEFAULT)
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        configs = {c["id"]: c["oracle_config"] for c in map(json.loads, fh) if c["id"] in ids}
    for cid in ids:
        factorisations.clear()
        ref = RefSolver().solve(configs[cid], _compute_baseline=False)
        n_lu = len(factorisations)
        port = NavierStokesSolver("cpu").solve(configs[cid], _compute_baseline=False)
        pi, ri = port.solver_info, ref.solver_info
        diff = float(np.nanmax(np.abs(port.reference - ref.reference)))
        print(f"{cid}: reference device Newton {'fell back to its host LU' if n_lu else 'held'} "
              f"({n_lu} host LU factorisations over its cold and warm runs; linear solves "
              f"{ri['iterations']}, Krylov iterations {ri['kry_its']}); port "
              f"{'fell back: ' + pi['iterative_failed'] if 'iterative_failed' in pi else 'held'} "
              f"(linear solves {pi['iterations']}, Krylov iterations {pi['kry_its']}); largest grid "
              f"difference {diff:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
