"""Out-of-process oracle entry:

    python -m pdebench_tpu_torch.oracle.runner <case_spec.json> <outdir> [library] [--device DEV]

Writes reference.npy + meta.json into outdir, as
pdebench_tpu/oracle/runner.py does. The solve runs on the card ("cuda")
unless --device names another ("cpu", "cuda:1", ...); `library` is
OracleSolver.solve's solver_library ("torch" unless given: "cpp" runs the
native backend). Process isolation without containers, e.g. for driving
oracles from a separate interpreter or pinning them to a device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("spec")
    ap.add_argument("outdir")
    ap.add_argument("library", nargs="?", default="torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    from . import OracleSolver

    with open(args.spec) as f:
        spec = json.load(f)
    oracle_config = spec.get("oracle_config", spec)

    try:
        result = OracleSolver(device=args.device).solve(oracle_config, args.library)
    except Exception as e:  # structured failure for the host side
        with open(outdir / "meta.json", "w") as f:
            json.dump({"success": False, "error": f"{type(e).__name__}: {e}"}, f)
        return 1

    np.save(outdir / "reference.npy", np.asarray(result.reference))
    with open(outdir / "meta.json", "w") as f:
        json.dump(
            {
                "success": True,
                "baseline_error": result.baseline_error,
                "baseline_time": result.baseline_time,
                "num_dofs": result.num_dofs,
                "solver_info": result.solver_info,
            },
            f,
            default=str,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
