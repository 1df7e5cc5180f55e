"""Print a digest of the mesh that pdebench_tpu_torch builds for dataset
cases, so that two machines can tell whether they mesh a case alike.

    python3 scripts/torch_mesh_digest.py --case le_test_annulus_wide_ring --case ...

First line: the versions of Python, numpy and scipy (the signed-distance
mesher runs on them). Then one line per case: its nodes and cells and the
first 16 hex digits of the SHA-256 of the node coordinates' and the
cells' bytes, and the time meshing took. Meshing only: nothing is solved
and no device is used.

Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import scipy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(mesh) -> str:
    h = hashlib.sha256(np.ascontiguousarray(mesh.coords, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(mesh.cells, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", action="append", required=True, help="a case id (repeatable)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from pdebench_tpu_torch.oracle import base

    print(f"python {sys.version.split()[0]}, numpy {np.__version__}, scipy {scipy.__version__}",
          flush=True)
    configs = {}
    with open(os.path.join(ROOT, "data", "benchmark_v2.jsonl")) as fh:
        for line in fh:
            c = json.loads(line)
            if c["id"] in args.case:
                configs[c["id"]] = c["oracle_config"]
    for cid in args.case:
        oc = configs[cid]
        t0 = time.perf_counter()
        mesh = base.build_mesh(oc["domain"], oc["mesh"])
        print(f"{cid}: {mesh.coords.shape[0]} nodes, {mesh.n_cells} cells, mesh {digest(mesh)}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
