"""Mutation check of kernel #5 (the dynamic-weight block V-cycle chain) on a
CUDA card: which check sees which fault.

    python3 scripts/torch_dyn_mutants.py

For the unmutated control and each mutant: a copy of the package,
chip_smoke.py and the dataset under build/pdebench_tpu_torch/mutants/<name>
(built there, from the copy's sources), one mutation applied to the copy,
then a subprocess in the copy that runs kernel #5's checks of chip_smoke.py
(phase 3e: `check_dyn_block` on navier_stokes_basic's hierarchy) and,
independently, its Navier-Stokes main path (phase 8: `drive_ns`, one solve
per case). Prints per mutant and phase "caught" with the failing check's
message, or "not caught". Each mutation reaches kernel #5 only (the
kernels #2-#4 and #6 keep their sources):

  stale      the wrapper packs one level descriptor per kernel object (at
             the first weight set it sees) and launches every later weight
             set on it
  transpose  kernel #5's block apply reads W[k, b, a] for W[k, a, b] (a
             copy of gmg_block_vcycle.cuh that gmg_fused_dyn_block.cu
             alone includes)
  sweeps9    kernel #5's coarsest level swept 9 times instead of 10 (x = D r
             and 8 sweeps, in the same header copy)

A mutation whose pattern is missing from the sources raises. Imports
neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "pdebench_tpu_torch", "mutants")
CSRC = os.path.join("pdebench_tpu_torch", "csrc")

_APPLY = (
    "      a0 += __ldg(w) * u0 + __ldg(w + n) * u1;              // W[k,0,0], W[k,0,1]\n"
    "      a1 += __ldg(w + 2 * n) * u0 + __ldg(w + 3 * n) * u1;  // W[k,1,0], W[k,1,1]\n",
    "      a0 += __ldg(w) * u0 + __ldg(w + 2 * n) * u1;\n"
    "      a1 += __ldg(w + n) * u0 + __ldg(w + 3 * n) * u1;\n",
)
_SWEEPS = (
    "for (int s = 0; s < kCoarseSweeps - 1; ++s) {",
    "for (int s = 0; s < kCoarseSweeps - 2; ++s) {",
)
_STALE = [
    (os.path.join("pdebench_tpu_torch", "solvers", "gmg_fused.py"),
     "desc_t = levels.cache.get(self)", 'desc_t = getattr(self, "_stale_desc", None)'),
    (os.path.join("pdebench_tpu_torch", "solvers", "gmg_fused.py"),
     "levels.cache[self] = desc_t", "self._stale_desc = desc_t"),
]
MUTANTS = {"control": [], "stale": _STALE, "transpose": [_APPLY], "sweeps9": [_SWEEPS]}

CHECK = r"""
import sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem

dev = torch.device("cuda")
cases = cs.load_cases(set(cs.NAVIER_STOKES))
cs.SOLVES = 1
for phase, run in (
    ("3e", lambda: cs.check_dyn_block(NavierStokesProblem(cases["navier_stokes_basic"], dev),
                                      np.random.default_rng(0), dev, {})),
    ("8", lambda: cs.drive_ns(OracleSolver(device=dev), cases, cs.NAVIER_STOKES, "8")),
):
    try:
        run()
        print(f"RESULT phase {phase}: not caught", flush=True)
    except Exception as e:
        print(f"RESULT phase {phase}: caught, {type(e).__name__}: {str(e)[:400]}", flush=True)
"""


def make_copy(name: str, edits) -> str:
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "pdebench_tpu_torch"), os.path.join(dst, "pdebench_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dst, "data"))
    shutil.copy(os.path.join(ROOT, "data", "benchmark_v2.jsonl"), os.path.join(dst, "data"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    for edit in edits:
        if len(edit) == 3:  # (file, old, new)
            path, old, new = edit
        else:  # a kernel #5-only edit of the shared block header
            old, new = edit
            path = os.path.join(CSRC, "gmg_block_vcycle_mut.cuh")
            src = os.path.join(dst, CSRC, "gmg_block_vcycle.cuh")
            if not os.path.exists(os.path.join(dst, path)):
                shutil.copy(src, os.path.join(dst, path))
                cu = os.path.join(dst, CSRC, "gmg_fused_dyn_block.cu")
                text = open(cu).read()
                assert '#include "gmg_block_vcycle.cuh"' in text
                open(cu, "w").write(text.replace('"gmg_block_vcycle.cuh"', '"gmg_block_vcycle_mut.cuh"'))
        full = os.path.join(dst, path)
        text = open(full).read()
        if old not in text:
            raise RuntimeError(f"mutation pattern missing in {path}: {old!r}")
        open(full, "w").write(text.replace(old, new))
    return dst


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    for name, edits in MUTANTS.items():
        dst = make_copy(name, edits)
        proc = subprocess.run([sys.executable, "-c", CHECK], cwd=dst, capture_output=True,
                              text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines() if l.startswith(("RESULT", "[3e]", "[8]"))]
        for line in lines:
            print(f"{name}: {line}", flush=True)
        if proc.returncode != 0:
            print(f"{name}: exit {proc.returncode}: {proc.stderr[-2000:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
