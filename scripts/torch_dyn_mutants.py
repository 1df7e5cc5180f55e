"""Mutation check of kernels #5 (the dynamic-weight block V-cycle chain)
and #6 (the fused Arnoldi cycle) on a CUDA card: which check sees which
fault.

    python3 scripts/torch_dyn_mutants.py

For the unmutated control and each mutant: a copy of the package,
chip_smoke.py and the dataset under build/pdebench_tpu_torch/mutants/<name>
(built there, from the copy's sources), one mutation applied to the copy,
then a subprocess in the copy that runs the mutated kernel's checks of
chip_smoke.py, each phase on its own: for kernel #5 phase 3e
(`check_dyn_block` on navier_stokes_basic's hierarchy) and its
Navier-Stokes main path (phase 8: `drive_ns`, one solve per case); for
kernel #6 phase 3c (`check_gmres` on helmholtz_k12_exponential_mode's and
helmholtz_3d_k1_trig's hierarchies) and the two cases' solves (phases 5
and 7: `drive`, one solve each). Prints per mutant and phase "caught"
with the failing check's message, or "not caught". Each mutation reaches
its kernel only (the cluster header is copied for the mutated kernel
alone, the other kernels keep their sources):

  stale      the wrapper packs one level descriptor per kernel object (at
             the first weight set it sees) and launches every later weight
             set on it (#5)
  transpose  kernel #5's block taps read W[k, b, a] for W[k, a, b]
  sweeps9    kernel #5's coarsest level swept 9 times instead of 10 (x = D r
             and 8 sweeps)
  nobarrier  kernel #6 drops the cluster barrier between its first and
             second Gram-Schmidt terms: the second term's dot is summed
             from partials other CTAs may not have written yet

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
    "      w01[b] = in ? w(q + 1, idx) : 0.f;  // W[k,0,1]\n"
    "      w10[b] = in ? w(q + 2, idx) : 0.f;  // W[k,1,0]\n",
    "      w01[b] = in ? w(q + 2, idx) : 0.f;\n"
    "      w10[b] = in ? w(q + 1, idx) : 0.f;\n",
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
_NOBARRIER = (
    os.path.join(CSRC, "gmg_fused_gmres.cu"),
    "      put_red(acc, red, i < j ? kMgs + ((i + 1) & 1) : kW, sh);\n      cluster.sync();\n",
    "      put_red(acc, red, i < j ? kMgs + ((i + 1) & 1) : kW, sh);\n      if (i != 0) cluster.sync();\n",
)
# mutant -> (kernel source the header edits go to, edits)
MUTANTS = {
    "control5": ("gmg_fused_dyn_block", []),
    "stale": ("gmg_fused_dyn_block", _STALE),
    "transpose": ("gmg_fused_dyn_block", [_APPLY]),
    "sweeps9": ("gmg_fused_dyn_block", [_SWEEPS]),
    "control6": ("gmg_fused_gmres", []),
    "nobarrier": ("gmg_fused_gmres", [_NOBARRIER]),
}

CHECK = r"""
import sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from pdebench_tpu_torch.oracle import OracleSolver
from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem

dev = torch.device("cuda")
kernel = sys.argv[1]
cs.SOLVES = 1
if kernel == "gmg_fused_dyn_block":
    cases = cs.load_cases(set(cs.NAVIER_STOKES))
    phases = (
        ("3e", lambda: cs.check_dyn_block(NavierStokesProblem(cases["navier_stokes_basic"], dev),
                                          np.random.default_rng(0), dev, {})),
        ("8", lambda: cs.drive_ns(OracleSolver(device=dev), cases, cs.NAVIER_STOKES, "8")),
    )
else:
    k12, k1 = "helmholtz_k12_exponential_mode", "helmholtz_3d_k1_trig"
    cases = cs.load_cases({k12, k1})
    phases = (
        ("3c", lambda: cs.check_gmres({cid: cs.helmholtz_operator(cases[cid], dev) for cid in (k12, k1)},
                                      np.random.default_rng(0), dev, {}, {})),
        ("5", lambda: cs.drive(OracleSolver(device=dev), cases,
                               {k12: cs.HELMHOLTZ[k12] + (30,)}, "5")),
        ("7", lambda: cs.drive(OracleSolver(device=dev), cases, {k1: cs.LATTICE_3D[k1]}, "7")),
    )
for phase, run in phases:
    try:
        run()
        print(f"RESULT phase {phase}: not caught", flush=True)
    except Exception as e:
        print(f"RESULT phase {phase}: caught, {type(e).__name__}: {str(e)[:400]}", flush=True)
"""


def make_copy(name: str, kernel: str, edits) -> str:
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
        else:  # an edit of the cluster header, for this kernel alone
            old, new = edit
            path = os.path.join(CSRC, "gmg_cluster_mut.cuh")
            if not os.path.exists(os.path.join(dst, path)):
                shutil.copy(os.path.join(dst, CSRC, "gmg_cluster.cuh"), os.path.join(dst, path))
                cu = os.path.join(dst, CSRC, f"{kernel}.cu")
                text = open(cu).read()
                assert '#include "gmg_cluster.cuh"' in text
                open(cu, "w").write(text.replace('"gmg_cluster.cuh"', '"gmg_cluster_mut.cuh"'))
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
    # every copy first: a missing pattern raises before any check runs
    copies = {name: make_copy(name, kernel, edits) for name, (kernel, edits) in MUTANTS.items()}
    for name, (kernel, _) in MUTANTS.items():
        dst = copies[name]
        proc = subprocess.run([sys.executable, "-c", CHECK, kernel], cwd=dst, capture_output=True,
                              text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith(("RESULT", "[3c]", "[3e]", "[5]", "[7]", "[8]"))]
        for line in lines:
            print(f"{name}: {line}", flush=True)
        if proc.returncode != 0:
            print(f"{name}: exit {proc.returncode}: {proc.stderr[-2000:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
