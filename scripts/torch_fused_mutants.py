"""Mutation check of kernels #2 / #3 (the fused inner CG and its
Richardson mode), #4 (the block inner CG and its Richardson mode), #5
(the dynamic-weight block V-cycle chain) and #6 (the fused Arnoldi
cycle) on a CUDA card: which check sees which fault.

    python3 scripts/torch_fused_mutants.py [mutant ...]

For the unmutated control and each mutant: a copy of the package,
chip_smoke.py and the dataset under build/pdebench_tpu_torch/mutants/<name>
(built there, from the copy's sources), one mutation applied to the copy,
then a subprocess in the copy that runs the mutated kernel's checks of
chip_smoke.py, each phase on its own: for kernels #2 / #3 phase 3
(`check_fused_cg` on poisson_basic's and poisson_p3_variable_kappa_mild's
hierarchies: one PCG step, then 25), phase 3b (`check_richardson` on
helmholtz_basic_k5's and helmholtz_k12_exponential_mode's: 1 and 2
cycles, linearity) and the 2-D Poisson and basic_k5 solves (phases 4 and
5: `drive`, one solve each, the asserted rounds); for kernel #4 phase 3d
(`check_block_cg` on linear_elasticity_nu010's and _nu030's hierarchies:
one PCG step, 25, the variants bit for bit, Richardson at 1 and 2
cycles; then `check_block_transpose` on the rough-mu lattice) and the
elasticity solves (phase 6); for kernel #5 phase 3e
(`check_dyn_block` on navier_stokes_basic's hierarchy) and its
Navier-Stokes main path (phase 8: `drive_ns`, one solve per case); for
kernel #6 phase 3c (`check_gmres` on helmholtz_k12_exponential_mode's and
helmholtz_3d_k1_trig's hierarchies) and the two cases' solves (phases 5
and 7: `drive`, one solve each). Prints per mutant and phase "caught"
with the failing check's message, or "not caught". Each mutation reaches
its kernel only (the cluster header is copied for the mutated kernel
alone, the other kernels keep their sources). Named mutants run alone;
with none, all of them do:

  cgnobarrier  kernel #2 drops the cluster barrier after the stage that
               writes the CTA partials of <p, Ap>: alpha is summed from
               partials other CTAs may not have written yet
  stalewindow  the Richardson chain's residual v - A0 z reads the window
               left by the stage before (level 0's x) instead of restaging
               z's after z changed (#3)
  ctasweeps9   the coarsest level in CTA 0's shared memory swept 9 times
               instead of 10 (#2 / #3)
  stalekeep    CTA 0 keeps the coarse levels' W and D pointers of the
               first descriptor it launched on and loads every later
               launch's coarse levels from them (#2 / #3)
  blocknobarrier  kernel #4 drops the cluster barrier after the stage
               that writes the CTA partials of <p, Ap>
  blockstalewindow  #4's Richardson residual r - A0 z reads the window
               left by the stage before instead of restaging z's
  blockstalekeep  #4's CTA 0 keeps the coarse block levels' W and D
               pointers of the first hierarchy it launched on
  blocktranspose  #4's block taps read W[k, b, a] for W[k, a, b] (every
               level)
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
_CG_NOBARRIER = (
    os.path.join(CSRC, "gmg_fused_cg.cu"),
    "      put_red(acc, red, kPAp, sh);\n    }\n    cluster.sync();\n",
    "      put_red(acc, red, kPAp, sh);\n    }\n",
)
_STALE_WINDOW = (
    "      const Window zw = stage_in(z, L0, T[0], b, 1, sm);\n",
    "      const Window zw = window_of(L0, T[0], b, sm);\n",
)
_STALE_KEEP = (
    "__device__ void cta_load(const Level* lv, int lstar, int nlev, float* keep) {\n"
    "  for (int l = lstar; l < nlev; ++l) {\n"
    "    const Level& L = lv[l];\n",
    "__device__ const float* mut_W[kMaxLevels];\n"
    "__device__ const float* mut_D[kMaxLevels];\n"
    "__device__ int mut_set;\n"
    "__device__ void cta_load(const Level* lv, int lstar, int nlev, float* keep) {\n"
    "  if (threadIdx.x == 0 && !mut_set)\n"
    "    for (int l = 0; l < nlev; ++l) { mut_W[l] = lv[l].W; mut_D[l] = lv[l].D; }\n"
    "  __syncthreads();\n"
    "  if (threadIdx.x == 0) mut_set = 1;\n"
    "  for (int l = lstar; l < nlev; ++l) {\n"
    "    Level L = lv[l];\n"
    "    if (mut_W[l]) { L.W = mut_W[l]; L.D = mut_D[l]; }\n",
)
_BLOCK = os.path.join(CSRC, "gmg_fused_block_cg.cu")
_BLOCK_NOBARRIER = (
    _BLOCK,
    "      put_red(acc, red, kPAp, sh);\n    }\n    cluster.sync();\n",
    "      put_red(acc, red, kPAp, sh);\n    }\n",
)
_BLOCK_STALE_WINDOW = (
    _BLOCK,
    "        const Window zw = stage_in(zp, L0, H.T[0], b0, 2, sm);\n",
    "        const Window zw = window_of(L0, H.T[0], b0, sm);\n",
)
_BLOCK_STALE_KEEP = (
    _BLOCK,
    "__device__ void cta2_load(const Level* lv, int lstar, int nlev, float* keep) {\n"
    "  for (int l = lstar; l < nlev; ++l) {\n"
    "    const Level& L = lv[l];\n",
    "__device__ const float* mut_W[kMaxLevels];\n"
    "__device__ const float* mut_D[kMaxLevels];\n"
    "__device__ int mut_set;\n"
    "__device__ void cta2_load(const Level* lv, int lstar, int nlev, float* keep) {\n"
    "  if (threadIdx.x == 0 && !mut_set)\n"
    "    for (int l = 0; l < nlev; ++l) { mut_W[l] = lv[l].W; mut_D[l] = lv[l].D; }\n"
    "  __syncthreads();\n"
    "  if (threadIdx.x == 0) mut_set = 1;\n"
    "  for (int l = lstar; l < nlev; ++l) {\n"
    "    Level L = lv[l];\n"
    "    if (mut_W[l]) { L.W = mut_W[l]; L.D = mut_D[l]; }\n",
)
_BLOCK_TRANSPOSE = (_BLOCK,) + _APPLY
# mutant -> (kernel source the header edits go to, edits)
MUTANTS = {
    "control23": ("gmg_fused_cg", []),
    "cgnobarrier": ("gmg_fused_cg", [_CG_NOBARRIER]),
    "stalewindow": ("gmg_fused_cg", [_STALE_WINDOW]),
    "ctasweeps9": ("gmg_fused_cg", [_SWEEPS]),
    "stalekeep": ("gmg_fused_cg", [_STALE_KEEP]),
    "control4": ("gmg_fused_block_cg", []),
    "blocknobarrier": ("gmg_fused_block_cg", [_BLOCK_NOBARRIER]),
    "blockstalewindow": ("gmg_fused_block_cg", [_BLOCK_STALE_WINDOW]),
    "blockstalekeep": ("gmg_fused_block_cg", [_BLOCK_STALE_KEEP]),
    "blocktranspose": ("gmg_fused_block_cg", [_BLOCK_TRANSPOSE]),
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
if kernel == "gmg_fused_cg":
    p2, p3 = "poisson_basic", "poisson_p3_variable_kappa_mild"
    k5, k12 = "helmholtz_basic_k5", "helmholtz_k12_exponential_mode"
    cases = cs.load_cases({p2, p3, k5, k12})
    phases = (
        ("3", lambda: cs.check_fused_cg({cid: cs.poisson_operator(cases[cid], dev) for cid in (p2, p3)},
                                        np.random.default_rng(0), dev, {}, {})),
        ("3b", lambda: cs.check_richardson({cid: cs.helmholtz_operator(cases[cid], dev) for cid in (k5, k12)},
                                           np.random.default_rng(0), dev, {}, {})),
        ("4", lambda: cs.drive(OracleSolver(device=dev), cases,
                               {cid: (e, t, "fused-cg-cuda", o, 25)
                                for cid, (e, t, o) in cs.POISSON.items()}, "4")),
        ("5", lambda: cs.drive(OracleSolver(device=dev), cases, {k5: cs.HELMHOLTZ[k5] + (30,)}, "5")),
    )
elif kernel == "gmg_fused_block_cg":
    e10, e30 = "linear_elasticity_nu010", "linear_elasticity_nu030"
    cases = cs.load_cases({e10, e30})
    phases = (
        ("3d", lambda: cs.check_block_cg({cid: cs.elasticity_operator(cases[cid], dev) for cid in (e10, e30)},
                                         np.random.default_rng(0), dev, {})),
        ("3d rough-mu", lambda: cs.check_block_transpose(
            *cs.elasticity_operator(cases[e10], dev, rough=True), np.random.default_rng(0), dev)),
        ("6", lambda: cs.drive(OracleSolver(device=dev), cases,
                               {cid: (e, t, "fused-block-cg-cuda", o, 25)
                                for cid, (e, t, o) in cs.ELASTICITY.items()}, "6")),
    )
elif kernel == "gmg_fused_dyn_block":
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


def main(argv) -> int:
    unknown = set(argv) - set(MUTANTS)
    if unknown:
        raise SystemExit(f"unknown mutants {sorted(unknown)}; known: {sorted(MUTANTS)}")
    chosen = {name: MUTANTS[name] for name in (argv or MUTANTS)}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    # every copy first: a missing pattern raises before any check runs
    copies = {name: make_copy(name, kernel, edits) for name, (kernel, edits) in chosen.items()}
    for name, (kernel, _) in chosen.items():
        dst = copies[name]
        proc = subprocess.run([sys.executable, "-c", CHECK, kernel], cwd=dst, capture_output=True,
                              text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith(("RESULT", "[3]", "[3b]", "[3c]", "[3d]", "[3e]", "[4]", "[5]", "[6]",
                                  "[7]", "[8]"))]
        for line in lines:
            print(f"{name}: {line}", flush=True)
        if proc.returncode != 0:
            print(f"{name}: exit {proc.returncode}: {proc.stderr[-2000:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
