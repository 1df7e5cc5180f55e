"""Per-stage times of the fused kernels #2, #3, #4, #5 and #6 on a CUDA
card, and the cost of an empty barrier.

    python3 scripts/torch_stage_times.py [--root DIR] [--kernels 2,3,4,5,6]

1. Barriers: a small CUDA source built here times a kernel that does
   nothing but barriers: a cooperative grid of 256-thread blocks
   (grid.sync(), at the block counts kernels #5 and #6 used as
   cooperative launches) and one thread-block cluster of 1024-thread
   CTAs (cluster.sync(), 8 and 16 CTAs). Prints us per barrier.
2. Stages: a copy of the checkout at DIR (default: this script's own)
   under build/pdebench_tpu_torch/stage_times/, in which every
   `<group>.sync();` of the fused kernels' sources is wrapped in two
   stamps: thread 0 of each block writes %globaltimer and clock64 just
   before the barrier and just after it into a device buffer. Kernel #2
   (25 PCG steps) runs on poisson_basic's, poisson_p3_variable_kappa_mild's
   and poisson_3d_kappa_expr's hierarchies, kernel #3 (2 V-cycles) on
   helmholtz_basic_k5's and on helmholtz_3d_k1_trig's at mesh resolution
   12 (25^3), kernel #4 (25 block PCG steps) on linear_elasticity_nu010's
   and _nu030's, kernel #5 on navier_stokes_basic's (1 cycle), kernel #6
   (m = 30) on helmholtz_k12_exponential_mode's 2-D hierarchy and on
   helmholtz_3d_k1_trig's 33^3 one, each once warm with the stamps on
   (--kernels picks which).
   Per barrier site (the function that holds it and its ordinal there),
   summed over the launch: the stages' wall time (release to release),
   the slowest block's work (release to its arrival) and the rest, the
   barrier (last arrival to release, with the blocks' imbalance). The
   stamps cost a few stores per barrier; each kernel's unstamped time is
   printed beside.

The card's name and power limit first; one JSON line last. The stamped
copy lives under build/ (ignored by git); csrc/ carries no stamp switch.
Imports neither jax nor pdebench_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "pdebench_tpu_torch", "stage_times")

BARRIERS_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void grid_barriers(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

__global__ void cluster_barriers(int n) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < n; ++i) cluster.sync();
}

static float time_ms(cudaError_t (*go)(int, int, int), int a, int b, int n) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  if (go(a, b, 16) != cudaSuccess) return -1.f;  // warm-up
  cudaEventRecord(e0);
  if (go(a, b, n) != cudaSuccess) return -1.f;
  cudaEventRecord(e1);
  if (cudaEventSynchronize(e1) != cudaSuccess) return -1.f;
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}

static cudaError_t go_grid(int blocks, int threads, int n) {
  void* args[] = {(void*)&n};
  return cudaLaunchCooperativeKernel((const void*)grid_barriers, dim3(blocks), dim3(threads), args, 0, 0);
}

static cudaError_t go_cluster(int ctas, int threads, int n) {
  cudaFuncSetAttribute(cluster_barriers, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cluster_barriers, n);
}

extern "C" float grid_barrier_ms(int blocks, int threads, int n) { return time_ms(go_grid, blocks, threads, n); }
extern "C" float cluster_barrier_ms(int ctas, int threads, int n) { return time_ms(go_cluster, ctas, threads, n); }
"""

# prepended to gmg_vcycle.cuh in the stamped copy (every fused kernel
# includes it once): one record per block and barrier
STAMPS_CUH = r"""
struct PdbStamp { long long site, pre_ns, post_ns, pre_clk, post_clk, pad0, pad1, pad2; };
__device__ PdbStamp* pdb_buf;
__device__ int* pdb_cnt;
__device__ int pdb_cap;
__device__ __forceinline__ long long pdb_ns() {
  long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t;
}
#define PDB_PRE(s) do { if (threadIdx.x == 0 && pdb_buf) { const int q = pdb_cnt[blockIdx.x]; \
  if (q < pdb_cap) { PdbStamp* e = pdb_buf + (size_t)q * gridDim.x + blockIdx.x; e->site = (s); \
  e->pre_clk = clock64(); e->pre_ns = pdb_ns(); } } } while (0)
#define PDB_POST(s) do { if (threadIdx.x == 0 && pdb_buf) { const int q = pdb_cnt[blockIdx.x]; \
  if (q < pdb_cap) { PdbStamp* e = pdb_buf + (size_t)q * gridDim.x + blockIdx.x; \
  e->post_ns = pdb_ns(); e->post_clk = clock64(); } pdb_cnt[blockIdx.x] = q + 1; } } while (0)
extern "C" int pdb_stamp_setup(void* buf, void* cnt, int cap) {
  cudaError_t e = cudaMemcpyToSymbol(pdb_buf, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pdb_cnt, &cnt, sizeof(cnt));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pdb_cap, &cap, sizeof(cap));
  return (int)e;
}
"""

SYNC = re.compile(r"\b(\w+)\.sync\(\);")
FUNC = re.compile(r"^(?:__device__|__global__)[^(]*?\b(\w+)\s*\(")
CAP = 8192  # stages recorded per launch
BLOCKS = 256  # blocks recorded per launch (a cooperative grid of #2 / #3 had up to 227)


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return "nvcc"


def barrier_times() -> dict:
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "barriers.cu"), os.path.join(OUT, "libbarriers.so")
    open(src, "w").write(BARRIERS_CU)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    for fn in (so.grid_barrier_ms, so.cluster_barrier_ms):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_float
    n, out = 2000, {}
    for blocks in (37, 102, 132, 141):
        out[f"grid.sync {blocks} x 256"] = 1e3 * so.grid_barrier_ms(blocks, 256, n) / n
    for ctas in (8, 16):
        out[f"cluster.sync {ctas} x 1024"] = 1e3 * so.cluster_barrier_ms(ctas, 1024, n) / n
    for k, v in out.items():
        print(f"barrier {k}: {v:.3f} us" if v > 0 else f"barrier {k}: launch failed", flush=True)
    return out


def stamped_copy(root: str):
    """Copy of root's package, chip_smoke.py and dataset with every
    barrier of csrc/ wrapped in stamps; returns (dir, site labels)."""
    dst = os.path.join(OUT, "copy")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "pdebench_tpu_torch"), os.path.join(dst, "pdebench_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dst, "data"))
    shutil.copy(os.path.join(root, "data", "benchmark_v2.jsonl"), os.path.join(dst, "data"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    csrc = os.path.join(dst, "pdebench_tpu_torch", "csrc")
    labels = []
    for name in sorted(os.listdir(csrc)):
        path = os.path.join(csrc, name)
        lines = open(path).read().split("\n")
        func, ordinal = "?", 0
        for i, line in enumerate(lines):
            m = FUNC.match(line)
            if m:
                # a kernel's name follows its __launch_bounds__ line
                nxt = re.match(r"\s*(\w+)\(", lines[i + 1]) if i + 1 < len(lines) else None
                func = nxt.group(1) if m.group(1) == "__launch_bounds__" and nxt else m.group(1)
                ordinal = 0
            def wrap(mo):
                nonlocal ordinal
                ordinal += 1
                labels.append(f"{func}#{ordinal} ({name}:{i + 1})")
                s = len(labels) - 1
                return f"PDB_PRE({s}); {mo.group(0)} PDB_POST({s});"
            lines[i] = SYNC.sub(wrap, line)
        text = "\n".join(lines)
        if name == "gmg_vcycle.cuh":
            text = text.replace("#pragma once", "#pragma once\n#include <cuda_runtime.h>\n" + STAMPS_CUH, 1)
        open(path, "w").write(text)
    return dst, labels


def summarize(stamps: np.ndarray, counts: np.ndarray, labels) -> dict:
    """Per site: occurrences, wall us (release to release), the slowest
    block's work us, barrier us (wall minus that work)."""
    nst = int(counts.min())
    st = stamps[:nst]  # (stage, block, 8)
    # clock64 ticks per ns, per block, over the launch
    span_ns = st[-1, :, 2] - st[0, :, 1]
    span_clk = st[-1, :, 4] - st[0, :, 3]
    rate = np.where(span_ns > 0, span_clk / np.maximum(span_ns, 1), 1.0)
    out = {}
    for s in range(1, nst):
        site = int(st[s, 0, 0])
        wall = float(np.median(st[s, :, 2] - st[s - 1, :, 2])) / 1e3
        work = float(np.max((st[s, :, 3] - st[s - 1, :, 4]) / rate)) / 1e3
        rec = out.setdefault(labels[site], dict(n=0, wall_us=0.0, work_us=0.0, barrier_us=0.0))
        rec["n"] += 1
        rec["wall_us"] += wall
        rec["work_us"] += work
        rec["barrier_us"] += wall - work
    total = float(np.median(st[-1, :, 2] - st[0, :, 2])) / 1e3
    return dict(stages=nst, stamped_us=total, sites=out)


def run_stages(root: str, kernels) -> dict:
    dst, labels = stamped_copy(root)
    sys.path.insert(0, dst)
    import chip_smoke as cs
    from pdebench_tpu_torch.oracle.navier_stokes import NavierStokesProblem
    from pdebench_tpu_torch.solvers import gmg_fused

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    # stage-major records: stage q of block b at q * blocks + b
    buf = torch.zeros(CAP * BLOCKS * 8, dtype=torch.int64, device=dev)
    cnt = torch.zeros(BLOCKS, dtype=torch.int32, device=dev)

    def stamped(lib, fn, name):
        fn()
        torch.cuda.synchronize()
        plain_ms = cs.median_ms(fn, calls=5, samples=3)
        lib.pdb_stamp_setup.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        code = lib.pdb_stamp_setup(buf.data_ptr(), cnt.data_ptr(), CAP)
        if code != 0:
            raise RuntimeError(f"pdb_stamp_setup: CUDA error {code}")
        cnt.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        lib.pdb_stamp_setup(None, None, 0)
        blocks = int((cnt > 0).sum())
        recs = buf[: CAP * blocks * 8].reshape(CAP, blocks, 8)
        res = summarize(recs.cpu().numpy(), cnt[:blocks].cpu().numpy(), labels)
        res.update(unstamped_ms=plain_ms, blocks=blocks)
        print(f"{name}: {blocks} blocks, {res['stages']} barriers, stamped {res['stamped_us']:.1f} us "
              f"(unstamped {1e3 * plain_ms:.1f} us per call)", flush=True)
        for site, r in sorted(res["sites"].items(), key=lambda kv: -kv[1]["wall_us"]):
            print(f"  {site}: {r['n']} x, wall {r['wall_us']:.1f} us, slowest block's work "
                  f"{r['work_us']:.1f} us, barrier {r['barrier_us']:.1f} us "
                  f"({r['wall_us'] / r['n']:.2f} / {r['work_us'] / r['n']:.2f} / "
                  f"{r['barrier_us'] / r['n']:.2f} us each)", flush=True)
        return res

    out = {}
    cg_cases = ["poisson_basic", "poisson_p3_variable_kappa_mild", "poisson_3d_kappa_expr"]
    rich_cases = ["helmholtz_basic_k5", "helmholtz_3d_k1_trig@12"]
    gmres_cases = ["helmholtz_k12_exponential_mode", "helmholtz_3d_k1_trig"]
    block_cases = ["linear_elasticity_nu010", "linear_elasticity_nu030"]
    cases = cs.load_cases(set(cg_cases + rich_cases + gmres_cases + block_cases + ["navier_stokes_basic"]))
    if "2" in kernels:
        for cid in cg_cases:
            lat, mask = cs.poisson_operator(cases[cid], dev)
            r = cs.lattice_rhs(lat, mask, rng, dev)
            fc = gmg_fused.build_fused_inner_cg(lat.gmg, 25, dev)
            key = f"#2 {cid} 25 PCG steps"
            out[key] = stamped(gmg_fused._lib_cg(), lambda: fc(r), key)
    if "3" in kernels:
        for cid in rich_cases:
            lat, mask, _ = cs.helmholtz_operator(cases[cid], dev)
            r = cs.lattice_rhs(lat, mask, rng, dev)
            rich = gmg_fused.build_fused_richardson(lat.gmg, 2, dev)
            key = f"#3 {cid} 2 V-cycles"
            out[key] = stamped(gmg_fused._lib_cg(), lambda: rich(r), key)
    if "4" in kernels:
        for cid in block_cases:
            lat, mask = cs.elasticity_operator(cases[cid], dev)
            r = cs.lattice_rhs(lat, mask, rng, dev)
            block = gmg_fused.build_fused_block_inner_cg(lat.gmg, 25, dev)
            key = f"#4 {cid} 25 block PCG steps"
            out[key] = stamped(gmg_fused._lib_block_cg(), lambda: block(r), key)
    if "5" in kernels:
        prob = NavierStokesProblem(cases["navier_stokes_basic"], dev)
        x1 = prob.stokes_direct(prob.nu)
        lv = prob.levels(prob.sst.wmapA.weights(prob.jacobian(x1, prob.nu)).float())
        fused = gmg_fused.build_fused_dyn_block_vcycle(prob.spec, 1, dev)
        r = torch.as_tensor(rng.standard_normal(2 * fused.sites), dtype=torch.float32, device=dev)
        out["#5 navier_stokes_basic 1 cycle"] = stamped(gmg_fused._lib_dyn(), lambda: fused(r, lv),
                                                         "#5 navier_stokes_basic 1 cycle")
    if "6" in kernels:
        for cid in gmres_cases:
            lat, mask, W32c = cs.helmholtz_operator(cases[cid], dev)
            rr = cs.lattice_rhs(lat, mask, rng, dev)
            fg = gmg_fused.build_fused_inner_gmres(lat.gmg, 30, dev, lat.offsets)
            out[f"#6 {cid} m=30"] = stamped(gmg_fused._lib_gmres(), lambda: fg.raw(rr, W32c),
                                            f"#6 {cid} m=30")
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose kernels are stamped")
    ap.add_argument("--kernels", default="2,3,4,5,6", help="fused kernels to stamp, of 2, 3, 4, 5, 6")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_stage_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    out = {"root": args.root, "barriers_us": barrier_times(), "stages": run_stages(os.path.abspath(args.root), args.kernels.split(","))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
