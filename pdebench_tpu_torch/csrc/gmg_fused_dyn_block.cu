// Richardson chain of block (d = 2) V-cycles on a hierarchy whose weights
// are the call's tensors, in one cooperative launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_dyn_block_vcycle` (pl.pallas_call at :934; kernel body
// `_kernel`, :851-907): the velocity-block preconditioner of the
// Navier-Stokes Newton saddle FGMRES, on the hierarchy Galerkin-coarsened
// from each Newton step's convected Jacobian (gmg_dyn.build_levels).
//
//   z = V(r), then cycles - 1 times z += V(r - A0 z)
//
// V is the block V-cycle of gmg_block_vcycle.cuh on the spec's levels
// (pure halving, 2-D); its coarsest level is the spec's last, swept
// kCoarseSweeps times (no probed extra level, unlike kernels #2 and #4).
// D carries the level's omega. A tap outside a level reads zero (the
// Pallas kernel's rolls over zero-padded planes; here bounds checks).
//
// What differs from kernel #4's Richardson mode: every level's W (K, 2,
// 2, ny, nx) and D (2, 2, ny, nx) change at every Newton step, so the
// descriptor (level pointers, shapes, taps) is packed once per weight set
// (per build_levels), not per hierarchy, and the wrapper keeps it with the
// tensors it points at. r and z are read and written in the lattice's
// site-major (ny, nx, 2) layout inside the first and last stages, so a
// call makes no layout copies; the chain's running sum lives in a planar
// work vector. A one-level spec (a fine level at or below the spec's
// coarse size) is the coarsest sweeps alone.
//
// What bounds it: latency, as for kernel #4. navier_stokes_basic's
// hierarchy (97/49/25/13, 19 fine taps, 25 coarse) is ~4 MB and stays in
// the 50 MB L2, but each of the ~13 stages of a V-cycle needs the whole
// previous one. So: one persistent cooperative launch per call, a
// grid-stride loop over lattice sites per stage (one thread per site, both
// components), grid barriers between stages, the coarsest level swept by
// block 0 alone, __ldcg on vectors written in the kernel.

#include "gmg_block_vcycle.cuh"

namespace {

struct DynHier {
  Level lv[kMaxLevels];  // block levels: the call's W and D, work r, x, t
  float* zp;             // the chain's running sum, planar (2, ny, nx)
  int nlev;
};

// The V-cycle of H.lv[0].r (with H.lv[0].x = D0 r set) at fine site idx,
// after vcycle2_to_fine: the post-smoothed value, or on a one-level
// hierarchy the coarsest sweeps' result
__device__ __forceinline__ void vcycle_at(const DynHier& H, int idx,
                                          float& v0, float& v1) {
  const Level& L0 = H.lv[0];
  if (H.nlev == 1) {
    const int n = L0.ny * L0.nx;
    v0 = ldw(L0.t + idx);
    v1 = ldw(L0.t + n + idx);
  } else {
    smooth2_at(L0, idx, v0, v1);
  }
}

__global__ void __launch_bounds__(kThreads)
gmg_fused_dyn_block_kernel(const DynHier* __restrict__ desc,
                           const float* __restrict__ r_in, float* z,
                           int cycles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ DynHier H;
  {
    const int* src = reinterpret_cast<const int*>(desc);
    int* dst = reinterpret_cast<int*>(&H);
    for (int i = threadIdx.x; i < (int)(sizeof(DynHier) / sizeof(int));
         i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();

  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const Level& L0 = H.lv[0];
  const int n0 = L0.ny * L0.nx;
  float* zp = H.zp;

  // r (site-major) -> level 0's planar rhs, x = D0 r
  for (int idx = tid; idx < n0; idx += stride)
    set_rhs2(L0, idx, r_in[2 * idx], r_in[2 * idx + 1]);
  grid.sync();
  for (int c = 0; c < cycles - 1; ++c) {
    vcycle2_to_fine(H.lv, H.nlev, grid);
    for (int idx = tid; idx < n0; idx += stride) {
      float s0, s1;
      vcycle_at(H, idx, s0, s1);
      zp[idx] = c == 0 ? s0 : ldw(zp + idx) + s0;
      zp[n0 + idx] = c == 0 ? s1 : ldw(zp + n0 + idx) + s1;
    }
    grid.sync();
    for (int idx = tid; idx < n0; idx += stride) {
      const int i = idx / L0.nx, j = idx - (idx / L0.nx) * L0.nx;
      float a0, a1;
      apply2_at(L0, zp, i, j, a0, a1);
      set_rhs2(L0, idx, r_in[2 * idx] - a0, r_in[2 * idx + 1] - a1);
    }
    grid.sync();
  }
  vcycle2_to_fine(H.lv, H.nlev, grid);
  for (int idx = tid; idx < n0; idx += stride) {
    float s0, s1;
    vcycle_at(H, idx, s0, s1);
    z[2 * idx] = cycles > 1 ? ldw(zp + idx) + s0 : s0;
    z[2 * idx + 1] = cycles > 1 ? ldw(zp + n0 + idx) + s1 : s1;
  }
}

}  // namespace

extern "C" {

int gmg_fused_dyn_block_desc_bytes() { return (int)sizeof(DynHier); }

// Blocks of the cooperative grid for a fine level of `fine_points` sites.
int gmg_fused_dyn_block_grid(int fine_points, int* blocks) {
  return coop_grid(gmg_fused_dyn_block_kernel, fine_points, blocks);
}

// Fill a host buffer of gmg_fused_dyn_block_desc_bytes() bytes with the
// block level descriptors of one weight set (ptrs, dims, offs as
// pack_levels takes them: W and D the set's planar tensors, r, x, t work
// vectors (2, ny, nx)) and the chain's planar running sum zp. One level
// or more, 2-D.
int gmg_fused_dyn_block_pack(void* out, int nlev, const long long* ptrs,
                             const int* dims, const int* offs, long long zp) {
  DynHier* H = static_cast<DynHier*>(out);
  *H = DynHier{};
  const int e = pack_levels(H->lv, nlev, ptrs, dims, offs, 1);
  if (e != 0) return e;
  for (int l = 0; l < nlev; ++l)  // 2-D block levels only
    if (H->lv[l].nz != 1) return (int)cudaErrorInvalidValue;
  H->zp = reinterpret_cast<float*>(zp);
  H->nlev = nlev;
  return 0;
}

// z = the chain of `cycles` block V-cycles on r; r and z (ny, nx, 2)
// site-major. desc: a packed descriptor in device memory; blocks from
// gmg_fused_dyn_block_grid.
int gmg_fused_dyn_block_launch(const void* desc, const float* r, float* z,
                               int cycles, int blocks, void* stream) {
  if (cycles < 1) return (int)cudaErrorInvalidValue;
  const DynHier* d = static_cast<const DynHier*>(desc);
  void* args[] = {(void*)&d, (void*)&r, (void*)&z, (void*)&cycles};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gmg_fused_dyn_block_kernel, dim3(blocks), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
