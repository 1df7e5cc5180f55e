// Whole block (d = 2) GMG-preconditioned inner solve in one cooperative
// launch, for Hopper (sm_90a): the elasticity analog of gmg_fused_cg.cu.
//
// Replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_block_inner_cg` (pl.pallas_call at :723; kernel body
// `_kernel`, :620-700), 2-D block lattices with two components per site.
// Two modes, one kernel, as in gmg_fused_cg.cu:
//
// mode 0, cg: `iters` PCG steps on a block lattice residual r, writing the
// correction z (the recurrence of gmg_fused_cg.cu, every dot product
// summed over both components);
// mode 1, richardson: z = V(r), then iters - 1 times z += V(r - A0 z)
// (:671-679).
//
// Layout and V: the planar block levels and the block V-cycle of
// gmg_block_vcycle.cuh (shared with kernel #5, gmg_fused_dyn_block.cu),
// whose coarsest level here is the probed one below the GMG's last. The
// wrapper converts the lattice's site-major (ny, nx, 2) vector to planes
// and back, once per call.
//
// What bounds it: latency, as for the scalar kernel. The hierarchy is
// 5.1 MB (linear_elasticity_nu010, 121 x 121 nodes, 19 taps) to 9.6 MB
// (nu030, 161 x 161): it stays in the 50 MB L2, but every stage needs the
// whole previous one. So: one persistent cooperative launch per inner
// solve, a grid-stride loop over lattice sites per stage (each thread does
// both components of its site), grid barriers between stages, the
// coarsest level swept by block 0 alone, double dot partials summed in a
// fixed order (deterministic, no atomics), __ldcg on vectors written in
// the kernel.

#include "gmg_block_vcycle.cuh"

namespace {

constexpr int kModeCG = 0;
constexpr int kModeRichardson = 1;

struct Hier {
  Level lv[kMaxLevels];  // block levels: W, D, r, x, t as described above
  float* p;              // CG search direction (2, ny, nx), fine level
  float* Ap;             // A0 p
  double* partial;       // 2 * gridDim.x block partials of the two dots
  int nlev;
};

// V-cycle on H.lv[0].r, with H.lv[0].x = D0 r already set; result in
// H.lv[0].t, and this block's partial of <r, t> (both components) in
// partial_rs[blockIdx.x]
__device__ void vcycle2(const Hier& H, cg::grid_group& grid, double* sh,
                        double* partial_rs) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const Level& L0 = H.lv[0];
  const int n0 = L0.ny * L0.nx;
  vcycle2_to_fine(H.lv, H.nlev, grid);
  double acc = 0.0;
  for (int idx = tid; idx < n0; idx += stride) {
    float v0, v1;
    smooth2_at(L0, idx, v0, v1);
    L0.t[idx] = v0;
    L0.t[n0 + idx] = v1;
    acc += (double)ldw(L0.r + idx) * (double)v0 +
           (double)ldw(L0.r + n0 + idx) * (double)v1;
  }
  put_partial(acc, partial_rs, sh);
  grid.sync();
}

__global__ void __launch_bounds__(kThreads)
gmg_fused_block_cg_kernel(const Hier* __restrict__ desc, const float* r_in,
                          float* z, int iters, int mode) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Hier H;
  __shared__ double sh[33];
  {
    const int* src = reinterpret_cast<const int*>(desc);
    int* dst = reinterpret_cast<int*>(&H);
    for (int i = threadIdx.x; i < (int)(sizeof(Hier) / sizeof(int));
         i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();

  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const Level& L0 = H.lv[0];
  const int n0 = L0.ny * L0.nx;
  double* part_pAp = H.partial;
  double* part_rs = H.partial + gridDim.x;

  if (mode == kModeRichardson) {
    // z = V(r); then iters - 1 times z += V(r - A0 z)
    for (int idx = tid; idx < n0; idx += stride)
      set_rhs2(L0, idx, r_in[idx], r_in[n0 + idx]);
    grid.sync();
    for (int c = 0; c < iters - 1; ++c) {
      vcycle2_to_fine(H.lv, H.nlev, grid);
      for (int idx = tid; idx < n0; idx += stride) {
        float s0, s1;
        smooth2_at(L0, idx, s0, s1);
        z[idx] = c == 0 ? s0 : ldw(z + idx) + s0;
        z[n0 + idx] = c == 0 ? s1 : ldw(z + n0 + idx) + s1;
      }
      grid.sync();
      for (int idx = tid; idx < n0; idx += stride) {
        const int i = idx / L0.nx, j = idx - (idx / L0.nx) * L0.nx;
        float a0, a1;
        apply2_at(L0, z, i, j, a0, a1);
        set_rhs2(L0, idx, r_in[idx] - a0, r_in[n0 + idx] - a1);
      }
      grid.sync();
    }
    vcycle2_to_fine(H.lv, H.nlev, grid);
    for (int idx = tid; idx < n0; idx += stride) {
      float s0, s1;
      smooth2_at(L0, idx, s0, s1);
      z[idx] = iters > 1 ? ldw(z + idx) + s0 : s0;
      z[n0 + idx] = iters > 1 ? ldw(z + n0 + idx) + s1 : s1;
    }
    return;
  }

  for (int idx = tid; idx < n0; idx += stride) {
    set_rhs2(L0, idx, r_in[idx], r_in[n0 + idx]);
    z[idx] = 0.f;
    z[n0 + idx] = 0.f;
  }
  grid.sync();
  vcycle2(H, grid, sh, part_rs);
  double rz = grid_total(part_rs, sh);
  for (int idx = tid; idx < 2 * n0; idx += stride) H.p[idx] = ldw(L0.t + idx);
  grid.sync();

  for (int it = 0; it < iters; ++it) {
    double acc = 0.0;
    for (int idx = tid; idx < n0; idx += stride) {
      const int i = idx / L0.nx, j = idx - (idx / L0.nx) * L0.nx;
      float ap0, ap1;
      apply2_at(L0, H.p, i, j, ap0, ap1);
      H.Ap[idx] = ap0;
      H.Ap[n0 + idx] = ap1;
      acc += (double)ldw(H.p + idx) * (double)ap0 +
             (double)ldw(H.p + n0 + idx) * (double)ap1;
    }
    put_partial(acc, part_pAp, sh);
    grid.sync();
    const double denom = grid_total(part_pAp, sh);
    const float alpha = (float)(rz / (fabs(denom) > 0.0 ? denom : 1.0));
    for (int idx = tid; idx < n0; idx += stride) {
      z[idx] = z[idx] + alpha * ldw(H.p + idx);
      z[n0 + idx] = z[n0 + idx] + alpha * ldw(H.p + n0 + idx);
      set_rhs2(L0, idx, ldw(L0.r + idx) - alpha * ldw(H.Ap + idx),
               ldw(L0.r + n0 + idx) - alpha * ldw(H.Ap + n0 + idx));
    }
    grid.sync();
    vcycle2(H, grid, sh, part_rs);
    const double rz_new = grid_total(part_rs, sh);
    const float beta = (float)(rz_new / (fabs(rz) > 0.0 ? rz : 1.0));
    for (int idx = tid; idx < 2 * n0; idx += stride)
      H.p[idx] = ldw(L0.t + idx) + beta * ldw(H.p + idx);
    grid.sync();
    rz = rz_new;
  }
}

}  // namespace

extern "C" {

int gmg_fused_block_cg_desc_bytes() { return (int)sizeof(Hier); }

// Blocks of the cooperative grid for a fine level of `fine_points` sites.
int gmg_fused_block_cg_grid(int fine_points, int* blocks) {
  return coop_grid(gmg_fused_block_cg_kernel, fine_points, blocks);
}

// Fill a host buffer of gmg_fused_block_cg_desc_bytes() bytes with the
// block level descriptors (ptrs, dims, offs as pack_levels takes them; W,
// D and the work vectors in the block layout above) and the CG work
// vectors.
int gmg_fused_block_cg_pack(void* out, int nlev, const long long* ptrs,
                            const int* dims, const int* offs, long long p,
                            long long Ap, long long partial) {
  Hier* H = static_cast<Hier*>(out);
  *H = Hier{};
  const int e = pack_levels(H->lv, nlev, ptrs, dims, offs);
  if (e != 0) return e;
  for (int l = 0; l < nlev; ++l)  // 2-D block levels only
    if (H->lv[l].nz != 1) return (int)cudaErrorInvalidValue;
  H->p = reinterpret_cast<float*>(p);
  H->Ap = reinterpret_cast<float*>(Ap);
  H->partial = reinterpret_cast<double*>(partial);
  H->nlev = nlev;
  return 0;
}

// One inner solve on r (2, ny, nx): mode 0 (cg) runs `iters` block
// GMG-PCG steps, mode 1 (richardson) a chain of `iters` block V-cycles.
// desc: the packed descriptor in device memory; blocks from
// gmg_fused_block_cg_grid.
int gmg_fused_block_cg_launch(const void* desc, const float* r, float* z,
                              int iters, int mode, int blocks, void* stream) {
  if (mode != kModeCG && mode != kModeRichardson)
    return (int)cudaErrorInvalidValue;
  if (mode == kModeRichardson && iters < 1) return (int)cudaErrorInvalidValue;
  const Hier* d = static_cast<const Hier*>(desc);
  void* args[] = {(void*)&d, (void*)&r, (void*)&z, (void*)&iters,
                  (void*)&mode};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gmg_fused_block_cg_kernel, dim3(blocks), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
