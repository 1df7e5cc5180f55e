// Whole GMG-preconditioned inner solve in one cooperative launch, for
// Hopper (sm_90a). Two modes, one kernel:
//
// mode 0, cg: replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// `build_fused_inner_cg` (mode "cg", pl.pallas_call at :434; kernel body
// `_kernel`, hierarchy from `_scalar_hierarchy`), 2-D and 3-D scalar
// lattices (the 3-D form: the slab-packed `_Level3` levels, :110-168). It
// runs `iters` PCG steps in float on a lattice residual r and writes the
// correction z:
//
//   z = 0, res = r, p = s = V(res), rz = <res, s>
//   repeat iters times:
//     Ap = A0 p;  alpha = rz / <p, Ap>     (denominator 1 where it is 0)
//     z += alpha p;  res -= alpha Ap
//     s = V(res);  rz' = <res, s>;  beta = rz' / rz  (1 where rz is 0)
//     p = s + beta p;  rz = rz'
//
// mode 1, richardson: replaces the same pl.pallas_call in mode
// "richardson" (`build_fused_richardson`, gmg_fused.py:461-472; body
// :378-384): a chain of `iters` V-cycles, z = V(r), then iters - 1 times
// z += V(r - A0 z), with A0 the hierarchy's level 0. Linear in r, so it
// preconditions the non-flexible GMRES inner of the refinement.
//
// V is one multigrid V-cycle over the hierarchy (gmg_vcycle.cuh).
//
// What bounds it: latency, not bandwidth or arithmetic. The hierarchy
// (weights and diagonals) of a 121 x 121 P1 lattice is 0.7 MB and of a
// 241 x 241 P3 one 10.7 MB: it stays in the 50 MB L2 across all steps,
// but no SM can hold it, and every stage of a V-cycle needs the whole
// previous stage. So the design is one persistent cooperative launch per
// inner solve or preconditioner apply (the shape of the Pallas kernel:
// one launch, everything resident), a grid-stride loop per stage and a
// grid-wide barrier between stages (16 barriers per PCG step and 13 per
// V-cycle on a 4-level hierarchy). The coarsest level (16 x 16 here) is
// swept by one block with block barriers only. Dot products reduce in
// double: one partial per block, then every block sums the partials in
// the same fixed order after the barrier, so the result is deterministic
// and no atomics are used. Work vectors written inside the kernel are
// read with __ldcg (through L2) so that no block reads a stale L1 line
// after a barrier.
//
// 3-D lattices (unit_cube P2: 29^3 to 49^3 sites, 65 fine taps) keep the
// same design with native (z, y, x) levels. There a fine-level stage is
// not only a barrier: a 33^3 fine apply reads 9.3 MB of weights (2.3 M
// multiply-adds), so the fine stages are bound by L2 bytes, three fine
// applies per PCG step, while the coarse stages stay latency-bound.

#include "gmg_vcycle.cuh"

namespace {

constexpr int kModeCG = 0;
constexpr int kModeRichardson = 1;

struct Hier {
  Level lv[kMaxLevels];
  float* p;         // CG search direction, fine level
  float* Ap;        // A0 p
  double* partial;  // 2 * gridDim.x block partials of the two dots
  int nlev;
};

// V-cycle on H.lv[0].r, with H.lv[0].x = D0 r already set; result in
// H.lv[0].t, and this block's partial of <r, t> in partial_rs[blockIdx.x]
__device__ void vcycle(const Hier& H, cg::grid_group& grid, double* sh,
                       double* partial_rs) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const Level& L0 = H.lv[0];
  const int n0 = sites(L0);
  vcycle_to_fine(H.lv, H.nlev, grid);
  double acc = 0.0;
  for (int idx = tid; idx < n0; idx += stride) {
    const float v = smooth_at(L0, idx);
    L0.t[idx] = v;
    acc += (double)ldw(L0.r + idx) * (double)v;
  }
  put_partial(acc, partial_rs, sh);
  grid.sync();
}

__global__ void __launch_bounds__(kThreads)
gmg_fused_cg_kernel(const Hier* __restrict__ desc, const float* r_in,
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
  const int n0 = sites(L0);
  double* part_pAp = H.partial;
  double* part_rs = H.partial + gridDim.x;

  if (mode == kModeRichardson) {
    // z = V(r); then iters - 1 times z += V(r - A0 z)
    for (int idx = tid; idx < n0; idx += stride) {
      const float rv = r_in[idx];
      L0.r[idx] = rv;
      L0.x[idx] = __ldg(L0.D + idx) * rv;
    }
    grid.sync();
    chain_to_last(H.lv, H.nlev, r_in, z, iters, grid);
    for (int idx = tid; idx < n0; idx += stride)
      z[idx] = chain_result_at(L0, z, idx, iters);
    return;
  }

  for (int idx = tid; idx < n0; idx += stride) {
    const float rv = r_in[idx];
    L0.r[idx] = rv;
    z[idx] = 0.f;
    L0.x[idx] = __ldg(L0.D + idx) * rv;
  }
  grid.sync();
  vcycle(H, grid, sh, part_rs);
  double rz = grid_total(part_rs, sh);
  for (int idx = tid; idx < n0; idx += stride) H.p[idx] = ldw(L0.t + idx);
  grid.sync();

  for (int it = 0; it < iters; ++it) {
    double acc = 0.0;
    for (int idx = tid; idx < n0; idx += stride) {
      const float ap = apply_at(L0, H.p, idx);
      H.Ap[idx] = ap;
      acc += (double)ldw(H.p + idx) * (double)ap;
    }
    put_partial(acc, part_pAp, sh);
    grid.sync();
    const double denom = grid_total(part_pAp, sh);
    const float alpha = (float)(rz / (fabs(denom) > 0.0 ? denom : 1.0));
    for (int idx = tid; idx < n0; idx += stride) {
      const float p = ldw(H.p + idx);
      z[idx] = z[idx] + alpha * p;
      const float rv = ldw(L0.r + idx) - alpha * ldw(H.Ap + idx);
      L0.r[idx] = rv;
      L0.x[idx] = __ldg(L0.D + idx) * rv;
    }
    grid.sync();
    vcycle(H, grid, sh, part_rs);
    const double rz_new = grid_total(part_rs, sh);
    const float beta = (float)(rz_new / (fabs(rz) > 0.0 ? rz : 1.0));
    for (int idx = tid; idx < n0; idx += stride)
      H.p[idx] = ldw(L0.t + idx) + beta * ldw(H.p + idx);
    grid.sync();
    rz = rz_new;
  }
}

}  // namespace

extern "C" {

int gmg_fused_cg_desc_bytes() { return (int)sizeof(Hier); }

// Blocks of the cooperative grid for a fine level of `fine_points`.
int gmg_fused_cg_grid(int fine_points, int* blocks) {
  return coop_grid(gmg_fused_cg_kernel, fine_points, blocks);
}

// Fill a host buffer of gmg_fused_cg_desc_bytes() bytes with the level
// descriptors (ptrs, dims, offs as pack_levels takes them) and the CG
// work vectors.
int gmg_fused_cg_pack(void* out, int nlev, const long long* ptrs,
                      const int* dims, const int* offs, long long p,
                      long long Ap, long long partial) {
  Hier* H = static_cast<Hier*>(out);
  *H = Hier{};
  const int e = pack_levels(H->lv, nlev, ptrs, dims, offs);
  if (e != 0) return e;
  H->p = reinterpret_cast<float*>(p);
  H->Ap = reinterpret_cast<float*>(Ap);
  H->partial = reinterpret_cast<double*>(partial);
  H->nlev = nlev;
  return 0;
}

// One inner solve on r: mode 0 (cg) runs `iters` GMG-PCG steps, mode 1
// (richardson) a chain of `iters` V-cycles. desc: the packed descriptor in
// device memory; blocks from gmg_fused_cg_grid.
int gmg_fused_cg_launch(const void* desc, const float* r, float* z,
                        int iters, int mode, int blocks, void* stream) {
  if (mode != kModeCG && mode != kModeRichardson)
    return (int)cudaErrorInvalidValue;
  if (mode == kModeRichardson && iters < 1) return (int)cudaErrorInvalidValue;
  const Hier* d = static_cast<const Hier*>(desc);
  void* args[] = {(void*)&d, (void*)&r, (void*)&z, (void*)&iters,
                  (void*)&mode};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gmg_fused_cg_kernel, dim3(blocks), dim3(kThreads), args,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* pdb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
