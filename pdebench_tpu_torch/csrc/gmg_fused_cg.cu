// Whole GMG-preconditioned inner CG solve in one cooperative launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel pdebench_tpu/solvers/gmg_fused.py
// (`build_fused_inner_cg`, mode "cg": kernel body `_kernel`, hierarchy from
// `_scalar_hierarchy`), 2-D scalar lattices. It runs `iters` PCG steps in
// float on a lattice residual r and writes the correction z:
//
//   z = 0, res = r, p = s = V(res), rz = <res, s>
//   repeat iters times:
//     Ap = A0 p;  alpha = rz / <p, Ap>     (denominator 1 where it is 0)
//     z += alpha p;  res -= alpha Ap
//     s = V(res);  rz' = <res, s>;  beta = rz' / rz  (1 where rz is 0)
//     p = s + beta p;  rz = rz'
//
// V is one multigrid V-cycle over the levels 0..L-1 (level l+1 halves
// level l, (n - 1) / 2 + 1 points per axis): at level l < L-1,
// x = D r; t = r - A x; r_c = R t; V at l+1; x += P x_c;
// x = x + D (r - A x). The coarsest level takes x = D r followed by
// COARSE_SWEEPS - 1 Jacobi sweeps x += D (r - A x). D holds omega times
// the inverse diagonal. Stencil taps read zero outside the level (the
// Pallas kernel's rolls over zero pads). R is the tensor product of the
// truncated [1/4, 1/2, 1/4] band at even fine points and P its bilinear
// transpose (the Pallas banded matmuls), here as direct 3 x 3 stencils.
//
// What bounds it: latency, not bandwidth or arithmetic. The hierarchy
// (weights and diagonals) of a 121 x 121 P1 lattice is 0.7 MB and of a
// 241 x 241 P3 one 10.7 MB: it stays in the 50 MB L2 across all PCG
// steps, but no SM can hold it, and every stage of a V-cycle needs the
// whole previous stage. So the design is one persistent cooperative
// launch per inner solve (the shape of the Pallas kernel: one launch,
// everything resident), a grid-stride loop per stage and a grid-wide
// barrier between stages (16 barriers per PCG step on a 4-level
// hierarchy). The coarsest level (16 x 16 here) is swept by one
// block with block barriers only. Dot products reduce in double: one
// partial per block, then every block sums the partials in the same fixed
// order after the barrier, so the result is deterministic and no atomics
// are used. Work vectors written inside the kernel are read with __ldcg
// (through L2) so that no block reads a stale L1 line after a barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 64;
constexpr int kThreads = 256;
constexpr int kCoarseSweeps = 10;  // COARSE_SWEEPS of the Pallas kernel

struct Level {
  const float* W;  // (K, ny, nx) stencil weights
  const float* D;  // (ny, nx) omega * inverse diagonal
  float* r;        // level right-hand side; level 0: the CG residual
  float* x;        // smoother iterate
  float* t;        // scratch; holds the level's V-cycle result at the end
  int ny, nx, K;
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
};

struct Hier {
  Level lv[kMaxLevels];
  float* p;         // CG search direction, fine level
  float* Ap;        // A0 p
  double* partial;  // 2 * gridDim.x block partials of the two dots
  int nlev;
};

__device__ __forceinline__ float ldw(const float* a) { return __ldcg(a); }

__device__ __forceinline__ float apply_at(const Level& L, const float* u,
                                          int i, int j) {
  const int n = L.ny * L.nx;
  const int idx = i * L.nx + j;
  float acc = 0.f;
  for (int k = 0; k < L.K; ++k) {
    const int ii = i + L.dy[k], jj = j + L.dx[k];
    if (ii >= 0 && ii < L.ny && jj >= 0 && jj < L.nx)
      acc += __ldg(L.W + k * n + idx) * ldw(u + ii * L.nx + jj);
  }
  return acc;
}

// full weighting at fine point (2ic, 2jc), zero outside the fine level;
// summed along x first, then y (the Pallas By @ (res @ Bx^T) order)
__device__ __forceinline__ float restrict_at(const Level& F, const float* t,
                                             int ic, int jc) {
  const float w[3] = {0.25f, 0.5f, 0.25f};
  float acc = 0.f;
  for (int a = -1; a <= 1; ++a) {
    const int i = 2 * ic + a;
    if (i < 0 || i >= F.ny) continue;
    float row = 0.f;
    for (int b = -1; b <= 1; ++b) {
      const int j = 2 * jc + b;
      if (j < 0 || j >= F.nx) continue;
      row += w[b + 1] * ldw(t + i * F.nx + j);
    }
    acc += w[a + 1] * row;
  }
  return acc;
}

// bilinear interpolation of the coarse field at fine point (i, j)
__device__ __forceinline__ float prolong_at(const Level& C, const float* xc,
                                            int i, int j) {
  int ci[2], cj[2];
  float wi[2], wj[2];
  int ni, nj;
  if (i % 2 == 0) { ci[0] = i / 2; wi[0] = 1.f; ni = 1; }
  else { ci[0] = (i - 1) / 2; ci[1] = (i + 1) / 2; wi[0] = wi[1] = 0.5f; ni = 2; }
  if (j % 2 == 0) { cj[0] = j / 2; wj[0] = 1.f; nj = 1; }
  else { cj[0] = (j - 1) / 2; cj[1] = (j + 1) / 2; wj[0] = wj[1] = 0.5f; nj = 2; }
  float acc = 0.f;
  for (int a = 0; a < ni; ++a) {
    if (ci[a] >= C.ny) continue;
    float row = 0.f;
    for (int b = 0; b < nj; ++b) {
      if (cj[b] >= C.nx) continue;
      row += wj[b] * ldw(xc + ci[a] * C.nx + cj[b]);
    }
    acc += wi[a] * row;
  }
  return acc;
}

// block sum of v, valid in thread 0; sh holds at least 32 doubles
__device__ double block_sum(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;
}

// after a grid barrier: the sum of the gridDim.x partials, in a fixed
// order, identical in every block; sh[32] is the broadcast slot
__device__ double grid_total(const double* partial, double* sh) {
  if (threadIdx.x < 32) {
    double s = 0.0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32)
      s += __ldcg(partial + b);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) sh[32] = s;
  }
  __syncthreads();
  const double total = sh[32];
  __syncthreads();
  return total;
}

// V-cycle on H.lv[0].r, with H.lv[0].x = D0 r already set; result in
// H.lv[0].t, and this block's partial of <r, t> in partial_rs[blockIdx.x]
__device__ void vcycle(const Hier& H, cg::grid_group& grid, double* sh,
                       double* partial_rs) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int nlev = H.nlev;
  for (int l = 0; l < nlev - 1; ++l) {
    const Level& F = H.lv[l];
    const Level& C = H.lv[l + 1];
    const int nf = F.ny * F.nx, nc = C.ny * C.nx;
    for (int idx = tid; idx < nf; idx += stride) {
      const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
      F.t[idx] = ldw(F.r + idx) - apply_at(F, F.x, i, j);
    }
    grid.sync();
    for (int idx = tid; idx < nc; idx += stride) {
      const int i = idx / C.nx, j = idx - (idx / C.nx) * C.nx;
      const float rc = restrict_at(F, F.t, i, j);
      C.r[idx] = rc;
      C.x[idx] = __ldg(C.D + idx) * rc;
    }
    grid.sync();
  }
  {
    // coarsest level: one block, block barriers between Jacobi sweeps
    const Level& C = H.lv[nlev - 1];
    if (blockIdx.x == 0) {
      const int n = C.ny * C.nx;
      float* src = C.x;
      float* dst = C.t;
      for (int s = 0; s < kCoarseSweeps - 1; ++s) {
        for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
          const int i = idx / C.nx, j = idx - (idx / C.nx) * C.nx;
          dst[idx] = ldw(src + idx) + __ldg(C.D + idx) *
                     (ldw(C.r + idx) - apply_at(C, src, i, j));
        }
        __syncthreads();
        float* tmp = src; src = dst; dst = tmp;
      }
      if (src != C.t) {
        for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
          C.t[idx] = ldw(src + idx);
      }
    }
    grid.sync();
  }
  for (int l = nlev - 2; l >= 0; --l) {
    const Level& F = H.lv[l];
    const Level& C = H.lv[l + 1];
    const int nf = F.ny * F.nx;
    for (int idx = tid; idx < nf; idx += stride) {
      const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
      F.x[idx] = ldw(F.x + idx) + prolong_at(C, C.t, i, j);
    }
    grid.sync();
    double acc = 0.0;
    for (int idx = tid; idx < nf; idx += stride) {
      const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
      const float r = ldw(F.r + idx);
      const float x = ldw(F.x + idx);
      const float v = x + __ldg(F.D + idx) * (r - apply_at(F, F.x, i, j));
      F.t[idx] = v;
      if (l == 0) acc += (double)r * (double)v;
    }
    if (l == 0) {
      const double s = block_sum(acc, sh);
      if (threadIdx.x == 0) partial_rs[blockIdx.x] = s;
    }
    grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads)
gmg_fused_cg_kernel(const Hier* __restrict__ desc, const float* r_in,
                    float* z, int iters) {
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
      const int i = idx / L0.nx, j = idx - (idx / L0.nx) * L0.nx;
      const float ap = apply_at(L0, H.p, i, j);
      H.Ap[idx] = ap;
      acc += (double)ldw(H.p + idx) * (double)ap;
    }
    {
      const double s = block_sum(acc, sh);
      if (threadIdx.x == 0) part_pAp[blockIdx.x] = s;
    }
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

// Blocks of the cooperative grid for a fine level of `fine_points`: as
// many as can be co-resident on the device, and no more than the fine
// level has work for. Returns a cudaError_t.
int gmg_fused_cg_grid(int fine_points, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gmg_fused_cg_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int resident = per_sm * sms;
  const int needed = (fine_points + kThreads - 1) / kThreads;
  *blocks = needed < resident ? needed : resident;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Fill a host buffer of gmg_fused_cg_desc_bytes() bytes with the level
// descriptors. ptrs: 5 device pointers per level (W, D, r, x, t); dims: 3
// ints per level (ny, nx, K); offs: 2 * K ints per level, (dy, dx) per
// tap, levels concatenated.
int gmg_fused_cg_pack(void* out, int nlev, const long long* ptrs,
                      const int* dims, const int* offs, long long p,
                      long long Ap, long long partial) {
  // at least two levels: the fine level's dot with the V-cycle result
  // is taken in its post-smoothing stage
  if (nlev < 2 || nlev > kMaxLevels) return (int)cudaErrorInvalidValue;
  Hier* H = static_cast<Hier*>(out);
  *H = Hier{};
  int o = 0;
  for (int l = 0; l < nlev; ++l) {
    Level& L = H->lv[l];
    L.W = reinterpret_cast<const float*>(ptrs[5 * l + 0]);
    L.D = reinterpret_cast<const float*>(ptrs[5 * l + 1]);
    L.r = reinterpret_cast<float*>(ptrs[5 * l + 2]);
    L.x = reinterpret_cast<float*>(ptrs[5 * l + 3]);
    L.t = reinterpret_cast<float*>(ptrs[5 * l + 4]);
    L.ny = dims[3 * l + 0];
    L.nx = dims[3 * l + 1];
    L.K = dims[3 * l + 2];
    if (L.ny < 1 || L.nx < 1 || L.K < 0 || L.K > kMaxTaps)
      return (int)cudaErrorInvalidValue;
    if (l > 0 && (L.ny != (H->lv[l - 1].ny - 1) / 2 + 1 ||
                  L.nx != (H->lv[l - 1].nx - 1) / 2 + 1))
      return (int)cudaErrorInvalidValue;
    for (int k = 0; k < L.K; ++k, ++o) {
      const int dy = offs[2 * o], dx = offs[2 * o + 1];
      if (dy < -127 || dy > 127 || dx < -127 || dx > 127)
        return (int)cudaErrorInvalidValue;
      L.dy[k] = (signed char)dy;
      L.dx[k] = (signed char)dx;
    }
  }
  H->p = reinterpret_cast<float*>(p);
  H->Ap = reinterpret_cast<float*>(Ap);
  H->partial = reinterpret_cast<double*>(partial);
  H->nlev = nlev;
  return 0;
}

// One inner solve: z = `iters` GMG-PCG steps on r. desc: the packed
// descriptor in device memory; blocks from gmg_fused_cg_grid.
int gmg_fused_cg_launch(const void* desc, const float* r, float* z,
                        int iters, int blocks, void* stream) {
  const Hier* d = static_cast<const Hier*>(desc);
  void* args[] = {(void*)&d, (void*)&r, (void*)&z, (void*)&iters};
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
