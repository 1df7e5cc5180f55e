// Multigrid V-cycle device code shared by the fused GMG kernels
// (gmg_fused_cg.cu, gmg_fused_gmres.cu), for Hopper (sm_90a).
//
// A hierarchy is levels 0..L-1 of a 2-D scalar lattice; level l+1 halves
// level l ((n - 1) / 2 + 1 points per axis). One V-cycle on the level-0
// right-hand side r, with x = D r already set, is: at level l < L-1,
// t = r - A x; r_c = R t; V at l+1; x += P x_c; x = x + D (r - A x). The
// coarsest level takes x = D r followed by COARSE_SWEEPS - 1 Jacobi
// sweeps x += D (r - A x). D holds omega times the inverse diagonal.
// Stencil taps read zero outside the level (the Pallas kernels' rolls over
// zero pads). R is the tensor product of the truncated [1/4, 1/2, 1/4]
// band at even fine points and P its bilinear transpose (the Pallas
// banded matmuls), here as direct 3 x 3 stencils.
//
// Every function here runs inside a cooperative launch: a grid-stride
// loop per stage, grid.sync() between stages. Work vectors written in the
// kernel are read with __ldcg (through L2), so that no block reads a
// stale L1 line after a barrier. The coarsest level is swept by block 0
// alone, with block barriers only.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 64;
constexpr int kThreads = 256;
constexpr int kCoarseSweeps = 10;  // COARSE_SWEEPS of the Pallas kernels

struct Level {
  const float* W;  // (K, ny, nx) stencil weights
  const float* D;  // (ny, nx) omega * inverse diagonal
  float* r;        // level right-hand side
  float* x;        // smoother iterate
  float* t;        // scratch; holds the level's V-cycle result (l > 0)
  int ny, nx, K;
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
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

// post-smoothing value x + D (r - A x) at point idx of level F
__device__ __forceinline__ float smooth_at(const Level& F, int idx) {
  const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
  const float r = ldw(F.r + idx);
  const float x = ldw(F.x + idx);
  return x + __ldg(F.D + idx) * (r - apply_at(F, F.x, i, j));
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

// this block's partial of a dot product into partial[blockIdx.x]
__device__ __forceinline__ void put_partial(double acc, double* partial,
                                            double* sh) {
  const double s = block_sum(acc, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// after a grid barrier: the sum of the gridDim.x partials, in a fixed
// order, identical in every block; sh[32] is the broadcast slot. A partial
// buffer read here must not be written again in the same stage: dots of
// consecutive stages use alternating buffers.
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

// One V-cycle on lv[0].r, with lv[0].x = D0 r already set, up to and
// including the prolongation into level 0: afterwards smooth_at(lv[0], idx)
// is the V-cycle's result at idx. Ends with a grid barrier.
__device__ void vcycle_to_fine(const Level* lv, int nlev,
                               cg::grid_group& grid) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int l = 0; l < nlev - 1; ++l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
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
    const Level& C = lv[nlev - 1];
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
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = F.ny * F.nx;
    for (int idx = tid; idx < nf; idx += stride) {
      const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
      F.x[idx] = ldw(F.x + idx) + prolong_at(C, C.t, i, j);
    }
    grid.sync();
    if (l == 0) break;  // the caller's stage post-smooths level 0
    for (int idx = tid; idx < nf; idx += stride) F.t[idx] = smooth_at(F, idx);
    grid.sync();
  }
}

// The chain of `cycles` V-cycles z = V(v); z += V(v - A0 z), ..., a
// linear operator in v (the Pallas kernels' Richardson preconditioner),
// up to the last cycle's final stage: afterwards chain_result_at(lv[0], z,
// idx, cycles) is the chain's result at idx. On entry lv[0].r = v and
// lv[0].x = D0 v, set and behind a grid barrier; z is the chain's
// accumulator (n0 floats), v is not written.
__device__ void chain_to_last(const Level* lv, int nlev, const float* v,
                              float* z, int cycles, cg::grid_group& grid) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const Level& L0 = lv[0];
  const int n0 = L0.ny * L0.nx;
  for (int c = 0; c < cycles - 1; ++c) {
    vcycle_to_fine(lv, nlev, grid);
    for (int idx = tid; idx < n0; idx += stride) {
      const float s = smooth_at(L0, idx);
      z[idx] = c == 0 ? s : ldw(z + idx) + s;
    }
    grid.sync();
    for (int idx = tid; idx < n0; idx += stride) {
      const int i = idx / L0.nx, j = idx - (idx / L0.nx) * L0.nx;
      const float res = ldw(v + idx) - apply_at(L0, z, i, j);
      L0.r[idx] = res;
      L0.x[idx] = __ldg(L0.D + idx) * res;
    }
    grid.sync();
  }
  vcycle_to_fine(lv, nlev, grid);
}

__device__ __forceinline__ float chain_result_at(const Level& L0,
                                                 const float* z, int idx,
                                                 int cycles) {
  const float s = smooth_at(L0, idx);
  return cycles > 1 ? ldw(z + idx) + s : s;
}

// ---- host side --------------------------------------------------------

// Tap offsets (dy, dx) of a level, K pairs; cudaError_t.
inline int set_taps(Level& L, int K, const int* offs) {
  if (K < 0 || K > kMaxTaps) return (int)cudaErrorInvalidValue;
  L.K = K;
  for (int k = 0; k < K; ++k) {
    const int dy = offs[2 * k], dx = offs[2 * k + 1];
    if (dy < -127 || dy > 127 || dx < -127 || dx > 127)
      return (int)cudaErrorInvalidValue;
    L.dy[k] = (signed char)dy;
    L.dx[k] = (signed char)dx;
  }
  return 0;
}

// Level descriptors from flat host arrays. ptrs: 5 device pointers per
// level (W, D, r, x, t); dims: 3 ints per level (ny, nx, K); offs: 2 * K
// ints per level, (dy, dx) per tap, levels concatenated. At least two
// levels: the level-0 post-smoothing is the callers' own stage.
inline int pack_levels(Level* lv, int nlev, const long long* ptrs,
                       const int* dims, const int* offs) {
  if (nlev < 2 || nlev > kMaxLevels) return (int)cudaErrorInvalidValue;
  int o = 0;
  for (int l = 0; l < nlev; ++l) {
    Level& L = lv[l];
    L.W = reinterpret_cast<const float*>(ptrs[5 * l + 0]);
    L.D = reinterpret_cast<const float*>(ptrs[5 * l + 1]);
    L.r = reinterpret_cast<float*>(ptrs[5 * l + 2]);
    L.x = reinterpret_cast<float*>(ptrs[5 * l + 3]);
    L.t = reinterpret_cast<float*>(ptrs[5 * l + 4]);
    L.ny = dims[3 * l + 0];
    L.nx = dims[3 * l + 1];
    if (L.ny < 1 || L.nx < 1) return (int)cudaErrorInvalidValue;
    if (l > 0 && (L.ny != (lv[l - 1].ny - 1) / 2 + 1 ||
                  L.nx != (lv[l - 1].nx - 1) / 2 + 1))
      return (int)cudaErrorInvalidValue;
    const int e = set_taps(L, dims[3 * l + 2], offs + 2 * o);
    if (e != 0) return e;
    o += L.K;
  }
  return 0;
}

// Blocks of a cooperative grid of `kernel` for a fine level of
// `fine_points`: as many as can be co-resident on the device, and no more
// than the fine level has work for. Returns a cudaError_t.
template <class Kernel>
int coop_grid(Kernel kernel, int fine_points, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int resident = per_sm * sms;
  const int needed = (fine_points + kThreads - 1) / kThreads;
  *blocks = needed < resident ? needed : resident;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace
