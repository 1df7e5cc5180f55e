// Multigrid level code shared by the fused GMG kernels, for Hopper
// (sm_90a): the levels, per-site transfers, block sums and host packing
// of the cooperative block kernel #4 (through gmg_block_vcycle.cuh) and
// of the cluster kernels #2 / #3, #5 and #6 (through gmg_cluster.cuh).
//
// A hierarchy is levels 0..L-1 of a 2-D or 3-D scalar lattice; level l+1
// halves level l ((n - 1) / 2 + 1 points per axis). A level is (nz, ny, nx)
// sites, x fastest; a 2-D level has nz = 1 and every tap dz = 0, and sums
// in the same order as a 2-D-only code would. One V-cycle on the level-0
// right-hand side r, with x = D r already set, is: at level l < L-1,
// t = r - A x; r_c = R t; V at l+1; x += P x_c; x = x + D (r - A x). The
// coarsest level takes x = D r followed by COARSE_SWEEPS - 1 Jacobi
// sweeps x += D (r - A x). D holds omega times the inverse diagonal.
// Stencil taps read zero outside the level (the Pallas kernels' rolls over
// zero pads). R is the tensor product of the truncated [1/4, 1/2, 1/4]
// band per axis at even fine points and P its bi- or trilinear transpose
// (the Pallas banded matmuls; in 3-D the kron(Bz, By) row band of the
// slab-packed `_Level3` planes), here as direct 3 x 3 (x 3) stencils. Every
// stage loops over the flat site index, so loads stay coalesced whatever
// nx is.
//
// Work vectors written in a kernel are read with __ldcg (through L2), so
// that no block reads a stale L1 line after a barrier. The cooperative
// helpers here (put_partial, grid_total, coop_grid) serve kernel #4: a
// grid-stride loop per stage, grid.sync() between stages.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 128;  // a 3-D P2 fine level has 65
constexpr int kThreads = 256;
constexpr int kCoarseSweeps = 10;  // COARSE_SWEEPS of the Pallas kernels

struct Level {
  const float* W;  // (K, nz, ny, nx) stencil weights
  const float* D;  // (nz, ny, nx) omega * inverse diagonal
  float* r;        // level right-hand side
  float* x;        // smoother iterate
  float* t;        // scratch; holds the level's V-cycle result (l > 0)
  int nz, ny, nx, K;
  signed char dz[kMaxTaps];
  signed char dy[kMaxTaps];
  signed char dx[kMaxTaps];
};

__device__ __forceinline__ float ldw(const float* a) { return __ldcg(a); }

__host__ __device__ __forceinline__ int sites(const Level& L) {
  return L.nz * L.ny * L.nx;
}

// (z, y, x) of flat site idx (the branch on nz is uniform across the
// grid: one division fewer on 2-D levels)
__device__ __forceinline__ void site_of(const Level& L, int idx, int& k,
                                        int& i, int& j) {
  const int q = idx / L.nx;
  j = idx - q * L.nx;
  if (L.nz == 1) {
    k = 0;
    i = q;
  } else {
    k = q / L.ny;
    i = q - k * L.ny;
  }
}

// full weighting at fine site (2kc, 2ic, 2jc) for coarse site idx of C,
// zero outside the fine level F; summed along x first, then y, then z
// (the Pallas kernel sums By @ (res @ Bx^T), its By the kron'd z-y band
// in 3-D). A 2-D level (nz = 1) has no z sum: its weight is 1.
__device__ __forceinline__ float restrict_at(const Level& F, const Level& C,
                                             const float* t, int idx) {
  const float w[3] = {0.25f, 0.5f, 0.25f};
  int kc, ic, jc;
  site_of(C, idx, kc, ic, jc);
  const int zr = F.nz > 1 ? 1 : 0;
  float acc = 0.f;
  for (int c = -zr; c <= zr; ++c) {
    const int kf = 2 * kc + c;
    if (kf < 0 || kf >= F.nz) continue;
    float plane = 0.f;
    for (int a = -1; a <= 1; ++a) {
      const int i = 2 * ic + a;
      if (i < 0 || i >= F.ny) continue;
      float row = 0.f;
      for (int b = -1; b <= 1; ++b) {
        const int j = 2 * jc + b;
        if (j < 0 || j >= F.nx) continue;
        row += w[b + 1] * ldw(t + (kf * F.ny + i) * F.nx + j);
      }
      plane += w[a + 1] * row;
    }
    acc += (zr ? w[c + 1] : 1.f) * plane;
  }
  return acc;
}

// coarse indices and weights of fine index i along one axis: the even
// point itself, or the average of its two neighbours
__device__ __forceinline__ int lin_taps(int i, int* ci, float* wi) {
  if (i % 2 == 0) { ci[0] = i / 2; wi[0] = 1.f; return 1; }
  ci[0] = (i - 1) / 2; ci[1] = (i + 1) / 2; wi[0] = wi[1] = 0.5f;
  return 2;
}

// tri- (bi-) linear interpolation of the coarse field of C at fine site
// idx of F
__device__ __forceinline__ float prolong_at(const Level& F, const Level& C,
                                            const float* xc, int idx) {
  int k, i, j;
  site_of(F, idx, k, i, j);
  int ck[2], ci[2], cj[2];
  float wk[2], wi[2], wj[2];
  const int nk = lin_taps(k, ck, wk), ni = lin_taps(i, ci, wi),
            nj = lin_taps(j, cj, wj);
  float acc = 0.f;
  for (int c = 0; c < nk; ++c) {
    if (ck[c] >= C.nz) continue;
    float plane = 0.f;
    for (int a = 0; a < ni; ++a) {
      if (ci[a] >= C.ny) continue;
      float row = 0.f;
      for (int b = 0; b < nj; ++b) {
        if (cj[b] >= C.nx) continue;
        row += wj[b] * ldw(xc + (ck[c] * C.ny + ci[a]) * C.nx + cj[b]);
      }
      plane += wi[a] * row;
    }
    acc += wk[c] * plane;
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

// ---- host side --------------------------------------------------------

// Tap offsets (dz, dy, dx) of a level, K triples; cudaError_t.
inline int set_taps(Level& L, int K, const int* offs) {
  if (K < 0 || K > kMaxTaps) return (int)cudaErrorInvalidValue;
  L.K = K;
  for (int k = 0; k < K; ++k) {
    for (int a = 0; a < 3; ++a)
      if (offs[3 * k + a] < -127 || offs[3 * k + a] > 127)
        return (int)cudaErrorInvalidValue;
    L.dz[k] = (signed char)offs[3 * k + 0];
    L.dy[k] = (signed char)offs[3 * k + 1];
    L.dx[k] = (signed char)offs[3 * k + 2];
  }
  return 0;
}

// Level descriptors from flat host arrays. ptrs: 5 device pointers per
// level (W, D, r, x, t); dims: 4 ints per level (nz, ny, nx, K); offs:
// 3 * K ints per level, (dz, dy, dx) per tap, levels concatenated (a 2-D
// level: nz = 1, dz = 0). At least `min_levels` levels: two where the
// caller post-smooths level 0 as its own stage after the V-cycle's
// prolongation into it; a caller that takes one level reads a one-level
// V-cycle (the coarsest sweeps alone) from lv[0].t.
inline int pack_levels(Level* lv, int nlev, const long long* ptrs,
                       const int* dims, const int* offs, int min_levels = 2) {
  if (nlev < min_levels || nlev > kMaxLevels) return (int)cudaErrorInvalidValue;
  int o = 0;
  for (int l = 0; l < nlev; ++l) {
    Level& L = lv[l];
    L.W = reinterpret_cast<const float*>(ptrs[5 * l + 0]);
    L.D = reinterpret_cast<const float*>(ptrs[5 * l + 1]);
    L.r = reinterpret_cast<float*>(ptrs[5 * l + 2]);
    L.x = reinterpret_cast<float*>(ptrs[5 * l + 3]);
    L.t = reinterpret_cast<float*>(ptrs[5 * l + 4]);
    L.nz = dims[4 * l + 0];
    L.ny = dims[4 * l + 1];
    L.nx = dims[4 * l + 2];
    if (L.nz < 1 || L.ny < 1 || L.nx < 1) return (int)cudaErrorInvalidValue;
    if (l > 0 && (L.nz != (lv[l - 1].nz - 1) / 2 + 1 ||
                  L.ny != (lv[l - 1].ny - 1) / 2 + 1 ||
                  L.nx != (lv[l - 1].nx - 1) / 2 + 1))
      return (int)cudaErrorInvalidValue;
    const int e = set_taps(L, dims[4 * l + 3], offs + 3 * o);
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
