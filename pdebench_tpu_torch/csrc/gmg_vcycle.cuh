// Multigrid level code shared by the fused GMG kernels, for Hopper
// (sm_90a): the levels, the site indexing, the block sum and the host
// packing of the cluster kernels #2 / #3, #4, #5 and #6 (through
// gmg_cluster.cuh).
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
// slab-packed `_Level3` planes), here as direct 3 x 3 (x 3) stencils
// (gmg_cluster.cuh's restrict_ld, prolong_ld).
//
// Work vectors written in a kernel are read with __ldcg (through L2), so
// that no CTA reads a stale L1 line after a barrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 128;  // a 3-D P2 fine level has 65
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

// coarse indices and weights of fine index i along one axis: the even
// point itself, or the average of its two neighbours
__device__ __forceinline__ int lin_taps(int i, int* ci, float* wi) {
  if (i % 2 == 0) { ci[0] = i / 2; wi[0] = 1.f; return 1; }
  ci[0] = (i - 1) / 2; ci[1] = (i + 1) / 2; wi[0] = wi[1] = 0.5f;
  return 2;
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

}  // namespace
