// Block (d = 2) level code shared by the fused block kernels, for Hopper
// (sm_90a), on top of gmg_vcycle.cuh's levels: the 2 x 2 point helpers
// diag2 and set_rhs2 of kernel #5 (gmg_fused_dyn_block.cu, through
// gmg_cluster.cuh's block stages). Kernel #4 (gmg_fused_block_cg.cu)
// keeps its own per-site sums, rounded as its plain version.
//
// A block level vector is two planar component planes (2, ny, nx). The
// weights are W (K, 2, 2, ny, nx), W[k, a, b] the plane that multiplies
// component b into component a (not symmetric per point in general: a
// kernel that read W[k, b, a] would be wrong there), and D (2, 2, ny, nx)
// omega times the point-block inverse diagonal, read as D[a, b] too.
//
// One block V-cycle: x = D r (a 2 x 2 product per point); at level l <
// L-1, t = r - A x, r_c = R t per component, V at l + 1, x += P x_c per
// component, x = x + D (r - A x); on the coarsest level COARSE_SWEEPS
// damped block-Jacobi sweeps (x = D r, then kCoarseSweeps - 1 sweeps
// x += D (r - A x)). R and P are the scalar 3 x 3 transfer stencils of
// gmg_cluster.cuh (restrict_ld, prolong_ld), applied to each component
// plane. 2-D levels only.

#pragma once

#include "gmg_vcycle.cuh"

namespace {

// (y0, y1) = D (v0, v1) at point idx: the smoother's 2 x 2 step
__device__ __forceinline__ void diag2(const Level& L, int idx, float v0,
                                      float v1, float& y0, float& y1) {
  const int n = L.ny * L.nx;
  y0 = __ldg(L.D + idx) * v0 + __ldg(L.D + n + idx) * v1;          // D[0,0], D[0,1]
  y1 = __ldg(L.D + 2 * n + idx) * v0 + __ldg(L.D + 3 * n + idx) * v1;  // D[1,0], D[1,1]
}

// r and x = D r at point idx of level L
__device__ __forceinline__ void set_rhs2(const Level& L, int idx, float r0,
                                         float r1) {
  const int n = L.ny * L.nx;
  float x0, x1;
  diag2(L, idx, r0, r1, x0, x1);
  L.r[idx] = r0;
  L.r[n + idx] = r1;
  L.x[idx] = x0;
  L.x[n + idx] = x1;
}

}  // namespace
