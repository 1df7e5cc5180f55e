// Block (d = 2) V-cycle device code of the fused block kernel
// (gmg_fused_block_cg.cu, kernel #4; its 2 x 2 point helpers diag2 and
// set_rhs2 also serve kernel #5 through gmg_cluster.cuh), for Hopper
// (sm_90a), on top of gmg_vcycle.cuh's levels and transfers.
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
// gmg_vcycle.cuh, applied to each component plane. 2-D levels only.

#pragma once

#include "gmg_vcycle.cuh"

namespace {

// (A u)(i, j) of both components: per tap, the (a <- 0) and (a <- 1)
// products summed, then added (the order of the Pallas kernel's _apply_b)
__device__ __forceinline__ void apply2_at(const Level& L, const float* u,
                                          int i, int j, float& o0,
                                          float& o1) {
  const int n = L.ny * L.nx;
  const int idx = i * L.nx + j;
  float a0 = 0.f, a1 = 0.f;
  for (int k = 0; k < L.K; ++k) {
    const int ii = i + L.dy[k], jj = j + L.dx[k];
    if (ii >= 0 && ii < L.ny && jj >= 0 && jj < L.nx) {
      const int s = ii * L.nx + jj;
      const float u0 = ldw(u + s), u1 = ldw(u + n + s);
      const float* w = L.W + (size_t)k * 4 * n + idx;
      a0 += __ldg(w) * u0 + __ldg(w + n) * u1;              // W[k,0,0], W[k,0,1]
      a1 += __ldg(w + 2 * n) * u0 + __ldg(w + 3 * n) * u1;  // W[k,1,0], W[k,1,1]
    }
  }
  o0 = a0;
  o1 = a1;
}

// (y0, y1) = D (v0, v1) at point idx: the smoother's 2 x 2 step
__device__ __forceinline__ void diag2(const Level& L, int idx, float v0,
                                      float v1, float& y0, float& y1) {
  const int n = L.ny * L.nx;
  y0 = __ldg(L.D + idx) * v0 + __ldg(L.D + n + idx) * v1;          // D[0,0], D[0,1]
  y1 = __ldg(L.D + 2 * n + idx) * v0 + __ldg(L.D + 3 * n + idx) * v1;  // D[1,0], D[1,1]
}

// post-smoothing value x + D (r - A x) at point idx of level F
__device__ __forceinline__ void smooth2_at(const Level& F, int idx,
                                           float& v0, float& v1) {
  const int n = F.ny * F.nx;
  const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
  float a0, a1, s0, s1;
  apply2_at(F, F.x, i, j, a0, a1);
  diag2(F, idx, ldw(F.r + idx) - a0, ldw(F.r + n + idx) - a1, s0, s1);
  v0 = ldw(F.x + idx) + s0;
  v1 = ldw(F.x + n + idx) + s1;
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

// One block V-cycle on lv[0].r, with lv[0].x = D0 r already set, up to and
// including the prolongation into level 0: afterwards smooth2_at(lv[0],
// idx) is the V-cycle's result at idx. Ends with a grid barrier.
__device__ void vcycle2_to_fine(const Level* lv, int nlev,
                                cg::grid_group& grid) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int l = 0; l < nlev - 1; ++l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = F.ny * F.nx, nc = C.ny * C.nx;
    for (int idx = tid; idx < nf; idx += stride) {
      const int i = idx / F.nx, j = idx - (idx / F.nx) * F.nx;
      float a0, a1;
      apply2_at(F, F.x, i, j, a0, a1);
      F.t[idx] = ldw(F.r + idx) - a0;
      F.t[nf + idx] = ldw(F.r + nf + idx) - a1;
    }
    grid.sync();
    for (int idx = tid; idx < nc; idx += stride)
      set_rhs2(C, idx, restrict_at(F, C, F.t, idx), restrict_at(F, C, F.t + nf, idx));
    grid.sync();
  }
  {
    // coarsest level: one block, block barriers between block-Jacobi sweeps
    const Level& C = lv[nlev - 1];
    if (blockIdx.x == 0) {
      const int n = C.ny * C.nx;
      float* src = C.x;
      float* dst = C.t;
      for (int s = 0; s < kCoarseSweeps - 1; ++s) {
        for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
          const int i = idx / C.nx, j = idx - (idx / C.nx) * C.nx;
          float a0, a1, s0, s1;
          apply2_at(C, src, i, j, a0, a1);
          diag2(C, idx, ldw(C.r + idx) - a0, ldw(C.r + n + idx) - a1, s0, s1);
          dst[idx] = ldw(src + idx) + s0;
          dst[n + idx] = ldw(src + n + idx) + s1;
        }
        __syncthreads();
        float* tmp = src; src = dst; dst = tmp;
      }
      if (src != C.t) {
        for (int idx = threadIdx.x; idx < 2 * n; idx += blockDim.x)
          C.t[idx] = ldw(src + idx);
      }
    }
    grid.sync();
  }
  for (int l = nlev - 2; l >= 0; --l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = F.ny * F.nx, nc = C.ny * C.nx;
    for (int idx = tid; idx < nf; idx += stride) {
      F.x[idx] = ldw(F.x + idx) + prolong_at(F, C, C.t, idx);
      F.x[nf + idx] = ldw(F.x + nf + idx) + prolong_at(F, C, C.t + nc, idx);
    }
    grid.sync();
    if (l == 0) break;  // the caller's stage post-smooths level 0
    for (int idx = tid; idx < nf; idx += stride) {
      float v0, v1;
      smooth2_at(F, idx, v0, v1);
      F.t[idx] = v0;
      F.t[nf + idx] = v1;
    }
    grid.sync();
  }
}

}  // namespace
