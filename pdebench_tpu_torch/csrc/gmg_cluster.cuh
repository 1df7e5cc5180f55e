// Thread-block-cluster stages of the fused kernels #2 / #3, #4, #5 and #6
// (gmg_fused_cg.cu, gmg_fused_block_cg.cu, gmg_fused_dyn_block.cu,
// gmg_fused_gmres.cu), for Hopper (sm_90a).
//
// A kernel here is one cluster of up to kMaxCluster CTAs of
// kClusterThreads threads, launched as the whole grid (cluster_launch), so
// blockIdx.x is the CTA's rank in the cluster. Dependent stages are
// separated by the hardware cluster barrier (cluster.sync():
// barrier.cluster.arrive.release / wait.acquire), not by a cooperative
// grid barrier.
//
// - Bands: each CTA owns a band of whole rows ((z, y) rows of nx sites)
//   of every level, rows split as evenly as the count allows, so each
//   thread always owns the same sites of a level (band()).
// - Windows: a stage whose per-site sum reads a level vector at the tap
//   offsets first copies the box of that vector its band's taps reach
//   (whole planes in 3-D, rows in 2-D), zero-padded by the taps' reach on
//   every side, from L2 into shared memory (stage_in); the taps then read
//   it there at fixed offsets, with no bounds checks: a tap outside the
//   level reads a zero, as in the Pallas kernels' zero-padded rolls and
//   the plain versions. The level vectors themselves stay in global
//   memory (L2-resident), written by their owners and read through L2
//   (__ldcg) after a barrier.
// - Weights stay in global memory (L2-resident) and are read through the
//   read-only path (__ldg), kBatch (kBatch2) taps' loads issued together,
//   and summed in tap order, where a tap outside the level adds an exact
//   0. The scalar sums (taps_at) round as the plain versions do, with no
//   fused multiply-add; the block sums of kernel #5 (taps2_at,
//   smooth2_win) leave nvcc free to contract them into fused
//   multiply-adds. Kernel #4 has its own block sums, rounded as its plain
//   version.
// - The coarse levels of a scalar hierarchy: CTA 0 solves every level
//   from l* down in its shared memory, l* the finest level from which
//   they fit, their W and D copied in once per launch (cta_load,
//   cta_vcycle; kernel #4 has their block form), with block barriers
//   only. The block kernel #5 copies
//   its coarsest level's W, D and right-hand side in at each V-cycle and
//   sweeps it there (coarse_solve2).
// - Sums: a CTA's partial of a dot product (block_sum, double) goes into
//   a slot of its shared memory; after the barrier warp 0 of every CTA
//   reads the cluster's partials through distributed shared memory, adds
//   them in one fixed tree order and hands the total to the CTA's threads
//   (cluster_total): every CTA holds the same value, deterministically and
//   without atomics.

#pragma once

#include "gmg_block_vcycle.cuh"

// The launch's dynamic shared memory: the kernels' windows and coarse
// solve.
extern __shared__ float cluster_smem[];

namespace {

constexpr int kClusterThreads = 1024;
constexpr int kMaxCluster = 16;  // non-portable cluster size on sm_90
constexpr int kBatch = 8;        // scalar taps whose weight loads go out together
constexpr int kBatch2 = 6;       // block taps (four weight loads each)

// This CTA's flat sites [lo, hi) of a level: rank c of P takes whole
// (z, y) rows [c rows / P, (c + 1) rows / P).
struct Band {
  int lo, hi;
};

__host__ __device__ inline Band band_of(const Level& L, int c, int P) {
  const long long rows = (long long)L.nz * L.ny;
  return {(int)(c * rows / P) * L.nx, (int)((c + 1) * rows / P) * L.nx};
}

__device__ __forceinline__ Band band(const Level& L) {
  return band_of(L, blockIdx.x, gridDim.x);
}

// Flat sites of the largest band of a level over a cluster of P CTAs.
__host__ __device__ inline int band_cap(const Level& L, int P) {
  const int rows = L.nz * L.ny;
  return (rows + P - 1) / P * L.nx;
}

// A level's taps as a tap stage reads them: from a window of the level
// vector in shared memory, zero-padded by the taps' reach (pz, py, px)
// on every side, so that a tap needs no bounds check. woff[k] is tap k's
// offset there: (dz * (ny + 2 py) + dy) * (nx + 2 px) + dx (a 2-D level,
// dz = 0, needs no z pad).
struct Taps {
  int pz, py, px;
  int woff[kMaxTaps];
};

// host: the Taps of level L
inline void window_taps(const Level& L, Taps& T) {
  T.pz = T.py = T.px = 0;
  for (int k = 0; k < L.K; ++k) {
    const int az = L.dz[k] < 0 ? -L.dz[k] : L.dz[k];
    const int ay = L.dy[k] < 0 ? -L.dy[k] : L.dy[k];
    const int ax = L.dx[k] < 0 ? -L.dx[k] : L.dx[k];
    T.pz = az > T.pz ? az : T.pz;
    T.py = ay > T.py ? ay : T.py;
    T.px = ax > T.px ? ax : T.px;
  }
  const int Ly = L.ny + 2 * T.py, Lx = L.nx + 2 * T.px;
  for (int k = 0; k < L.K; ++k) T.woff[k] = (L.dz[k] * Ly + L.dy[k]) * Lx + L.dx[k];
}

// Weight plane p at site idx of a level of n sites: from global memory
// through the read-only path, or from shared memory.
struct GlobalW {
  const float* W;
  int n;
  __device__ __forceinline__ float operator()(int p, int idx) const { return __ldg(W + p * n + idx); }
};
struct SharedW {
  const float* W;
  int n;
  __device__ __forceinline__ float operator()(int p, int idx) const { return W[p * n + idx]; }
};

// dst[q] = ld(q) for q < n by the CTA's threads, kCopy loads in flight
// per thread
constexpr int kCopy = 8;
template <class Load>
__device__ __forceinline__ void copy_in(float* dst, int n, Load ld) {
  for (int q0 = threadIdx.x; q0 < n; q0 += kCopy * blockDim.x) {
    float v[kCopy];
#pragma unroll
    for (int b = 0; b < kCopy; ++b) {
      const int q = q0 + b * blockDim.x;
      v[b] = q < n ? ld(q) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kCopy; ++b) {
      const int q = q0 + b * blockDim.x;
      if (q < n) dst[q] = v[b];
    }
  }
}

// A zero-padded box of a level vector in shared memory: planes
// [za, za + Lz), rows [ya, ya + Ly) of each, columns [-px, nx + px);
// ncomp component boxes of `plane` floats each.
struct Window {
  float* s;
  int plane, za, ya, Ly, Lx, px;
  // index of site idx of level L in (each component's) box
  __device__ __forceinline__ int site(const Level& L, int idx) const {
    int z, y, x;
    site_of(L, idx, z, y, x);
    return ((z - za) * Ly + (y - ya)) * Lx + x + px;
  }
};

// The box of level L that a band's tap sums read: in 3-D whole padded
// planes, in 2-D padded rows.
__host__ __device__ inline Window window_of(const Level& L, const Taps& T, Band b, float* s) {
  Window w{s, 0, 0, 0, 0, L.nx + 2 * T.px, T.px};
  if (b.hi <= b.lo) return w;
  const int rlo = b.lo / L.nx, rhi = (b.hi - 1) / L.nx;
  int Lz;
  if (L.nz > 1) {
    w.za = rlo / L.ny - T.pz;
    Lz = rhi / L.ny + 1 + T.pz - w.za;
    w.ya = -T.py;
    w.Ly = L.ny + 2 * T.py;
  } else {
    w.za = 0;
    Lz = 1;
    w.ya = rlo - T.py;
    w.Ly = rhi + 1 + T.py - w.ya;
  }
  w.plane = Lz * w.Ly * w.Lx;
  return w;
}

// v's window for this CTA's tap sums on band b, copied (zero outside the
// level) into s. Ends with a block barrier.
__device__ __forceinline__ Window stage_in(const float* v, const Level& L, const Taps& T,
                                           Band b, int ncomp, float* s) {
  const Window w = window_of(L, T, b, s);
  const int n = sites(L);
  for (int c = 0; c < ncomp; ++c) {
    const float* src = v + c * n;
    copy_in(s + c * w.plane, w.plane, [&](int q) {
      const int row = q / w.Lx, x = q - row * w.Lx - w.px;
      const int pl = row / w.Ly;
      const int z = w.za + pl, y = w.ya + row - pl * w.Ly;
      const bool in = z >= 0 && z < L.nz && y >= 0 && y < L.ny && x >= 0 && x < L.nx;
      return in ? __ldcg(src + (z * L.ny + y) * L.nx + x) : 0.f;
    });
  }
  __syncthreads();
  return w;
}

// The window of a level vector a stage computes site by site instead of
// reading it: v(idx) at the sites of level L the window of band b holds,
// zero outside the level, one site per thread at a time. Ends with a
// block barrier.
template <class V>
__device__ __forceinline__ Window stage_fn(const Level& L, const Taps& T, Band b, float* s, V v) {
  const Window w = window_of(L, T, b, s);
  for (int q = threadIdx.x; q < w.plane; q += blockDim.x) {
    const int row = q / w.Lx, x = q - row * w.Lx - w.px;
    const int pl = row / w.Ly;
    const int z = w.za + pl, y = w.ya + row - pl * w.Ly;
    const bool in = z >= 0 && z < L.nz && y >= 0 && y < L.ny && x >= 0 && x < L.nx;
    s[q] = in ? v((z * L.ny + y) * L.nx + x) : 0.f;
  }
  __syncthreads();
  return w;
}

// (A u) at flat site idx of a scalar level, u the site's place in a
// window (taps read it at woff): taps in order, each product rounded and
// then added, as the plain version (stencil_plain) sums: no fused
// multiply-add, so that the kernel's scalar V-cycles round as their plain
// version does. A tap outside the level reads the window's zero.
template <class WS>
__device__ __forceinline__ float taps_at(const Level& L, const int* woff, WS w,
                                         const float* u, int idx) {
  float acc = 0.f;
  for (int k = 0; k < L.K; k += kBatch) {
    float wv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) wv[b] = k + b < L.K ? w(k + b, idx) : 0.f;
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (k + b < L.K) acc = __fadd_rn(acc, __fmul_rn(wv[b], u[woff[k + b]]));
  }
  return acc;
}

// (A u) at site idx of both components of a 2-D block level, u0 and u1
// the site's places in the two component windows: per tap the (a <- 0)
// and (a <- 1) products summed, then added, in the plain block apply's
// order; nvcc may contract them into fused multiply-adds
template <class WS>
__device__ __forceinline__ void taps2_at(const Level& L, const int* woff, WS w,
                                         const float* u0, const float* u1, int idx,
                                         float& o0, float& o1) {
  float a0 = 0.f, a1 = 0.f;
  for (int k = 0; k < L.K; k += kBatch2) {
    float w00[kBatch2], w01[kBatch2], w10[kBatch2], w11[kBatch2];
#pragma unroll
    for (int b = 0; b < kBatch2; ++b) {
      const bool in = k + b < L.K;
      const int q = 4 * (k + b);
      w00[b] = in ? w(q, idx) : 0.f;      // W[k,0,0]
      w01[b] = in ? w(q + 1, idx) : 0.f;  // W[k,0,1]
      w10[b] = in ? w(q + 2, idx) : 0.f;  // W[k,1,0]
      w11[b] = in ? w(q + 3, idx) : 0.f;  // W[k,1,1]
    }
#pragma unroll
    for (int b = 0; b < kBatch2; ++b) {
      if (k + b < L.K) {
        const float v0 = u0[woff[k + b]], v1 = u1[woff[k + b]];
        a0 += w00[b] * v0 + w01[b] * v1;
        a1 += w10[b] * v0 + w11[b] * v1;
      }
    }
  }
  o0 = a0;
  o1 = a1;
}

// ---- transfers -----------------------------------------------------------

// A level vector read at site (z, y, x) inside its level: from global
// memory through L2, or from a zero-padded box in shared memory (the
// padded box of a whole level, box_site's layout)
struct GlobalLd {
  const float* v;
  int ny, nx;
  __device__ __forceinline__ float operator()(int z, int y, int x) const {
    return ldw(v + (z * ny + y) * nx + x);
  }
};
struct BoxLd {
  const float* s;
  int Ly, Lx, pz, py, px;
  __device__ __forceinline__ float operator()(int z, int y, int x) const {
    return s[((z + pz) * Ly + y + py) * Lx + x + px];
  }
};

// Full weighting at fine site (2kc, 2ic, 2jc) for coarse site idx of C
// from fine vector t of F, the 3 x 3 (x 3) loads of a fine plane issued
// together, zero outside F, summed along x first, then y, then z (the
// Pallas kernel sums By @ (res @ Bx^T), its By the kron'd z-y band in
// 3-D); a 2-D level (nz = 1) has no z sum.
template <class Ld>
__device__ __forceinline__ float restrict_ld(const Level& F, const Level& C, Ld t, int idx) {
  const float w[3] = {0.25f, 0.5f, 0.25f};
  int kc, ic, jc;
  site_of(C, idx, kc, ic, jc);
  const int zr = F.nz > 1 ? 1 : 0;
  float acc = 0.f;
  for (int c = -zr; c <= zr; ++c) {
    const int kf = 2 * kc + c;
    float v[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int i = 2 * ic + a - 1, j = 2 * jc + b - 1;
        const bool in = kf >= 0 && kf < F.nz && i >= 0 && i < F.ny && j >= 0 && j < F.nx;
        v[a][b] = in ? t(kf, i, j) : 0.f;
      }
    float plane = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float row = 0.f;
#pragma unroll
      for (int b = 0; b < 3; ++b) row += w[b] * v[a][b];
      plane += w[a] * row;
    }
    acc += (zr ? w[c + 1] : 1.f) * plane;
  }
  return acc;
}

__device__ __forceinline__ float restrict_cl(const Level& F, const Level& C, const float* t,
                                             int idx) {
  return restrict_ld(F, C, GlobalLd{t, F.ny, F.nx}, idx);
}

// Tri- (bi-) linear interpolation at fine site idx of F from coarse
// vector xc of C, its (up to 8) loads issued together, summed along x,
// then y, then z
template <class Ld>
__device__ __forceinline__ float prolong_ld(const Level& F, const Level& C, Ld xc, int idx) {
  int k, i, j;
  site_of(F, idx, k, i, j);
  int ck[2], ci[2], cj[2];
  float wk[2], wi[2], wj[2];
  const int nk = lin_taps(k, ck, wk), ni = lin_taps(i, ci, wi), nj = lin_taps(j, cj, wj);
  float v[2][2][2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool in = c < nk && a < ni && b < nj && ck[c] < C.nz && ci[a] < C.ny && cj[b] < C.nx;
        v[c][a][b] = in ? xc(ck[c], ci[a], cj[b]) : 0.f;
      }
  float acc = 0.f;
  for (int c = 0; c < nk; ++c) {
    if (ck[c] >= C.nz) continue;
    float plane = 0.f;
    for (int a = 0; a < ni; ++a) {
      if (ci[a] >= C.ny) continue;
      float row = 0.f;
      for (int b = 0; b < nj; ++b) {
        if (cj[b] >= C.nx) continue;
        row += wj[b] * v[c][a][b];
      }
      plane += wi[a] * row;
    }
    acc += wk[c] * plane;
  }
  return acc;
}

__device__ __forceinline__ float prolong_cl(const Level& F, const Level& C, const float* xc,
                                            int idx) {
  return prolong_ld(F, C, GlobalLd{xc, C.ny, C.nx}, idx);
}

// ---- fixed-order cluster sums --------------------------------------------

// this CTA's partial of a dot product into its slot red[slot] (read by
// the other CTAs after the next cluster barrier)
__device__ __forceinline__ void put_red(double acc, double* red, int slot, double* sh) {
  const double s = block_sum(acc, sh);
  if (threadIdx.x == 0) red[slot] = s;
}

// after a cluster barrier: the sum of the CTAs' red[slot], rank 0 first,
// in one shuffle tree of warp 0, handed to the CTA's threads through
// bc[slot]: identical in every CTA. A slot read here must not be written
// again in the same stage: the dots of consecutive stages use
// alternating slots.
__device__ __forceinline__ double cluster_total(cg::cluster_group& cluster, double* red,
                                                double* bc, int slot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double v = lane < (int)gridDim.x ? *cluster.map_shared_rank(red + slot, lane) : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) bc[slot] = v;
  }
  __syncthreads();
  return bc[slot];
}

// ---- a whole level in one CTA's shared memory ----------------------------

// The zero-padded box of a whole level (a coarse-solve iterate).
__host__ __device__ inline int box_floats(const Level& C, const Taps& T) {
  return (C.nz + 2 * T.pz) * (C.ny + 2 * T.py) * (C.nx + 2 * T.px);
}

// Floats of shared memory coarse_solve2 takes for block level C: W, D,
// r and two padded iterates, of two components each.
inline int coarse2_floats(const Level& C, const Taps& T) {
  return (4 * C.K + 4 + 2) * C.nz * C.ny * C.nx + 4 * box_floats(C, T);
}

// index of site idx of level C in its padded box
__device__ __forceinline__ int box_site(const Level& C, const Taps& T, int idx) {
  int z, y, x;
  site_of(C, idx, z, y, x);
  return ((z + T.pz) * (C.ny + 2 * T.py) + y + T.py) * (C.nx + 2 * T.px) + x + T.px;
}

// a padded box of level C in shared memory, read at (z, y, x)
__device__ __forceinline__ BoxLd box_ld(const Level& C, const Taps& T, const float* s) {
  return {s, C.ny + 2 * T.py, C.nx + 2 * T.px, T.pz, T.py, T.px};
}

// ---- the coarse levels l*..L-1, one CTA ----------------------------------
//
// CTA 0 holds the levels from l* down in its shared memory: their W and D
// in `keep`, copied in once per launch (cta_load) and kept for every
// V-cycle of the launch; per level r and two zero-padded boxes x and y in
// `work`, which the coarse stage shares with the other stages' windows.
// Where even the coarsest level's W and D do not fit beside the windows
// (a 57^3 P2 level 0, whose windows and band take ~165 KB), keep is null:
// l* is the coarsest level, and each coarse stage copies its W and D into
// the work area first (choose_lstar).
// The coarse stage (cta_vcycle) restricts level l*-1's residual into l*
// and runs the V-cycle of levels l*..L-1 on block barriers, every per-site
// sum that of the cluster stages (taps_at, restrict_ld, prolong_ld,
// smooth_win's rounding), so that its result equals, bit for bit, that of
// the same levels run as cluster stages.

// host and device: floats of `keep` and of `work` for levels lstar..nlev-1
__host__ __device__ inline int cta_keep_floats(const Level* lv, int lstar, int nlev) {
  int f = 0;
  for (int l = lstar; l < nlev; ++l) f += (lv[l].K + 1) * sites(lv[l]);
  return f;
}
__host__ __device__ inline int cta_work_floats(const Level* lv, const Taps* T, int lstar, int nlev) {
  int f = 0;
  for (int l = lstar; l < nlev; ++l) f += sites(lv[l]) + 2 * box_floats(lv[l], T[l]);
  return f;
}

// Level l's arrays in CTA 0's shared memory
struct CtaLevel {
  const float* W;  // (K, n), as SharedW reads it
  const float* D;
  float* r;        // n sites
  float* x;        // padded box
  float* y;        // padded box: the residual, the smoothed iterate
};

__device__ __forceinline__ CtaLevel cta_level(const Level* lv, const Taps* T, int lstar, int l,
                                              const float* keep, float* work) {
  keep += cta_keep_floats(lv, lstar, l);
  work += cta_work_floats(lv, T, lstar, l);
  const int n = sites(lv[l]), B = box_floats(lv[l], T[l]);
  return {keep, keep + lv[l].K * n, work, work + n, work + n + B};
}

// By CTA 0, once per launch: W and D of levels lstar.. into keep (read
// after the next cluster barrier)
__device__ void cta_load(const Level* lv, int lstar, int nlev, float* keep) {
  for (int l = lstar; l < nlev; ++l) {
    const Level& L = lv[l];
    const int n = sites(L);
    copy_in(keep, L.K * n, [&](int q) { return __ldg(L.W + q); });
    copy_in(keep + L.K * n, n, [&](int q) { return __ldg(L.D + q); });
    keep += (L.K + 1) * n;
  }
}

// By CTA 0: one V-cycle of levels lstar..nlev-1 (lstar >= 1), its
// right-hand side the restriction of lv[lstar - 1].t, its result into
// lv[lstar].t. The coarsest level takes x = D r and kCoarseSweeps - 1
// sweeps x += D (r - A x). keep null: W and D copied in here, ahead of
// the work area.
__device__ __noinline__ void cta_vcycle(const Level* lv, const Taps* T, int lstar, int nlev,
                                        const float* keep, float* work) {
  if (keep == nullptr) {
    cta_load(lv, lstar, nlev, work);
    keep = work;
    work += cta_keep_floats(lv, lstar, nlev);
  }
  {
    // x and y boxes are read at their zero pads
    const int f = cta_work_floats(lv, T, lstar, nlev);
    for (int q = threadIdx.x; q < f; q += blockDim.x) work[q] = 0.f;
  }
  __syncthreads();
  {
    const Level& F = lv[lstar - 1];
    const Level& C = lv[lstar];
    const CtaLevel c = cta_level(lv, T, lstar, lstar, keep, work);
    for (int idx = threadIdx.x; idx < sites(C); idx += blockDim.x) {
      const float rc = restrict_cl(F, C, F.t, idx);
      c.r[idx] = rc;
      c.x[box_site(C, T[lstar], idx)] = c.D[idx] * rc;
    }
  }
  __syncthreads();
  for (int l = lstar; l < nlev - 1; ++l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const CtaLevel f = cta_level(lv, T, lstar, l, keep, work);
    const CtaLevel c = cta_level(lv, T, lstar, l + 1, keep, work);
    const SharedW w{f.W, sites(F)};
    for (int idx = threadIdx.x; idx < sites(F); idx += blockDim.x) {
      const int p = box_site(F, T[l], idx);
      f.y[p] = f.r[idx] - taps_at(F, T[l].woff, w, f.x + p, idx);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < sites(C); idx += blockDim.x) {
      const float rc = restrict_ld(F, C, box_ld(F, T[l], f.y), idx);
      c.r[idx] = rc;
      c.x[box_site(C, T[l + 1], idx)] = c.D[idx] * rc;
    }
    __syncthreads();
  }
  const float* res;  // the V-cycle's result at the level last finished
  {
    const Level& C = lv[nlev - 1];
    const Taps& TC = T[nlev - 1];
    const CtaLevel c = cta_level(lv, T, lstar, nlev - 1, keep, work);
    const SharedW w{c.W, sites(C)};
    float* src = c.x;
    float* dst = c.y;
    for (int s = 0; s < kCoarseSweeps - 1; ++s) {
      for (int idx = threadIdx.x; idx < sites(C); idx += blockDim.x) {
        const int p = box_site(C, TC, idx);
        dst[p] = __fadd_rn(src[p], __fmul_rn(c.D[idx], c.r[idx] - taps_at(C, TC.woff, w, src + p, idx)));
      }
      __syncthreads();
      float* tmp = src; src = dst; dst = tmp;
    }
    res = src;
  }
  for (int l = nlev - 2; l >= lstar; --l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const CtaLevel f = cta_level(lv, T, lstar, l, keep, work);
    for (int idx = threadIdx.x; idx < sites(F); idx += blockDim.x) {
      const int p = box_site(F, T[l], idx);
      f.x[p] = f.x[p] + prolong_ld(F, C, box_ld(C, T[l + 1], res), idx);
    }
    __syncthreads();
    const SharedW w{f.W, sites(F)};
    for (int idx = threadIdx.x; idx < sites(F); idx += blockDim.x) {
      const int p = box_site(F, T[l], idx);
      f.y[p] = __fadd_rn(f.x[p], __fmul_rn(f.D[idx], f.r[idx] - taps_at(F, T[l].woff, w, f.x + p, idx)));
    }
    __syncthreads();
    res = f.y;
  }
  const Level& C = lv[lstar];
  for (int idx = threadIdx.x; idx < sites(C); idx += blockDim.x)
    C.t[idx] = res[box_site(C, T[lstar], idx)];
}

// By one CTA: the coarsest level C of a block (d = 2) hierarchy, x = D r
// a 2 x 2 product per point, then kCoarseSweeps - 1 damped block-Jacobi
// sweeps x += D (r - A x), r(idx, r0, r1) its right-hand side; W, D, r and
// x in shared memory sm; the result into C.t.
template <class RHS>
__device__ void coarse_solve2(const Level& C, const Taps& T, RHS rhs, float* sm) {
  const int n = sites(C), B = box_floats(C, T);
  float* W = sm;
  float* D = W + C.K * 4 * n;
  float* r = D + 4 * n;
  float* src = r + 2 * n;  // two component boxes
  float* dst = src + 2 * B;
  copy_in(W, C.K * 4 * n, [&](int q) { return __ldg(C.W + q); });
  copy_in(D, 4 * n, [&](int q) { return __ldg(C.D + q); });
  for (int q = threadIdx.x; q < 4 * B; q += blockDim.x) src[q] = 0.f;
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    float r0, r1;
    rhs(idx, r0, r1);
    r[idx] = r0;
    r[n + idx] = r1;
    const int p = box_site(C, T, idx);
    src[p] = D[idx] * r0 + D[n + idx] * r1;              // D[0,0], D[0,1]
    src[B + p] = D[2 * n + idx] * r0 + D[3 * n + idx] * r1;  // D[1,0], D[1,1]
  }
  __syncthreads();
  for (int s = 0; s < kCoarseSweeps - 1; ++s) {
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int p = box_site(C, T, idx);
      float a0, a1;
      taps2_at(C, T.woff, SharedW{W, n}, src + p, src + B + p, idx, a0, a1);
      const float v0 = r[idx] - a0, v1 = r[n + idx] - a1;
      dst[p] = src[p] + (D[idx] * v0 + D[n + idx] * v1);
      dst[B + p] = src[B + p] + (D[2 * n + idx] * v0 + D[3 * n + idx] * v1);
    }
    __syncthreads();
    float* tmp = src; src = dst; dst = tmp;
  }
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int p = box_site(C, T, idx);
    C.t[idx] = src[p];
    C.t[n + idx] = src[B + p];
  }
}

// ---- V-cycles on the cluster ---------------------------------------------

// post-smoothing value x + D (r - A x) at site idx of scalar level F, x
// the site's place in a window of F.x, w its weights; D (r - A x) rounded
// before the add, as in the plain version
template <class WS>
__device__ __forceinline__ float smooth_win(const Level& F, const Taps& T, WS w,
                                            const float* x, int idx) {
  return __fadd_rn(x[0], __fmul_rn(__ldg(F.D + idx),
                                   ldw(F.r + idx) - taps_at(F, T.woff, w, x, idx)));
}

// Level C's r = R F.t and x = D r over the window of band b, r and x also
// written at the CTA's own sites: the input of C's residual, so that the
// restriction needs no stage of its own. Ends with a block barrier.
__device__ __forceinline__ Window stage_restricted(const Level& F, const Level& C, const Taps& T,
                                                   Band b, float* s) {
  return stage_fn(C, T, b, s, [&](int idx) {
    const float rc = restrict_cl(F, C, F.t, idx);
    const float xc = __ldg(C.D + idx) * rc;
    if (idx >= b.lo && idx < b.hi) {
      C.r[idx] = rc;
      C.x[idx] = xc;
    }
    return xc;
  });
}

// Whether a transfer into level L is computed on the window of the stage
// that reads it (the restriction into L by the stage of L's residual, the
// prolongation into L by the stage that post-smooths L) rather than as a
// stage of its own: on 2-D levels, whose window holds the band's rows and
// a few pad rows. A 3-D level's window holds whole pad planes around a
// band of one to three planes, so the transfers computed again for the
// halo outnumber the band's own; there the separate stage measured faster
// (PERF.md §6). The same in every CTA.
__device__ __forceinline__ bool transfer_on_window(const Level& L) { return L.nz == 1; }

// The window of level l's iterate for its post-smoothing, after
// vcycle_to_fine_cl: x + P lv[l + 1].t computed on the window (F.x itself
// not written), or F.x as the prolongation stage left it. Ends with a
// block barrier.
__device__ __forceinline__ Window stage_smoothed(const Level* lv, const Taps* T, int l, Band b,
                                                 float* s) {
  const Level& F = lv[l];
  const Level& C = lv[l + 1];
  if (!transfer_on_window(F)) return stage_in(F.x, F, T[l], b, 1, s);
  return stage_fn(F, T[l], b, s, [&](int idx) { return ldw(F.x + idx) + prolong_cl(F, C, C.t, idx); });
}

// One scalar V-cycle on lv[0].r, with lv[0].x = D0 r set behind a cluster
// barrier, up to the prolongation into level 0: afterwards smooth_win of
// lv[0] on the window stage_smoothed(lv, T, 0, ...) is the V-cycle's
// result. Levels 0..lstar-1 run as cluster stages, levels lstar..nlev-1
// in CTA 0's shared memory (cta_vcycle; their W and D in keep, cta_load);
// 1 <= lstar < nlev. Where transfer_on_window holds (2-D), a restriction
// is computed on the window of the stage that takes the coarse level's
// residual and a prolongation on the window of the stage that
// post-smooths: 2 lstar stages; in 3-D each transfer is a stage of its
// own: 4 lstar - 1. T[l] is level l's window taps; sm the CTA's window /
// coarse work area. Ends with a cluster barrier.
__device__ void vcycle_to_fine_cl(const Level* lv, const Taps* T, int nlev, int lstar,
                                  const float* keep, float* sm, cg::cluster_group& cluster) {
  {
    const Level& L0 = lv[0];
    const Band b = band(L0);
    const Window x = stage_in(L0.x, L0, T[0], b, 1, sm);
    const GlobalW w{L0.W, sites(L0)};
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x)
      L0.t[idx] = ldw(L0.r + idx) - taps_at(L0, T[0].woff, w, x.s + x.site(L0, idx), idx);
  }
  cluster.sync();
  for (int l = 1; l < lstar; ++l) {
    // r = R t of level l - 1 and x = D r; t = r - A x
    const Level& F = lv[l - 1];
    const Level& C = lv[l];
    const Band b = band(C);
    if (!transfer_on_window(C)) {
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
        const float rc = restrict_cl(F, C, F.t, idx);
        C.r[idx] = rc;
        C.x[idx] = __ldg(C.D + idx) * rc;
      }
      cluster.sync();
    }
    const Window x = transfer_on_window(C) ? stage_restricted(F, C, T[l], b, sm)
                                           : stage_in(C.x, C, T[l], b, 1, sm);
    const GlobalW w{C.W, sites(C)};
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x)
      C.t[idx] = ldw(C.r + idx) - taps_at(C, T[l].woff, w, x.s + x.site(C, idx), idx);
    cluster.sync();
  }
  if (blockIdx.x == 0) cta_vcycle(lv, T, lstar, nlev, keep, sm);
  cluster.sync();
  for (int l = lstar - 1; l >= 0; --l) {
    const Level& F = lv[l];
    const Band b = band(F);
    if (!transfer_on_window(F)) {
      const Level& C = lv[l + 1];
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x)
        F.x[idx] = ldw(F.x + idx) + prolong_cl(F, C, C.t, idx);
      cluster.sync();
    }
    if (l == 0) break;  // the caller's stage post-smooths level 0
    const Window x = stage_smoothed(lv, T, l, b, sm);
    const GlobalW w{F.W, sites(F)};
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x)
      F.t[idx] = smooth_win(F, T[l], w, x.s + x.site(F, idx), idx);
    cluster.sync();
  }
}

// The chain of `cycles` V-cycles z = V(v); z += V(v - A0 z), ..., a
// linear operator in v (the Pallas kernels' Richardson preconditioner),
// up to the last cycle's final stage: afterwards chain_result_win of lv[0]
// on the window stage_smoothed(lv, T, 0, ...) is the chain's result at
// idx. On entry lv[0].r = v and lv[0].x = D0 v, set and behind a cluster
// barrier; z is the chain's accumulator. lstar, keep and sm as
// vcycle_to_fine_cl takes them.
__device__ void chain_to_last_cl(const Level* lv, const Taps* T, int nlev, int lstar,
                                 const float* v, float* z, int cycles, const float* keep,
                                 float* sm, cg::cluster_group& cluster) {
  const Level& L0 = lv[0];
  const int n0 = sites(L0);
  const Band b = band(L0);
  for (int c = 0; c < cycles - 1; ++c) {
    vcycle_to_fine_cl(lv, T, nlev, lstar, keep, sm, cluster);
    {
      const Window x = stage_smoothed(lv, T, 0, b, sm);
      const GlobalW w{L0.W, n0};
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
        const float s = smooth_win(L0, T[0], w, x.s + x.site(L0, idx), idx);
        z[idx] = c == 0 ? s : ldw(z + idx) + s;
      }
    }
    cluster.sync();
    {
      const Window zw = stage_in(z, L0, T[0], b, 1, sm);
      const GlobalW w{L0.W, n0};
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
        const float res = ldw(v + idx) - taps_at(L0, T[0].woff, w, zw.s + zw.site(L0, idx), idx);
        L0.r[idx] = res;
        L0.x[idx] = __ldg(L0.D + idx) * res;
      }
    }
    cluster.sync();
  }
  vcycle_to_fine_cl(lv, T, nlev, lstar, keep, sm, cluster);
}

template <class WS>
__device__ __forceinline__ float chain_result_win(const Level& L0, const Taps& T0, WS w,
                                                  const float* x, const float* z, int idx,
                                                  int cycles) {
  const float s = smooth_win(L0, T0, w, x, idx);
  return cycles > 1 ? ldw(z + idx) + s : s;
}

// post-smoothing value x + D (r - A x) at point idx of 2-D block level F,
// x0 and x1 the site's places in the two component windows of F.x, w its
// weights
template <class WS>
__device__ __forceinline__ void smooth2_win(const Level& F, const Taps& T, WS w,
                                            const float* x0, const float* x1, int idx,
                                            float& v0, float& v1) {
  const int n = F.ny * F.nx;
  float a0, a1, s0, s1;
  taps2_at(F, T.woff, w, x0, x1, idx, a0, a1);
  diag2(F, idx, ldw(F.r + idx) - a0, ldw(F.r + n + idx) - a1, s0, s1);
  v0 = x0[0] + s0;
  v1 = x1[0] + s1;
}

// One block (d = 2) V-cycle on lv[0].r, with lv[0].x = D0 r set behind a
// cluster barrier, up to and including the prolongation into level 0:
// afterwards smooth2_win of lv[0] on a window of lv[0].x is the V-cycle's
// result; a one-level hierarchy leaves the coarsest sweeps' result in
// lv[0].t. Ends with a cluster barrier.
__device__ void vcycle2_to_fine_cl(const Level* lv, const Taps* T, int nlev, float* sm,
                                   cg::cluster_group& cluster) {
  for (int l = 0; l < nlev - 1; ++l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = F.ny * F.nx;
    {
      const Band b = band(F);
      const Window x = stage_in(F.x, F, T[l], b, 2, sm);
      const GlobalW w{F.W, nf};
      for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
        const int p = x.site(F, idx);
        float a0, a1;
        taps2_at(F, T[l].woff, w, x.s + p, x.s + x.plane + p, idx, a0, a1);
        F.t[idx] = ldw(F.r + idx) - a0;
        F.t[nf + idx] = ldw(F.r + nf + idx) - a1;
      }
    }
    cluster.sync();
    if (l + 1 == nlev - 1) break;  // the coarse stage restricts into C itself
    const Band b = band(C);
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x)
      set_rhs2(C, idx, restrict_cl(F, C, F.t, idx), restrict_cl(F, C, F.t + nf, idx));
    cluster.sync();
  }
  {
    const Level& C = lv[nlev - 1];
    if (blockIdx.x == 0) {
      if (nlev > 1) {
        const Level& F = lv[nlev - 2];
        const int nf = F.ny * F.nx;
        coarse_solve2(C, T[nlev - 1], [&](int idx, float& r0, float& r1) {
          r0 = restrict_cl(F, C, F.t, idx);
          r1 = restrict_cl(F, C, F.t + nf, idx);
        }, sm);
      } else {
        const int n = C.ny * C.nx;
        coarse_solve2(C, T[0], [&](int idx, float& r0, float& r1) {
          r0 = ldw(C.r + idx);
          r1 = ldw(C.r + n + idx);
        }, sm);
      }
    }
    cluster.sync();
  }
  for (int l = nlev - 2; l >= 0; --l) {
    const Level& F = lv[l];
    const Level& C = lv[l + 1];
    const int nf = F.ny * F.nx, nc = C.ny * C.nx;
    const Band b = band(F);
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
      F.x[idx] = ldw(F.x + idx) + prolong_cl(F, C, C.t, idx);
      F.x[nf + idx] = ldw(F.x + nf + idx) + prolong_cl(F, C, C.t + nc, idx);
    }
    cluster.sync();
    if (l == 0) break;  // the caller's stage post-smooths level 0
    const Window x = stage_in(F.x, F, T[l], b, 2, sm);
    const GlobalW w{F.W, nf};
    for (int idx = b.lo + threadIdx.x; idx < b.hi; idx += blockDim.x) {
      const int p = x.site(F, idx);
      float v0, v1;
      smooth2_win(F, T[l], w, x.s + p, x.s + x.plane + p, idx, v0, v1);
      F.t[idx] = v0;
      F.t[nf + idx] = v1;
    }
    cluster.sync();
  }
}

// ---- host side -----------------------------------------------------------

// Floats of shared memory the largest window of levels lv[0..nwin) (ncomp
// component planes, taps T) takes over a cluster of P CTAs.
inline int window_floats(const Level* lv, const Taps* T, int nwin, int ncomp, int P) {
  int most = 0;
  for (int l = 0; l < nwin; ++l)
    for (int c = 0; c < P; ++c) {
      const int f = ncomp * window_of(lv[l], T[l], band_of(lv[l], c, P), nullptr).plane;
      most = f > most ? f : most;
    }
  return most;
}

// The dynamic shared memory a CTA of `kernel` may take on the current
// device: the opt-in limit less the kernel's static shared memory.
template <class Kernel>
int dyn_smem_max(Kernel kernel, int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  *bytes = optin - (int)fa.sharedSizeBytes;
  return (int)e;
}

// The finest level CTA 0 solves by default: in 2-D the coarsest level
// alone, in 3-D any that fit. A 2-D level run as cluster stages costs two
// (its transfers computed on windows, transfer_on_window), less than CTA
// 0 spends on it; a 3-D level costs four, more (PERF.md §6).
inline int cta_first_level(const Level* lv, int nlev) { return lv[0].nz == 1 ? nlev - 1 : 1; }

// l*, the finest level from which CTA 0 solves the hierarchy in shared
// memory: the least lstar >= *lstar (on entry the finest level allowed,
// at least 1) whose smem_of(lstar, false, P) bytes, with the levels' W and
// D kept for the launch, fit the device at the cluster of kMaxCluster / 2
// (the larger windows). If none does, the coarsest level with its W and
// D copied in at every coarse stage (*reload = 1, smem_of(l, true, P)).
template <class Kernel, class SmemOf>
int choose_lstar(Kernel kernel, int nlev, SmemOf smem_of, int* lstar, int* reload) {
  int dyn_max = 0;
  const int e = dyn_smem_max(kernel, &dyn_max);
  if (e != 0) return e;
  int l = *lstar < 1 ? 1 : *lstar;
  while (l < nlev - 1 && smem_of(l, false, kMaxCluster / 2) > dyn_max) ++l;
  *reload = smem_of(l, false, kMaxCluster / 2) > dyn_max ? 1 : 0;
  *lstar = l;
  return 0;
}

// Floats of CTA 0's coarse area: kept for the launch (W and D, none on
// reload) and shared with the windows (the work area, and W and D on
// reload)
__host__ __device__ inline int cta_kept_floats(const Level* lv, int lstar, int nlev, bool reload) {
  return reload ? 0 : cta_keep_floats(lv, lstar, nlev);
}
__host__ __device__ inline int cta_shared_floats(const Level* lv, const Taps* T, int lstar, int nlev,
                                                 bool reload) {
  return cta_work_floats(lv, T, lstar, nlev) + (reload ? cta_keep_floats(lv, lstar, nlev) : 0);
}

// The cluster size of `kernel` for a CTA taking smem_of(P) bytes of
// dynamic shared memory: kMaxCluster CTAs if such a cluster can be
// resident on the device, else half as many; an error if neither can.
template <class Kernel, class SmemOf>
int cluster_config(Kernel kernel, SmemOf smem_of, int* cluster, int* smem) {
  int dyn_max = 0;
  cudaError_t e = (cudaError_t)dyn_smem_max(kernel, &dyn_max);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_max);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  for (int P = kMaxCluster; P >= kMaxCluster / 2; P /= 2) {
    const int bytes = smem_of(P);
    if (bytes > dyn_max) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active >= 1) {
      *cluster = P;
      *smem = bytes;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// Launch `kernel` as one cluster of P CTAs (the whole grid) on stream.
template <class... Params, class... Args>
int cluster_launch(void (*kernel)(Params...), int P, int smem, void* stream, Args... args) {
  if (P < 1 || P > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
